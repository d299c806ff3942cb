"""Typed configuration registry (counterpart of auron_tpu/config.py).

Only the options the port reads, under the JAX package's names and
defaults, so one conf map configures both engines.  Lookup
order: a `scoped` override, then the `AURON_TPU_*` environment variable,
then the default.  Options of the port's own go under `auron.torch.*`.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional


def _env_key(key: str) -> str:
    return "AURON_TPU_" + key.upper().replace(".", "_")


@dataclass(frozen=True)
class ConfigOption:
    key: str
    default: Any
    type: type
    doc: str = ""

    def parse(self, raw: Any) -> Any:
        if isinstance(raw, str) and self.type is bool:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return self.type(raw)


class Configuration:
    def __init__(self) -> None:
        self._options: Dict[str, ConfigOption] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, key: str, default: Any, doc: str = "") -> ConfigOption:
        opt = ConfigOption(key, default, type(default), doc)
        with self._lock:
            if key in self._options:
                raise ValueError(f"duplicate config option {key!r}")
            self._options[key] = opt
        return opt

    def get(self, key: str) -> Any:
        opt = self._options[key]
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
        raw = os.environ.get(_env_key(key))
        return opt.parse(raw) if raw is not None else opt.default

    def set(self, key: str, value: Any) -> None:
        opt = self._options[key]
        with self._lock:
            self._overrides[key] = opt.parse(value)

    def scoped(self, kv: Optional[Dict[str, Any]] = None) -> "_Scoped":
        """Temporarily override options: `with conf.scoped({...}):`."""
        return _Scoped(self, dict(kv or {}))


class _Scoped:
    def __init__(self, conf: Configuration, kv: Dict[str, Any]) -> None:
        self._conf, self._kv = conf, kv
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> Configuration:
        for k, v in self._kv.items():
            with self._conf._lock:
                self._saved[k] = self._conf._overrides.get(k, _MISSING)
            self._conf.set(k, v)
        return self._conf

    def __exit__(self, *exc) -> bool:
        for k, old in self._saved.items():
            with self._conf._lock:
                if old is _MISSING:
                    self._conf._overrides.pop(k, None)
                else:
                    self._conf._overrides[k] = old
        return False


_MISSING = object()

conf = Configuration()

conf.define(
    "auron.batch.size", 8192,
    "Target rows per columnar batch; the front end cuts its scan batches "
    "to this size.")
conf.define(
    "auron.batch.capacity.min", 1024,
    "Smallest padded batch capacity bucket (capacities are powers of two).")
conf.define(
    "auron.partial.agg.skipping.enable", True,
    "Skip partial aggregation when cardinality reduction is poor.")
conf.define(
    "auron.partial.agg.skipping.ratio", 0.999,
    "Unique-groups/rows ratio above which partial agg passes rows through.")
conf.define(
    "auron.partial.agg.skipping.min.rows", 20480,
    "Do not consider partial-agg skipping before this many input rows.")
conf.define(
    "auron.string.width.buckets", "8,16,32,64,128,256",
    "Fixed string byte-widths used for device string columns: a batch's "
    "string column is as wide as the smallest bucket that holds its "
    "longest value.")
conf.define(
    "auron.string.device.max.width", 256,
    "Strings longer than this have no device layout; the JAX package "
    "keeps them on the host as a HostColumn, which the port has not yet.")
conf.define(
    "auron.kernel.sort.strategy", "auto",
    "Argsort family of the encoded-sort-key sorts: 'radix' = the "
    "pack-sort of ops/radix_sort.py (row index packed into the low bits "
    "of word-packed keys, composed value sorts), 'argsort' = stable "
    "argsorts, 'auto' = radix on the CPU above "
    "auron.kernel.sort.radix.min.rows, argsort on the card.  Either way "
    "the permutation is the same stable order.")
conf.define(
    "auron.kernel.sort.radix.min.rows", 1 << 15,
    "Capacity below which 'auto' keeps the argsort form.")
conf.define(
    "auron.smj.streaming.enable", True,
    "Execute sort-merge joins as a merge of the sorted inputs, window by "
    "frontier window (ops/joins/smj.py), instead of materializing the "
    "build side whole.")
conf.define(
    "auron.smj.window.max.rows", 1 << 20,
    "Cap on the build rows one streaming-SMJ window may materialize.  A "
    "window past it that holds a single key escapes, in the JAX package, "
    "to a giant-group join that spills to storage; the port has no spill "
    "yet and raises there.  Windows of several keys keep the normal "
    "path.  0 disables the cap.")
conf.define(
    "auron.kernel.join.probe.strategy", "auto",
    "Hash-join probe: 'searchsorted' = the double searchsorted over the "
    "build side's sorted key hashes; 'partitioned' = the JAX package's "
    "bucket-partitioned probe index, not in the port yet (raises); "
    "'auto' = searchsorted on every device of the port.")
conf.define(
    "auron.spmd.singleDevice.enable", True,
    "Offer every converted query first to the stage executor "
    "(parallel/stage.py), which evaluates each operator once over whole "
    "device tables; a plan it rejects runs the serial per-partition "
    "path of frontend/session.py.")
conf.define(
    "auron.spmd.source.cache.mb", 4096,
    "Device-byte budget (MB) of the stage executor's source cache: a "
    "source table stays on the device across executes, keyed by (table "
    "identity, device, string layout), so a repeat execute uploads "
    "nothing.  0 disables; least recently used entries go first past "
    "the budget.")
conf.define(
    "auron.enable", True,
    "Master switch: when false the session leaves foreign plans "
    "untouched and runs them on its foreign engine (reference: "
    "spark.auron.enable).")

# per-operator enable switches of the converter (reference:
# SparkAuronConfiguration:312-496)
for _op in (
    "project", "filter", "sort", "agg", "limit", "union", "expand", "window",
    "generate", "parquet.scan", "orc.scan", "parquet.sink", "orc.sink",
    "shuffle", "smj", "shj", "bhj", "ffi.reader", "coalesce.batches",
    "rename.columns", "empty.partitions", "debug", "kafka.scan",
):
    conf.define(f"auron.enable.{_op}", True, f"Enable native {_op} operator.")

conf.define(
    "auron.force.shuffled.hash.join", False,
    "Convert a sort-merge join into a shuffled hash join when both are "
    "legal (reference: ForceApplyShuffledHashJoinInjector).")
conf.define(
    "auron.adaptive.fuse.adjacency.enable", False,
    "Keep a scan's pushed filter also as a Filter above it when the "
    "adaptive cost model says so.  The cost model is not in the port "
    "yet: the converter raises when this is on and a scan has a pushed "
    "filter.")
conf.define(
    "auron.decimal.arith.enable", True,
    "Convert +, -, *, / over decimals, MakeDecimal and CheckOverflow.")
conf.define(
    "auron.caseconvert.functions.enable", True,
    "Convert lower() and upper().")
conf.define(
    "auron.datetime.extract.enable", True,
    "Convert hour(), minute() and second().")
