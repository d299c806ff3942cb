"""The corpus runner (counterpart of auron_tpu/it/runner.py).

`QueryRunner` builds each query's foreign plan over the generated
tables' catalog, runs it through the port's `AuronSession.execute`
twice, cold (the stage executor's source cache emptied first) and warm,
with `TableEngine` serving the scans, and compares both results with
the expected ones (`compare_tables`, row by row where the plan promises
an order).  The port has no oracle: the expected results come from the
caller, as the JAX package's oracle computed them
(`tools/torch_expected.py` writes them; `load_expected` reads the file
and checks its header).  The warm time is the median of `WARM_RUNS`
executes, and each timed execute records the seconds the Python
collector ran inside it, so a collection of a long process's heap shows
as what it is and does not pass for a query's time.

Not in the port's runner: the converted-plan lint and plan stability
goldens, the perf gate against the oracle, EXPLAIN ANALYZE and traces.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from auron_tpu_torch import resolve_device
from auron_tpu_torch.frontend import converters
from auron_tpu_torch.frontend.session import AuronSession
from auron_tpu_torch.it import compare, queries
from auron_tpu_torch.it.compare import HostTable
from auron_tpu_torch.it.datagen import (_DATAGEN_VERSION, Catalog,
                                        TableEngine, Tables)
from auron_tpu_torch.ops import kernels_cuda
from auron_tpu_torch.parallel.stage import clear_source_caches

HERE = os.path.dirname(os.path.abspath(__file__))
WARM_RUNS = 3


def expected_path(sf: float, seed: int) -> str:
    """The committed expected-results file of (sf, seed)."""
    return os.path.join(HERE, f"expected_sf{sf:g}_seed{seed}.json")


def load_expected(sf: float, seed: int, fact_chunks: int = 4,
                  path: Optional[str] = None
                  ) -> Tuple[dict, Dict[str, HostTable]]:
    """(header, {query: HostTable}) of the expected results of `generate`
    at (sf, seed, fact_chunks): the committed file unless `path` is
    given.  Raises FileNotFoundError when there is none and ValueError
    when its header names other arguments, another generator version or
    other queries; both messages name the tool that writes the file."""
    path = path or expected_path(sf, seed)
    tool = (f"python tools/torch_expected.py --sf {sf:g} --seed {seed} "
            f"--fact-chunks {fact_chunks} --out {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no expected results for sf={sf:g} seed={seed} ({path} is "
            f"missing): write them with {tool}")
    with open(path) as f:
        doc = json.load(f)
    tables = {name: HostTable(q["columns"], [tuple(r) for r in q["rows"]])
              for name, q in doc.pop("queries").items()}
    want = {"sf": sf, "seed": seed, "fact_chunks": fact_chunks,
            "datagen_version": _DATAGEN_VERSION, "names": queries.names()}
    bad = [k for k in want if doc.get(k) != want[k]]
    if list(tables) != want["names"] and "names" not in bad:
        bad.append("queries")
    if bad:
        got = {k: doc.get(k) for k in bad if k != "names"}
        raise ValueError(
            f"{path} does not hold the results of sf={sf:g} seed={seed} "
            f"fact_chunks={fact_chunks} generator version "
            f"{_DATAGEN_VERSION} over the port's {len(want['names'])} "
            f"queries: {', '.join(bad)} differ ({got}); write it again "
            f"with {tool}")
    return doc, tables


class _Collector:
    """Seconds the Python collector runs while it is installed."""

    def __init__(self):
        self.seconds = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self._t = None


@dataclass
class QueryResult:
    """One query's row of the sweep.  `native_s` is the cold execute's
    wall seconds, `native_warm_s` the median of the warm executes'
    (`warm_s`, each of them); `gc_s` the seconds the Python collector ran
    inside each timed execute, the cold one first; `convert_s` the cold
    execute's tagging and conversion; `host_syncs` and `bytes_uploaded`
    the stage executor's counts of the cold and the last warm execute
    (None on the serial path); `peak_bytes` the device's peak allocation
    over all of them (None on the CPU); `launches` each kernel's
    launches over all of them."""
    name: str
    ok: bool
    native_s: float
    rows: int
    all_native: bool
    error: Optional[str] = None
    spmd: bool = False
    native_warm_s: Optional[float] = None
    spmd_rejection: Optional[str] = None
    convert_s: Optional[float] = None
    host_syncs: Optional[Tuple[int, int]] = None
    bytes_uploaded: Optional[Tuple[int, int]] = None
    peak_bytes: Optional[int] = None
    launches: Dict[str, int] = field(default_factory=dict)
    warm_s: List[float] = field(default_factory=list)
    gc_s: List[float] = field(default_factory=list)
    trace: Optional[str] = None     # the traceback of a query that raised

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        for k in ("native_s", "native_warm_s", "convert_s"):
            if d[k] is not None:
                d[k] = round(d[k], 6)
        for k in ("host_syncs", "bytes_uploaded"):
            if d[k] is not None:
                d[k] = list(d[k])
        for k in ("warm_s", "gc_s"):
            d[k] = [round(v, 6) for v in d[k]]
        return d


@dataclass
class QueryRunner:
    catalog: Catalog
    tables: Tables
    expected: Dict[str, HostTable]
    device: object = None
    results: List[QueryResult] = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.engine = TableEngine(self.catalog, self.tables)

    def _execute(self, session: AuronSession, plan):
        """(result, wall seconds, the collector's seconds within)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        collector = _Collector()
        gc.callbacks.append(collector)
        try:
            t0 = time.perf_counter()
            res = session.execute(plan, self.device)
            if cuda:
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(collector)
        return res, wall, collector.seconds

    def run(self, name: str) -> QueryResult:
        plan = queries.build(name, self.catalog)
        expected = self.expected[name]
        ordered = compare.plan_is_ordered(plan)
        cuda = self.device.type == "cuda"
        provider = converters.ScanSourceProvider()
        converters.register_provider(provider)
        try:
            session = AuronSession(foreign_engine=self.engine)
            clear_source_caches()
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            before = dict(kernels_cuda.LAUNCHES)
            runs = [self._execute(session, plan)
                    for _ in range(1 + WARM_RUNS)]
        finally:
            converters.unregister_provider(provider)
        launches = {k: v - before[k]
                    for k, v in kernels_cuda.LAUNCHES.items()}
        (cold, cold_s, _), *warms = runs
        warm = warms[-1][0]
        error = None
        for run, (res, _, _) in zip([""] + ["warm run: "] * len(warms),
                                    runs):
            diff = compare.compare_tables(HostTable.from_result(res),
                                          expected, ordered=ordered)
            if diff is not None:
                error = run + diff
                break

        def both(key):
            if key not in cold.metrics:
                return None
            return cold.metrics[key], warm.metrics[key]
        qr = QueryResult(
            name=name, ok=error is None,
            native_s=cold_s, rows=cold.num_rows,
            all_native=cold.all_native(), error=error,
            spmd=all(res.spmd for res, _, _ in runs),
            native_warm_s=statistics.median(w for _, w, _ in warms),
            spmd_rejection=cold.spmd_rejection, convert_s=cold.convert_s,
            host_syncs=both("host_syncs"),
            bytes_uploaded=both("bytes_uploaded"),
            peak_bytes=torch.cuda.max_memory_allocated(self.device)
            if cuda else None,
            launches=launches, warm_s=[w for _, w, _ in warms],
            gc_s=[g for _, _, g in runs])
        self.results.append(qr)
        return qr

    def run_all(self, names: Optional[List[str]] = None,
                on_result=None) -> List[QueryResult]:
        for name in names or queries.names():
            try:
                r = self.run(name)
            except Exception as e:  # noqa: BLE001 - one red row, not a
                # dead sweep
                r = QueryResult(
                    name=name, ok=False, native_s=0.0, rows=0,
                    all_native=False,
                    error=f"{type(e).__name__}: {str(e)[:200]}",
                    trace=traceback.format_exc()[-2000:])
                self.results.append(r)
            if on_result is not None:
                on_result(r)
        return self.results

    def report(self) -> str:
        lines = [f"{'query':8} {'ok':4} {'cold_s':>9} {'warm_s':>9} "
                 f"{'rows':>7} path"]
        for r in self.results:
            path = "stage" if r.spmd else \
                f"serial ({r.spmd_rejection or 'stage executor off'})"
            warm = -1.0 if r.native_warm_s is None else r.native_warm_s
            lines.append(
                f"{r.name:8} {'PASS' if r.ok else 'FAIL':4} "
                f"{r.native_s:9.3f} {warm:9.3f} {r.rows:7d} {path}")
            if r.error:
                lines.append(f"         diff: {r.error}")
        n_ok = sum(1 for r in self.results if r.ok)
        lines.append(f"{n_ok}/{len(self.results)} passed")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps([r.to_dict() for r in self.results])
