"""Operator metrics tree (counterpart of auron_tpu/runtime/metrics.py).

A `MetricNode` mirrors the operator tree: each operator owns one, named
after it, with its children's nodes as its children, and the task
returns its root's.  Values are host integers; `add_deferred` takes a
0-dim device tensor instead, kept as it is until the node is first
read, when every pending tensor of the node comes back in one
`torch.stack(...).tolist()` (`_settle`, the port's counterpart of the
JAX package's `kernel_cache.host_sync`).  No metric forces a device
round trip on the hot path.

`timer` and the operators' `elapsed_compute_ns` read the host clock
(`time.perf_counter_ns`), as in the JAX package: on a GPU they measure
the host's dispatch of the work, plus any synchronization that happens
inside them, not the device's time.

Besides the JAX node's methods, the node reads as a read-only mapping of
its settled values (`node[key]`, `key in node`, `node.get(key, default)`,
iteration over the keys), so code that read an operator's flat counter
dict reads the node the same way.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

# the default metric vocabulary (NativeHelper.scala:170-202), as the JAX
# package names it
STANDARD_METRICS = (
    "output_rows", "output_batches", "elapsed_compute_ns",
    "mem_spill_count", "mem_spill_size", "mem_spill_iotime_ns",
    "disk_spill_size", "disk_spill_iotime_ns",
    "shuffle_write_rows", "shuffle_write_time_ns",
    "shuffle_read_rows", "shuffle_read_time_ns",
    "build_hash_map_time_ns", "probe_time_ns",
    "fallback_sort_merge_join_count",
    "input_rows", "input_batches",
    "parquet_row_groups_pruned", "parquet_row_groups_read",
    "num_retries", "num_fallbacks",
    "ops_fused", "fused_batches", "fragment_trace_ns",
    "kernel_cache_hits", "kernel_cache_misses",
    "ffi_ingest_cache_hits",
    "mem_peak",
)


@dataclass
class MetricNode:
    name: str
    values: Dict[str, int] = field(default_factory=dict)
    children: List["MetricNode"] = field(default_factory=list)
    deferred: Dict[str, list] = field(default_factory=dict)

    def add(self, key: str, delta: int) -> None:
        self.values[key] = self.values.get(key, 0) + int(delta)

    def add_deferred(self, key: str, device_scalar) -> None:
        """Accumulate a 0-dim device tensor without a sync; folded into
        `values` at the node's first read."""
        self.deferred.setdefault(key, []).append(device_scalar)

    def _settle(self) -> None:
        if not self.deferred:
            return
        import torch
        keys, scalars = [], []
        for key, deltas in self.deferred.items():
            for d in deltas:
                keys.append(key)
                scalars.append(d)
        self.deferred = {}
        tensors = [s for s in scalars if isinstance(s, torch.Tensor)]
        read = iter(torch.stack([t.reshape(()).to(torch.int64)
                                 for t in tensors]).tolist()
                    if tensors else ())
        for key, s in zip(keys, scalars):
            self.add(key, next(read) if isinstance(s, torch.Tensor)
                     else int(s))

    def set(self, key: str, value: int) -> None:
        self.values[key] = int(value)

    def get(self, key: str, default: int = 0) -> int:
        self._settle()
        return self.values.get(key, default)

    @contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(key, time.perf_counter_ns() - t0)

    def child(self, name: str) -> "MetricNode":
        node = MetricNode(name)
        self.children.append(node)
        return node

    def to_dict(self) -> dict:
        self._settle()
        return {"name": self.name, "values": dict(self.values),
                "children": [c.to_dict() for c in self.children]}

    def render(self, indent: int = 0) -> str:
        self._settle()
        pad = "  " * indent
        vals = ", ".join(f"{k}={v}" for k, v in sorted(self.values.items()))
        lines = [f"{pad}{self.name}: {vals}"]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)

    # -- the read-only mapping view of the settled values -----------------

    def __getitem__(self, key: str) -> int:
        self._settle()
        return self.values[key]

    def __contains__(self, key: object) -> bool:
        self._settle()
        return key in self.values

    def __iter__(self) -> Iterator[str]:
        self._settle()
        return iter(list(self.values))

    def keys(self):
        self._settle()
        return self.values.keys()

    def items(self):
        self._settle()
        return self.values.items()
