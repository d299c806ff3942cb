"""Process-level runtime counters (counterpart of
auron_tpu/runtime/counters.py): the one place task and query lifecycle
totals live.  The executor, the session, the shuffle writer and the
trace recorder bump named counters here; `snapshot()` reads them all.

The JAX package's snapshot also folds in its retry policy's, jit
sites', wire frames' and statistics store's counts; the port has none of
those yet (ROADMAP Queue 1 item 18), so its snapshot is this module's
counters alone.  The JAX package's lock-order checker is item 18 too:
the lock here is a plain `threading.Lock`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

__all__ = ["bump", "get", "snapshot", "reset", "observe", "histograms"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {
    "tasks_started": 0,
    "tasks_completed": 0,
    "tasks_failed": 0,
    "queries_started": 0,
    "queries_completed": 0,
    "queries_failed": 0,
    # exchange bytes through the shuffle writer and reader; the port's
    # blocks are tensors, so these are tensor bytes (ops/shuffle/writer.py)
    "shuffle_bytes_pushed": 0,
    "shuffle_bytes_fetched": 0,
    # spans dropped past auron.trace.max.events (runtime/tracing.py)
    "trace_dropped_events": 0,
}

# fixed-bucket seconds histograms in the Prometheus exposition shape
# (cumulative `_bucket{le=}` counts, `_sum`, `_count`)
_HIST_BUCKETS: Tuple[float, ...] = (
    0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0)
_HIST_NAMES = ("query_wall_seconds",)
_HISTS: Dict[str, Dict[str, object]] = {
    name: {"counts": [0] * (len(_HIST_BUCKETS) + 1),
           "sum": 0.0, "count": 0}
    for name in _HIST_NAMES
}


def observe(name: str, value: float) -> None:
    """Record one observation into the named seconds histogram (created
    on first use for a name not seeded here)."""
    v = float(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            h = _HISTS[name] = {
                "counts": [0] * (len(_HIST_BUCKETS) + 1),
                "sum": 0.0, "count": 0}
        idx = len(_HIST_BUCKETS)
        for i, le in enumerate(_HIST_BUCKETS):
            if v <= le:
                idx = i
                break
        h["counts"][idx] += 1          # type: ignore[index]
        h["sum"] += v                  # type: ignore[operator]
        h["count"] += 1                # type: ignore[operator]


def histograms() -> Dict[str, Dict[str, object]]:
    """{name: {"buckets": [(le, cumulative count)], "sum", "count"}}."""
    with _LOCK:
        out: Dict[str, Dict[str, object]] = {}
        for name, h in _HISTS.items():
            cum = 0
            buckets: List[Tuple[float, int]] = []
            for le, c in zip(_HIST_BUCKETS, h["counts"]):  # type: ignore
                cum += c
                buckets.append((le, cum))
            out[name] = {"buckets": buckets,
                         "sum": float(h["sum"]),      # type: ignore[arg-type]
                         "count": int(h["count"])}    # type: ignore[arg-type]
        return out


def bump(key: str, delta: int = 1) -> int:
    with _LOCK:
        _COUNTERS[key] = _COUNTERS.get(key, 0) + int(delta)
        return _COUNTERS[key]


def get(key: str) -> int:
    with _LOCK:
        return _COUNTERS.get(key, 0)


def snapshot() -> Dict[str, int]:
    """Every counter, flat."""
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Test hook: zero the counters and histograms."""
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        for h in _HISTS.values():
            h["counts"] = [0] * (len(_HIST_BUCKETS) + 1)
            h["sum"] = 0.0
            h["count"] = 0
