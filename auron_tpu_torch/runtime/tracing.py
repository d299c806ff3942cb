"""Query tracing: a bounded span recorder and Chrome-trace export
(counterpart of auron_tpu/runtime/tracing.py).

Named spans mark where a query's wall time goes between "the session saw
a plan" and "the last batch came back": plan conversion, the stage
executor's launch, ingest, run and gather, each (stage, partition)
task, shuffle push, commit and fetch, spill write and read; instant
events mark an operator's stream end (`op.complete`), a spill
(`mem.spill`), a watermark crossing (`mem.pressure`) and a kernel build
(`kernel.build`).  A recorder exports them as Chrome-trace JSON (load
in chrome://tracing or ui.perfetto.dev).

- Off is the default and costs one contextvar read per span site:
  `span(...)` returns a shared no-op context manager when no recorder is
  armed.
- On allocates one small `Span` per site, stamped with `perf_counter_ns`
  against the recorder's epoch, and the recorder is bounded
  (`auron.trace.max.events`; past it `dropped` counts instead).
- Spans read the host clock, as in the JAX package.  On a GPU a span
  measures the host's dispatch of the work inside it, plus any
  synchronization that happens there; it does not measure device time,
  and nothing here synchronizes the device to take a reading.
- Propagation is by contextvars, seeded with a query id that
  `AuronSession.execute` mints: spans, `task_logging` prefixes and the
  query record share the one key.

The module also keeps the process-wide query history ring
(`auron.metrics.history.max`): every `AuronSession.execute` appends a
`QueryRecord`.  The JAX package's cross-process trace stitching, harvest
and lifecycle timelines serve its fleet and serving tier, which the port
does not have yet (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from auron_tpu_torch.config import conf

log = logging.getLogger("auron_tpu_torch.tracing")

__all__ = [
    "Span", "TraceRecorder", "QueryRecord", "QueryStats", "span", "event",
    "current_recorder", "current_query_id", "stats_bump",
    "start_query", "trace_scope", "new_query_id",
    "validate_chrome_trace", "summarize_chrome_trace", "query_history",
    "find_query", "record_query", "history_metric_totals",
    "clear_history",
]


# ---------------------------------------------------------------------------
# span recording
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One closed span; ts/dur in ns relative to the recorder epoch (an
    instant event has dur -1)."""
    name: str
    cat: str
    t0_ns: int
    dur_ns: int
    tid: int
    thread: str
    args: Optional[Dict[str, Any]] = None


class TraceRecorder:
    """Thread-safe bounded span and event sink for one query."""

    def __init__(self, query_id: str, max_events: Optional[int] = None):
        self.query_id = query_id
        self.epoch_ns = time.perf_counter_ns()
        self.wall_start = time.time()
        self.max_events = int(conf.get("auron.trace.max.events")) \
            if max_events is None else int(max_events)
        self.spans: List[Span] = []
        self.dropped = 0
        # spans removed by drain()/drain_since() so far: the absolute
        # sequence number of self.spans[0]
        self._base_seq = 0
        self._drop_warned = False
        self._lock = threading.Lock()

    def add(self, name: str, cat: str, t0_ns: int, dur_ns: int,
            args: Optional[Dict[str, Any]]) -> None:
        t = threading.current_thread()
        s = Span(name=name, cat=cat, t0_ns=t0_ns - self.epoch_ns,
                 dur_ns=dur_ns, tid=t.ident or 0, thread=t.name,
                 args=args or None)
        first_drop = False
        with self._lock:
            if len(self.spans) >= self.max_events:
                self.dropped += 1
                first_drop = not self._drop_warned
                self._drop_warned = True
            else:
                self.spans.append(s)
                return
        # past the cap: the loss shows on the process counter and, by
        # `dropped`, on the exported trace's `trace_truncated` flag
        from auron_tpu_torch.runtime import counters
        counters.bump("trace_dropped_events")
        if first_drop:
            log.warning(
                "trace for query %s reached auron.trace.max.events=%d; "
                "further spans are dropped (the exported trace carries "
                "trace_truncated plus the drop count)",
                self.query_id, self.max_events)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    # -- incremental export -------------------------------------------------

    def drain(self) -> Tuple[List[Span], int]:
        """Return and clear the spans recorded so far, with the next
        absolute sequence cursor."""
        with self._lock:
            spans = self.spans
            self.spans = []
            self._base_seq += len(spans)
            return spans, self._base_seq

    def drain_since(self, since: int) -> Tuple[List[Span], int, int]:
        """Cursor-acknowledged drain: spans below `since` were received
        by the caller and are freed; everything still buffered is
        returned without clearing.  Returns (spans, first_seq,
        next_since)."""
        with self._lock:
            drop = max(0, min(int(since) - self._base_seq,
                              len(self.spans)))
            if drop:
                del self.spans[:drop]
                self._base_seq += drop
            return (list(self.spans), self._base_seq,
                    self._base_seq + len(self.spans))

    # -- export -------------------------------------------------------------

    def _span_events(self, spans: List[Span],
                     pid: int) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"auron-tpu query {self.query_id}"}},
        ]
        threads_named = set()
        for s in spans:
            if s.tid not in threads_named:
                threads_named.add(s.tid)
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": s.tid,
                               "args": {"name": s.thread}})
            ev: Dict[str, Any] = {
                "name": s.name, "cat": s.cat,
                "ph": "X" if s.dur_ns >= 0 else "i",
                "ts": s.t0_ns / 1000.0, "pid": pid, "tid": s.tid,
            }
            if s.dur_ns >= 0:
                ev["dur"] = s.dur_ns / 1000.0
            else:
                ev["s"] = "t"   # instant scope: thread
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        return events

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (the `traceEvents` array form): spans
        as complete ("X") events, instants as "i", thread names as "M"
        metadata."""
        return {"traceEvents": self._span_events(self.snapshot(),
                                                 os.getpid()),
                "displayTimeUnit": "ms",
                "otherData": {"query_id": self.query_id,
                              "dropped_events": self.dropped,
                              "trace_truncated": self.dropped > 0,
                              "wall_start": self.wall_start}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


class _NoopSpan:
    """The shared do-nothing context manager of the off path."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_args(self, **args: Any) -> None:
        """No-op twin of _SpanCtx.set_args."""


_NOOP = _NoopSpan()


class _SpanCtx:
    __slots__ = ("_rec", "_name", "_cat", "_args", "_t0")

    def __init__(self, rec: TraceRecorder, name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter_ns()
        return self

    def set_args(self, **args: Any) -> None:
        """Attach args known only once the work inside the span ran
        (byte totals, row counts): merged into the event's `args` when
        the span closes."""
        merged = dict(self._args or {})
        merged.update(args)
        self._args = merged

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter_ns() - self._t0
        if exc is not None:
            args = dict(self._args or {})
            args["error"] = f"{type(exc).__name__}: {exc}"
            self._args = args
        self._rec.add(self._name, self._cat, self._t0, dur, self._args)
        return False


class QueryStats:
    """Per-query attribution counters, armed by `trace_scope` beside the
    query id: the memory sites bump the ambient query's, so a query's
    record counts its own spills."""

    __slots__ = ("_lock", "_counts")
    KEYS = ("attempts", "retries", "fallbacks", "mem_spills",
            "mem_spill_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.KEYS, 0)

    def bump(self, key: str, delta: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + int(delta)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


_recorder: contextvars.ContextVar[Optional[TraceRecorder]] = \
    contextvars.ContextVar("auron_torch_trace_recorder", default=None)
_query_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("auron_torch_query_id", default=None)
_stats: contextvars.ContextVar[Optional[QueryStats]] = \
    contextvars.ContextVar("auron_torch_query_stats", default=None)

def stats_bump(key: str, delta: int = 1) -> None:
    """Attribute a memory or recovery event to the ambient query (a
    no-op outside a query scope: one contextvar read)."""
    sink = _stats.get()
    if sink is not None:
        sink.bump(key, delta)


def current_recorder() -> Optional[TraceRecorder]:
    return _recorder.get()


def current_query_id() -> Optional[str]:
    """The ambient query id: the one correlation key of span attributes,
    `task_logging` prefixes and the query record."""
    return _query_id.get()


def span(name: str, cat: str = "runtime", **args: Any):
    """Context manager timing a named span on the host clock.  With no
    recorder armed (tracing off, the default) this is one contextvar
    read and a shared no-op object; `args` land in the Chrome-trace
    event's `args`."""
    rec = _recorder.get()
    if rec is None:
        return _NOOP
    return _SpanCtx(rec, name, cat, args or None)


def event(name: str, cat: str = "runtime", **args: Any) -> None:
    """Record an instant event.  No-op when tracing is off."""
    rec = _recorder.get()
    if rec is None:
        return
    rec.add(name, cat, time.perf_counter_ns(), -1, args or None)


def new_query_id() -> str:
    return uuid.uuid4().hex[:12]


class trace_scope:
    """Arm a recorder and a query id for the length of a query.

    With `auron.trace.enable` set a TraceRecorder is made (or the one
    given is adopted) and the contextvars are set, and restored on exit.
    With tracing off the scope still mints a query id (log correlation
    works without tracing) but arms no recorder."""

    def __init__(self, query_id: Optional[str] = None,
                 recorder: Optional[TraceRecorder] = None):
        self.query_id = query_id or new_query_id()
        if recorder is not None:
            self.recorder: Optional[TraceRecorder] = recorder
        elif conf.get("auron.trace.enable"):
            self.recorder = TraceRecorder(self.query_id)
        else:
            self.recorder = None
        # always armed (cheap): the per-query sink of the memory sites
        self.stats = QueryStats()
        self._tok_rec = None
        self._tok_qid = None
        self._tok_stats = None

    def __enter__(self) -> "trace_scope":
        self._tok_qid = _query_id.set(self.query_id)
        self._tok_stats = _stats.set(self.stats)
        if self.recorder is not None:
            self._tok_rec = _recorder.set(self.recorder)
        return self

    def __exit__(self, *exc) -> bool:
        if self._tok_rec is not None:
            _recorder.reset(self._tok_rec)
        if self._tok_stats is not None:
            _stats.reset(self._tok_stats)
        if self._tok_qid is not None:
            _query_id.reset(self._tok_qid)
        return False


def start_query(query_id: Optional[str] = None) -> trace_scope:
    """Alias for call sites that read better as a verb."""
    return trace_scope(query_id)


# ---------------------------------------------------------------------------
# Chrome-trace validation and summary (the `python -m auron_tpu_torch.trace`
# CLI)
# ---------------------------------------------------------------------------

_KNOWN_PHASES = frozenset("BEXiIMCbensTfPOND(){}")


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation of a Chrome-trace JSON document; returns a
    list of error strings (empty: valid).  Checks what the Perfetto
    importer relies on: a traceEvents array of objects, string names,
    known phase codes, numeric non-negative ts/dur, int pid/tid, dict
    args."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-array 'traceEvents'"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _KNOWN_PHASES:
            errors.append(f"{where}: bad phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"{where}: missing name")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: bad dur {dur!r}")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                errors.append(f"{where}: non-int {key}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: non-object args")
        if len(errors) >= 50:
            errors.append("... (further errors suppressed)")
            break
    return errors


def _complete_events(doc: Dict) -> List[Dict]:
    return [ev for ev in doc.get("traceEvents", [])
            if isinstance(ev, dict) and ev.get("ph") == "X"]


def _span_children(spans: List[Dict]) -> Dict[int, List[int]]:
    """Containment tree over complete events: parent = smallest
    enclosing span.  Stack-based over a (start, -dur) sort; overlapping
    spans that do not nest fall back to no parent."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i]["ts"], -spans[i].get("dur", 0)))
    children: Dict[int, List[int]] = {i: [] for i in range(len(spans))}
    stack: List[int] = []
    for i in order:
        s, e = spans[i]["ts"], spans[i]["ts"] + spans[i].get("dur", 0)
        while stack:
            top = spans[stack[-1]]
            if top["ts"] + top.get("dur", 0) >= e and top["ts"] <= s:
                break
            stack.pop()
        if stack:
            children[stack[-1]].append(i)
        stack.append(i)
    return children


def summarize_chrome_trace(doc: Dict, top: int = 10) -> str:
    """Human summary: per-name aggregates (count/total/max) sorted by
    total time, and the critical path: from the longest span, the chain
    of largest enclosed spans."""
    spans = _complete_events(doc)
    if not spans:
        return "no complete spans in trace"
    agg: Dict[str, List[float]] = {}
    for ev in spans:
        a = agg.setdefault(ev["name"], [0, 0.0, 0.0])
        a[0] += 1
        a[1] += ev.get("dur", 0)
        a[2] = max(a[2], ev.get("dur", 0))
    total_span = max(spans, key=lambda e: e.get("dur", 0))
    lines = [f"{len(spans)} spans, "
             f"{len(agg)} distinct names, "
             f"longest: {total_span['name']} "
             f"{total_span.get('dur', 0) / 1000.0:.3f}ms"]
    lines.append(f"{'name':32} {'count':>6} {'total_ms':>10} {'max_ms':>10}")
    by_total = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, tot, mx) in by_total:
        lines.append(f"{name[:32]:32} {n:6d} {tot / 1000.0:10.3f} "
                     f"{mx / 1000.0:10.3f}")
    children = _span_children(spans)
    idx = spans.index(total_span)
    lines.append("critical path:")
    depth = 0
    while True:
        ev = spans[idx]
        lines.append(f"  {'  ' * depth}{ev['name']} "
                     f"{ev.get('dur', 0) / 1000.0:.3f}ms")
        kids = children.get(idx, [])
        if not kids or depth >= 20:
            break
        idx = max(kids, key=lambda i: spans[i].get("dur", 0))
        depth += 1
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# process-wide query history
# ---------------------------------------------------------------------------

@dataclass
class QueryRecord:
    """One completed query: its id, wall time, rows, path, attribution
    counts, merged metric totals and trees, and the trace when one was
    recorded.  The JAX record's plan signature, preemption count and
    adaptive-execution fields come with the port's serving tier and
    adaptive execution (ROADMAP Queue 1 items 18 and 23)."""
    query_id: str
    wall_s: float
    rows: int = 0
    spmd: bool = False
    attempts: int = 0
    retries: int = 0
    fallbacks: int = 0
    error: Optional[str] = None
    started_at: float = 0.0
    metric_totals: Dict[str, int] = field(default_factory=dict)
    # the largest single-operator memory peak, and the query's spills
    mem_peak: int = 0
    mem_spills: int = 0
    mem_spill_bytes: int = 0
    # merged per-operator metric trees ([{"tasks": n, "tree": dict}])
    metric_trees: Optional[List[Dict[str, Any]]] = None
    # [{"state": s, "t": wall}] in transition order: running, terminal
    timeline: Optional[List[Dict[str, Any]]] = None
    trace: Optional[Dict[str, Any]] = None   # chrome-trace doc, if traced

    def to_dict(self, with_trace: bool = False,
                with_trees: bool = False) -> Dict[str, Any]:
        d = {"query_id": self.query_id, "wall_s": round(self.wall_s, 4),
             "rows": self.rows, "spmd": self.spmd,
             "attempts": self.attempts, "retries": self.retries,
             "fallbacks": self.fallbacks, "error": self.error,
             "started_at": self.started_at, "traced": self.trace is not None,
             "mem_peak": self.mem_peak, "mem_spills": self.mem_spills,
             "mem_spill_bytes": self.mem_spill_bytes,
             "timeline": self.timeline,
             "metric_totals": dict(self.metric_totals)}
        if with_trees:
            d["metric_trees"] = self.metric_trees
        if with_trace:
            d["trace"] = self.trace
        return d


_HISTORY: List[QueryRecord] = []
_HISTORY_LOCK = threading.Lock()


def record_query(rec: QueryRecord) -> None:
    from auron_tpu_torch.runtime import counters
    counters.observe("query_wall_seconds", rec.wall_s)
    limit = max(1, int(conf.get("auron.metrics.history.max")))
    with _HISTORY_LOCK:
        _HISTORY.append(rec)
        if len(_HISTORY) > limit:
            del _HISTORY[:len(_HISTORY) - limit]


def query_history() -> List[QueryRecord]:
    with _HISTORY_LOCK:
        return list(_HISTORY)


def find_query(query_id: str) -> Optional[QueryRecord]:
    with _HISTORY_LOCK:
        for rec in reversed(_HISTORY):
            if rec.query_id == query_id:
                return rec
    return None


def history_metric_totals() -> Dict[str, int]:
    """Summed per-operator metric values across the recorded queries."""
    totals: Dict[str, int] = {}
    with _HISTORY_LOCK:
        for rec in _HISTORY:
            for k, v in rec.metric_totals.items():
                totals[k] = totals.get(k, 0) + int(v)
    return totals


def clear_history() -> None:
    with _HISTORY_LOCK:
        _HISTORY.clear()
