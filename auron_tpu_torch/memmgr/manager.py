"""MemManager: consumer registry, wait-or-spill arbitration and
accounting (counterpart of auron_tpu/memmgr/manager.py).

When a consumer's update takes the pool past its budget, a spillable
consumer is asked to spill: the one ranked first by
`auron.memory.spill.victim.strategy` (`_pick_spill_victim`); consumers
below `auron.memory.spill.min.trigger.bytes` are never forced.  The
manager is synchronous: the reference's "Wait" arm degenerates into an
immediate spill, and only consumers registered by the calling thread
are candidates.  When the victim frees nothing, the requester spills
itself (the `fallback` path).

Accounting, as the JAX package keeps it: consumer and pool peaks,
watermark crossings (`auron.memory.watermark.fractions`, each fraction
once per manager), spill records (who spilled, who asked, the path,
the bytes freed, the wall time), a spill-size histogram, reservations
that shrink the effective budget, and per-consumer-name totals that
survive unregistration.

A consumer is charged to the query whose scope registered it (its
`_query_id`, runtime/tracing.py).  Each spill bumps the ambient query's
`mem_spills` and `mem_spill_bytes` (`tracing.stats_bump`) and records a
`mem.spill` trace event; each watermark crossing records a
`mem.pressure` event.

Not in the port yet (ROADMAP Queue 1 items 16 and 18): the per-query
ledger with its budget and kill hook, the pressure hook and the `query`
victim strategy; a non-zero `auron.memory.query.budget.bytes` or the
`query` strategy raises.

The default budget is `auron.memory.fraction` of the card's memory
(`torch.cuda.mem_get_info`'s total), or of 4 GiB where there is no
card, unless `auron.memory.budget.bytes` sets it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from auron_tpu_torch.config import conf
from auron_tpu_torch.runtime import tracing

# spill-size histogram bucket upper bounds (bytes); the last bucket is
# open-ended
SPILL_HIST_BOUNDS = (1 << 12, 1 << 16, 1 << 20, 1 << 24, 1 << 28)

_LEDGER_ITEMS = "ROADMAP Queue 1 items 16 and 18 (the per-query ledger)"


def min_trigger_size() -> int:
    """Consumers below this size are never forced to spill."""
    return int(conf.get("auron.memory.spill.min.trigger.bytes"))


def _check_unported() -> None:
    """Raise for the settings of the JAX package's per-query ledger."""
    if int(conf.get("auron.memory.query.budget.bytes")):
        raise NotImplementedError(
            f"auron.memory.query.budget.bytes needs the per-query memory "
            f"ledger, which auron_tpu_torch has not yet ({_LEDGER_ITEMS})")
    strategy = str(conf.get("auron.memory.spill.victim.strategy"))
    if strategy == "query":
        raise NotImplementedError(
            f"the 'query' spill-victim strategy needs the per-query "
            f"memory ledger, which auron_tpu_torch has not yet "
            f"({_LEDGER_ITEMS})")
    if strategy not in ("rate", "largest"):
        raise ValueError(f"unknown spill-victim strategy {strategy!r}")


def watermark_fractions() -> List[float]:
    raw = str(conf.get("auron.memory.watermark.fractions"))
    out = [float(p) for p in (x.strip() for x in raw.split(",")) if p]
    return sorted(f for f in out if f > 0.0)


class MemConsumer:
    """Operators subclass (or compose) this; `spill()` releases device
    memory and returns the bytes freed."""

    def __init__(self, name: str, spillable: bool = True):
        self.name = name
        self.spillable = spillable
        self.mem_used = 0
        self.mem_peak = 0
        self._manager: Optional["MemManager"] = None
        self._metrics = None
        self._owner_thread: Optional[int] = None
        self._query_id: Optional[str] = None

    def bind_metrics(self, metrics) -> None:
        """The operator's `MetricNode`: on unregister the manager writes
        this consumer's peak there as `mem_peak`."""
        self._metrics = metrics

    def update_mem_used(self, new_bytes: int) -> None:
        if self._manager is not None:
            self._manager.update(self, int(new_bytes))
        else:
            self.mem_used = int(new_bytes)
            self.mem_peak = max(self.mem_peak, self.mem_used)

    def spill(self) -> int:
        raise NotImplementedError


@dataclass
class SpillRecord:
    """One attributed spill: who spilled, who asked, which decision path,
    what it bought, and what it cost."""
    consumer: str          # the consumer whose spill() ran
    requested_by: str      # the consumer whose update() went over budget
    path: str              # arbitration | self | fallback
    freed_bytes: int       # the consumer's reported return value
    wall_ns: int
    total_used: int        # pool usage right after the spill
    at: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {"consumer": self.consumer,
                "requested_by": self.requested_by, "path": self.path,
                "freed_bytes": self.freed_bytes, "wall_ns": self.wall_ns,
                "total_used": self.total_used, "at": self.at}


class MemManager:
    # bounded attribution ring: enough to see a whole spill storm
    MAX_SPILL_RECORDS = 256

    def __init__(self, budget_bytes: Optional[int] = None):
        _check_unported()
        # re-entrant: a consumer's spill() re-enters update() to account
        # what it shed
        self._lock = threading.RLock()
        self._tls = threading.local()   # re-entrancy guard (see update)
        self._consumers: List[MemConsumer] = []
        self.budget = budget_bytes if budget_bytes is not None \
            else self._default_budget()
        self.total_used = 0
        self.peak_used = 0
        self.num_spills = 0
        self.reserved = 0
        self._reservations: Dict[str, int] = {}
        self._wm_fractions = watermark_fractions()
        self._wm_next = 0
        self._wm_crossings: List[Dict[str, Any]] = []
        self._spill_records: List[SpillRecord] = []
        self.spill_bytes_freed = 0
        self.spill_wall_ns = 0
        self._spills_by_path: Dict[str, int] = {}
        self._spill_hist = [0] * (len(SPILL_HIST_BOUNDS) + 1)
        # cumulative per-consumer-name stats, surviving unregistration
        self._by_name: Dict[str, Dict[str, int]] = {}

    @staticmethod
    def _default_budget() -> int:
        override = int(conf.get("auron.memory.budget.bytes"))
        if override:
            return override
        frac = float(conf.get("auron.memory.fraction"))
        import torch
        if torch.cuda.is_available():
            _free, total = torch.cuda.mem_get_info()
            return int(total * frac)
        return int(4 * (1 << 30) * frac)  # no card: a 4 GiB-class device

    # -- effective budget / reservations ----------------------------------

    @property
    def effective_budget(self) -> int:
        return self.budget - self.reserved

    def add_reservation(self, label: str, nbytes: int) -> int:
        """Carve `nbytes` out of the budget under `label` (repeat labels
        accumulate); returns the new effective budget."""
        with self._lock:
            self._reservations[label] = \
                self._reservations.get(label, 0) + int(nbytes)
            self.reserved += int(nbytes)
            return self.effective_budget

    def release_reservations(self, label: Optional[str] = None) -> None:
        with self._lock:
            if label is None:
                self._reservations.clear()
                self.reserved = 0
            else:
                self.reserved -= self._reservations.pop(label, 0)

    # -- consumer registry -------------------------------------------------

    def register_consumer(self, consumer: MemConsumer) -> MemConsumer:
        # the consumer is charged to the ambient query (one contextvar
        # read, outside the lock)
        qid = tracing.current_query_id()
        with self._lock:
            consumer._manager = self
            consumer._query_id = qid
            # spill() mutates operator internals, so only the thread
            # running the operator's task may invoke it
            consumer._owner_thread = threading.get_ident()
            self._consumers.append(consumer)
            ent = self._by_name.setdefault(
                consumer.name, {"registrations": 0, "peak": 0,
                                "spills": 0, "freed_bytes": 0,
                                "wall_ns": 0})
            ent["registrations"] += 1
        return consumer

    def unregister_consumer(self, consumer: MemConsumer) -> None:
        with self._lock:
            if consumer in self._consumers:
                self.total_used -= consumer.mem_used
                consumer.mem_used = 0
                consumer._manager = None
                self._consumers.remove(consumer)
                ent = self._by_name.get(consumer.name)
                if ent is not None and consumer.mem_peak > ent["peak"]:
                    ent["peak"] = consumer.mem_peak
        metrics = consumer._metrics
        if metrics is not None and consumer.mem_peak > \
                metrics.values.get("mem_peak", 0):
            metrics.set("mem_peak", consumer.mem_peak)

    # -- usage update + arbitration ---------------------------------------

    def _check_watermarks(self, consumer: MemConsumer) -> List[Dict]:
        """Record pending watermark crossings (lock held) and return
        them.  Each fraction fires once, in increasing order."""
        fired: List[Dict] = []
        budget = self.effective_budget
        while self._wm_next < len(self._wm_fractions):
            frac = self._wm_fractions[self._wm_next]
            if self.total_used < budget * frac:
                break
            crossing = {"fraction": frac, "used": self.total_used,
                        "budget": budget, "consumer": consumer.name,
                        "at": time.time()}
            self._wm_crossings.append(crossing)
            fired.append(crossing)
            self._wm_next += 1
        return fired

    def _record_spill(self, target: MemConsumer, requester: MemConsumer,
                      path: str, freed: int, wall_ns: int) -> SpillRecord:
        with self._lock:
            rec = SpillRecord(consumer=target.name,
                              requested_by=requester.name, path=path,
                              freed_bytes=int(freed), wall_ns=int(wall_ns),
                              total_used=self.total_used)
            self.num_spills += 1
            self.spill_bytes_freed += rec.freed_bytes
            self.spill_wall_ns += rec.wall_ns
            self._spills_by_path[path] = \
                self._spills_by_path.get(path, 0) + 1
            for i, bound in enumerate(SPILL_HIST_BOUNDS):
                if rec.freed_bytes <= bound:
                    self._spill_hist[i] += 1
                    break
            else:
                self._spill_hist[-1] += 1
            ent = self._by_name.get(target.name)
            if ent is not None:
                ent["spills"] += 1
                ent["freed_bytes"] += rec.freed_bytes
                ent["wall_ns"] += rec.wall_ns
            self._spill_records.append(rec)
            del self._spill_records[:-self.MAX_SPILL_RECORDS]
        # the spill runs on the task's thread, which carries its query's
        # context
        tracing.stats_bump("mem_spills")
        tracing.stats_bump("mem_spill_bytes", rec.freed_bytes)
        tracing.event("mem.spill", cat="mem", consumer=rec.consumer,
                      requested_by=rec.requested_by, path=rec.path,
                      freed_bytes=rec.freed_bytes,
                      wall_ms=rec.wall_ns / 1e6)
        return rec

    def _timed_spill(self, target: MemConsumer, requester: MemConsumer,
                     path: str) -> int:
        # spill() re-enters update() (consumers account the batches they
        # shed); while it runs on this thread no further spill may be
        # arbitrated, or a nested spill of the same consumer would take
        # its staged state from under the outer one
        self._tls.spilling = getattr(self._tls, "spilling", 0) + 1
        t0 = time.perf_counter_ns()
        try:
            freed = target.spill()
        finally:
            self._tls.spilling -= 1
        self._record_spill(target, requester, path, freed,
                           time.perf_counter_ns() - t0)
        return freed

    def _pick_spill_victim(self, candidates: List[MemConsumer]
                           ) -> MemConsumer:
        """Rank arbitration victims (lock held).

        - ``rate`` (default): the consumer class with the best observed
          freed-bytes-per-wall-second (`_by_name`); a class with no
          history ranks above every measured one, tie-broken by size, so
          the no-history pick is the largest consumer.
        - ``largest``: the pure largest-consumer policy.
        """
        strategy = str(conf.get("auron.memory.spill.victim.strategy"))
        if strategy == "largest":
            return max(candidates, key=lambda c: c.mem_used)
        _check_unported()

        def rank(c: MemConsumer):
            ent = self._by_name.get(c.name)
            if ent and ent.get("spills") and ent.get("wall_ns"):
                rate = ent["freed_bytes"] / ent["wall_ns"]
            else:
                rate = float("inf")   # no history: try it, seed history
            return (rate, c.mem_used, c.name)

        return max(candidates, key=rank)

    def update(self, consumer: MemConsumer, new_bytes: int) -> None:
        """Update usage; may synchronously spill (this consumer or
        another of this thread's) to stay under budget."""
        spill_target: Optional[MemConsumer] = None
        pressure: List[Dict] = []
        with self._lock:
            self.total_used += new_bytes - consumer.mem_used
            consumer.mem_used = new_bytes
            consumer.mem_peak = max(consumer.mem_peak, new_bytes)
            self.peak_used = max(self.peak_used, self.total_used)
            pressure = self._check_watermarks(consumer)
            if not getattr(self._tls, "spilling", 0) and \
                    self.total_used > self.effective_budget:
                trigger = min_trigger_size()
                me = threading.get_ident()
                candidates = [
                    c for c in self._consumers
                    if c.spillable and c.mem_used >= trigger and
                    c._owner_thread in (None, me)]
                if candidates:
                    spill_target = self._pick_spill_victim(candidates)
                # else: over budget, but nothing is big enough to bother
        for p in pressure:
            tracing.event("mem.pressure", cat="mem",
                          fraction=p["fraction"], used=p["used"],
                          budget=p["budget"], consumer=p["consumer"])
        if spill_target is None:
            return
        # spill outside the lock (spill() re-enters update())
        freed = self._timed_spill(
            spill_target, consumer,
            "arbitration" if spill_target is not consumer else "self")
        if freed <= 0 and spill_target is not consumer and \
                consumer.spillable and consumer.mem_used >= min_trigger_size():
            # the chosen target had nothing to give: the requester spills
            # itself
            self._timed_spill(consumer, consumer, "fallback")

    # -- snapshots ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"budget": self.budget, "reserved": self.reserved,
                    "effective_budget": self.effective_budget,
                    "total_used": self.total_used,
                    "peak_used": self.peak_used,
                    "num_consumers": len(self._consumers),
                    "num_spills": self.num_spills,
                    "spill_bytes_freed": self.spill_bytes_freed,
                    "spill_wall_ns": self.spill_wall_ns,
                    "spills_by_path": dict(self._spills_by_path),
                    "watermark_fractions": list(self._wm_fractions),
                    "watermarks_crossed": [dict(c)
                                           for c in self._wm_crossings]}

    def consumer_snapshot(self, top_n: int = 0) -> List[Dict[str, Any]]:
        """Live consumers sorted by current usage (largest first)."""
        with self._lock:
            rows = [{"name": c.name, "used": c.mem_used,
                     "peak": c.mem_peak, "spillable": c.spillable}
                    for c in self._consumers]
        rows.sort(key=lambda r: (-r["used"], -r["peak"], r["name"]))
        return rows[:top_n] if top_n else rows

    def consumer_totals(self) -> Dict[str, Dict[str, int]]:
        """Cumulative per-consumer-name aggregates (peak of peaks, spill
        count, bytes freed, wall time), surviving unregistration."""
        with self._lock:
            return {name: dict(ent) for name, ent in self._by_name.items()}

    def spill_records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.to_dict() for r in self._spill_records]

    def spill_histogram(self) -> Dict[str, int]:
        """Spill-size histogram over freed bytes, `le` upper bounds."""
        with self._lock:
            hist = list(self._spill_hist)
        out = {str(b): n for b, n in zip(SPILL_HIST_BOUNDS, hist)}
        out["+Inf"] = hist[-1]
        return out


_GLOBAL: Optional[MemManager] = None
_GLOBAL_LOCK = threading.Lock()


def get_manager() -> MemManager:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MemManager(None)
        return _GLOBAL


def reset_manager(budget_bytes: Optional[int] = None) -> MemManager:
    """Install a fresh manager (a test's tiny budget, a run's own
    accounting): peaks, watermarks and spill records restart."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = MemManager(budget_bytes)
        return _GLOBAL
