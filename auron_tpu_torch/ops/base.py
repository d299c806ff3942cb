"""Operator protocol and execution context (counterpart of
auron_tpu/ops/base.py).

Operators are host-driven generators of padded device batches.  Each
keeps a flat dict of counters (`metrics`); the task returns its root
operator's, and every operator's by name.  A spillable operator
registers with the task's memory manager for the length of its stream
(`mem_scope`): its peak lands in its counters as `mem_peak`, and each
spill it writes counts `mem_spill_count`, `mem_spill_size` (the bytes the
tier holds) and `mem_spill_<tier>` (`count_spill`).  The JAX package's
metric trees and tracing are not in the port yet (ROADMAP Queue 1 item
16).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.memmgr import MemConsumer, SpillManager
from auron_tpu_torch.runtime.resources import ResourceRegistry


@dataclass
class TaskContext:
    """Per-task context: ids, the resources plan nodes name, the device
    the task's batches live on, and its memory manager (None: the
    process's, `memmgr.get_manager()`)."""
    stage_id: int = 0
    partition_id: int = 0
    num_partitions: int = 1
    resources: ResourceRegistry = field(default_factory=ResourceRegistry)
    device: torch.device = field(
        default_factory=lambda: torch.device("cpu"))
    mem_manager: Optional[Any] = None


class Operator:
    """Base operator: `execute(ctx)` yields Batches of `self.schema`."""

    def __init__(self, schema: Schema, children: List["Operator"]):
        self.schema = schema
        self.children = children
        self.metrics: Dict[str, int] = {}

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        raise NotImplementedError

    def child_stream(self, ctx: TaskContext, i: int = 0) -> Iterator[Batch]:
        return self.children[i].execute(ctx)

    def count(self, name: str, n: int = 1) -> None:
        self.metrics[name] = self.metrics.get(name, 0) + n

    def count_spill(self, spill, size: int) -> None:
        """A spill this operator wrote: `size` bytes to `spill`'s tier."""
        self.count("mem_spill_count")
        self.count("mem_spill_size", size)
        self.count(f"mem_spill_{spill.tier}")

    @contextmanager
    def mem_scope(self, ctx: TaskContext, consumer=None):
        """Register a MemConsumer (the operator itself by default) with
        the task's memory manager for the length of the scope; on
        unregister its peak lands in this operator's `mem_peak`."""
        from auron_tpu_torch.memmgr import get_manager
        mgr = ctx.mem_manager or get_manager()
        c = consumer if consumer is not None else self
        c.bind_metrics(self.metrics)
        mgr.register_consumer(c)
        try:
            yield mgr
        finally:
            mgr.unregister_consumer(c)


class StagingOperator(Operator, MemConsumer):
    """An operator that stages batches as a memory consumer and, under
    pressure, spills them as one sorted run (`sorted_run`).  `_staged`
    and `_staged_bytes` are what the manager is told it holds."""

    def __init__(self, schema: Schema, children: List[Operator],
                 name: str, spill_kind: str):
        Operator.__init__(self, schema, children)
        MemConsumer.__init__(self, name)
        self._staged: List[Batch] = []
        self._staged_bytes = 0
        self._spills = SpillManager(spill_kind)

    def sorted_run(self, batches: List[Batch]) -> List[Batch]:
        """The staged batches as one sorted run, the batches a spill
        holds."""
        raise NotImplementedError

    def set_staged(self, batches: List[Batch]) -> None:
        self._staged = batches
        self._staged_bytes = sum(b.mem_bytes() for b in batches)
        self.update_mem_used(self._staged_bytes)

    def take_staged(self) -> List[Batch]:
        batches = self._staged
        self.set_staged([])
        return batches

    def stage(self, b: Batch) -> None:
        self._staged.append(b)
        self._staged_bytes += b.mem_bytes()
        self.update_mem_used(self._staged_bytes)

    def spill(self) -> int:
        if not self._staged:
            return 0
        freed = self._staged_bytes
        run = self.sorted_run(self._staged)
        spill = self._spills.new_spill()
        self.count_spill(spill, spill.write_batches(run))
        self.set_staged([])
        return freed

    @contextmanager
    def spill_scope(self, ctx: TaskContext):
        """`mem_scope` for the length of the stream; at its end, however
        it ends, the staged batches are dropped and the spills
        released."""
        try:
            with self.mem_scope(ctx) as mgr:
                yield mgr
        finally:
            self._staged = []
            self._staged_bytes = 0
            self._spills.release_all()

    def run_staged(self, ctx: TaskContext,
                   in_memory: Callable[[List[Batch]], Iterator[Batch]],
                   merge: Callable[[List[Iterator[Batch]]], Iterator[Batch]]
                   ) -> Iterator[Batch]:
        """Stage the child's stream; then `in_memory(staged batches)`
        when nothing spilled, else the staged tail spills as the last
        run and `merge(the runs' readers, in spill order)`."""
        with self.spill_scope(ctx):
            for b in self.child_stream(ctx):
                if b.num_rows:
                    self.stage(b)
            if not len(self._spills):
                yield from in_memory(self.take_staged())
                return
            self.spill()
            yield from merge([s.read_batches()
                              for s in self._spills.spills])


def compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Stable (ascending) indices of the set bits of a bool mask, and
    their count: the filter's compaction primitive.  The JAX package
    pads the indices to a static capacity and keeps the count on the
    device; here `torch.nonzero` sizes its output by the count, so the
    count comes back to the host with it, in one read."""
    idx = torch.nonzero(mask).squeeze(1)
    return idx, int(idx.shape[0])
