"""Operator protocol and execution context (counterpart of
auron_tpu/ops/base.py).

Operators are host-driven generators of padded device batches.  Each
keeps a flat dict of counters (`metrics`) that the task returns for its
root operator; the JAX package's metric trees, memory manager and
tracing are not in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import torch

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.runtime.resources import ResourceRegistry


@dataclass
class TaskContext:
    """Per-task context: ids, the resources plan nodes name, and the
    device the task's batches live on."""
    stage_id: int = 0
    partition_id: int = 0
    num_partitions: int = 1
    resources: ResourceRegistry = field(default_factory=ResourceRegistry)
    device: torch.device = field(
        default_factory=lambda: torch.device("cpu"))


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


def compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Stable (ascending) indices of the set bits of a bool mask, and
    their count: the filter's compaction primitive.  The JAX package
    pads the indices to a static capacity and keeps the count on the
    device; here `torch.nonzero` sizes its output by the count, so the
    count comes back to the host with it, in one read."""
    idx = torch.nonzero(mask).squeeze(1)
    return idx, int(idx.shape[0])
