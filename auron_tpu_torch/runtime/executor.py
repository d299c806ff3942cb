"""Task execution (counterpart of auron_tpu/runtime/executor.py).

`execute_task_bytes` is the wire entry point, the JNI analogue: a
serialized `TaskDefinition` in, the root operator's batches out.  Every
entry point runs on the card unless the caller passes `device="cpu"`.
A task runs under the process's memory manager (`memmgr.get_manager()`),
so its sort, aggregation, window and sort-merge join spill past the
budget.  The JAX runtime's retry tiers, plan verifier, fusion pass and
tracing are not in the port yet (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.batch import Batch, empty_numpy
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir import serde as ir_serde
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.memmgr import get_manager
from auron_tpu_torch.ops.base import Operator, TaskContext
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.runtime.resources import ResourceRegistry


@dataclass
class ExecutionResult:
    batches: List[Batch]
    schema: Schema
    metrics: Dict[str, int] = field(default_factory=dict)   # root operator
    # every operator's counters, pre-order: (class name, counters)
    operator_metrics: List[Tuple[str, Dict[str, int]]] = field(
        default_factory=list)

    def summed(self, name: str) -> int:
        """A counter summed over every operator of the task."""
        return sum(m.get(name, 0) for _, m in self.operator_metrics)

    def to_numpy(self) -> Dict[str, tuple]:
        """{column name: (data, validity)} of all rows, on the host (a
        string column as an object array, `Batch.to_numpy`)."""
        parts = [b.to_numpy() for b in self.batches]
        out = {}
        for i, f in enumerate(self.schema):
            out[f.name] = (
                np.concatenate([empty_numpy(f.dtype)] +
                               [p[0][i] for p in parts]),
                np.concatenate([np.zeros(0, bool)] + [p[1][i] for p in parts]))
        return out


def execute_task(task: P.TaskDefinition,
                 resources: Optional[ResourceRegistry] = None,
                 device=None) -> ExecutionResult:
    dev = resolve_device(device)
    root = PhysicalPlanner().create_plan(task.plan)
    ctx = TaskContext(stage_id=task.stage_id,
                      partition_id=task.partition_id,
                      num_partitions=task.num_partitions,
                      resources=resources if resources is not None
                      else ResourceRegistry(), device=dev,
                      mem_manager=get_manager())
    out = [b for b in root.execute(ctx) if b.num_rows > 0]
    return ExecutionResult(out, root.schema, dict(root.metrics),
                           _operator_metrics(root))


def _operator_metrics(root: Operator) -> List[Tuple[str, Dict[str, int]]]:
    out, stack = [], [root]
    while stack:
        op = stack.pop()
        out.append((type(op).__name__, dict(op.metrics)))
        stack.extend(reversed(op.children))
    return out


def execute_plan(plan: P.PlanNode, partition_id: int = 0,
                 num_partitions: int = 1,
                 resources: Optional[ResourceRegistry] = None,
                 device=None) -> ExecutionResult:
    """Run one partition of a plan to completion."""
    return execute_task(P.TaskDefinition(plan=plan,
                                         partition_id=partition_id,
                                         num_partitions=num_partitions),
                        resources, device)


def execute_task_bytes(task_bytes: bytes,
                       resources: Optional[ResourceRegistry] = None,
                       device=None) -> ExecutionResult:
    """The wire entry point: a serialized TaskDefinition in, batches out."""
    td = ir_serde.deserialize(task_bytes)
    if not isinstance(td, P.TaskDefinition):
        raise TypeError(f"expected a task_definition, got {td.kind!r}")
    return execute_task(td, resources, device)
