"""Task execution (counterpart of auron_tpu/runtime/executor.py).

`execute_task_bytes` is the wire entry point, the JNI analogue: a
serialized `TaskDefinition` in, the root operator's batches out.  Every
entry point runs on the card unless the caller passes `device="cpu"`.
The JAX runtime's memory manager, retry tiers, plan verifier, fusion
pass and tracing are not in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.batch import Batch, empty_numpy
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir import serde as ir_serde
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.ops.base import TaskContext
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.runtime.resources import ResourceRegistry


@dataclass
class ExecutionResult:
    batches: List[Batch]
    schema: Schema
    metrics: Dict[str, int] = field(default_factory=dict)   # root operator

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
                      else ResourceRegistry(), device=dev)
    out = [b for b in root.execute(ctx) if b.num_rows > 0]
    return ExecutionResult(out, root.schema, dict(root.metrics))


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
