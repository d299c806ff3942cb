"""Basic operators (counterpart of auron_tpu/ops/basic.py): projection."""

from __future__ import annotations

from typing import Iterator

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.schema import Field, Schema
from auron_tpu_torch.ops.base import Operator, TaskContext


class ProjectExec(Operator):
    def __init__(self, child: Operator, exprs, names):
        self._eval = build_evaluator(exprs, child.schema)
        super().__init__(Schema(tuple(
            Field(n, t) for n, t in zip(names, self._eval.out_types))),
            [child])

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        for b in self.child_stream(ctx):
            yield b.with_columns(self.schema, self._eval(b))
