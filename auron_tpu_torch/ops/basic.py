"""Basic operators (counterpart of auron_tpu/ops/basic.py): projection,
filter (with its fused projection) and limit."""

from __future__ import annotations

from typing import Iterator

import torch

from auron_tpu_torch.columnar.batch import Batch, bucket_capacity
from auron_tpu_torch.exprs.compiler import build_evaluator, build_predicate
from auron_tpu_torch.ir.schema import Field, Schema
from auron_tpu_torch.ops.base import Operator, TaskContext, compact_indices


class ProjectExec(Operator):
    def __init__(self, child: Operator, exprs, names):
        self._eval = build_evaluator(exprs, child.schema)
        super().__init__(Schema(tuple(
            Field(n, t) for n, t in zip(names, self._eval.out_types))),
            [child])

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        for b in self.child_stream(ctx):
            yield b.with_columns(self.schema, self._eval(b))


class FilterExec(Operator):
    """Filter with an optional fused projection (the planner fuses a
    Projection over a Filter, as the JAX package's does).

    Per batch: the conjunction of the predicates, keep = valid and true
    on the live rows (a null predicate drops the row), the stable indices
    of the kept rows by `compact_indices` (the one host read), and a
    gather of the kept rows at capacity bucket_capacity(count).  The
    projection, a row-wise function, is evaluated on the kept rows only.
    A batch that keeps no row is dropped."""

    def __init__(self, child: Operator, predicates, exprs=None, names=None):
        in_schema = child.schema
        self.predicates = tuple(predicates)
        self.exprs = tuple(exprs) if exprs is not None else None
        self._pred = build_predicate(self.predicates, in_schema)
        self._proj = build_evaluator(self.exprs, in_schema) \
            if self.exprs is not None else None
        out_schema = in_schema if self._proj is None else Schema(tuple(
            Field(n, t) for n, t in zip(names, self._proj.out_types)))
        super().__init__(out_schema, [child])

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        for b in self.child_stream(ctx):
            if b.num_rows == 0:
                continue
            [m] = self._pred(b)
            keep = (m.validity & (m.data != 0))[:b.num_rows]
            idx, count = compact_indices(keep)
            if count == 0:
                continue
            cap = bucket_capacity(count)
            kept = b.gather(torch.nn.functional.pad(idx, (0, cap - count)),
                            count)
            yield kept if self._proj is None else \
                kept.with_columns(self.schema, self._proj(kept))


class LimitExec(Operator):
    """The first `limit` rows after skipping `offset`, across batches;
    stops pulling its child once the limit is reached."""

    def __init__(self, child: Operator, limit: int, offset: int = 0):
        super().__init__(child.schema, [child])
        self.limit = limit
        self.offset = offset

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        to_skip, remaining = self.offset, self.limit
        for b in self.child_stream(ctx):
            if remaining <= 0:
                return
            if to_skip >= b.num_rows:
                to_skip -= b.num_rows
                continue
            if to_skip > 0:
                b = b.slice(to_skip, b.num_rows - to_skip)
                to_skip = 0
            if b.num_rows > remaining:
                b = b.head(remaining)
            remaining -= b.num_rows
            yield b
