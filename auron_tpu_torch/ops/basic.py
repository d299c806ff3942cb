"""Basic operators (counterpart of auron_tpu/ops/basic.py): projection,
filter (with its fused projection), limit, union, expand, coalesce
batches, rename, debug and empty partitions."""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Tuple

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, DeviceStringColumn, bucket_capacity,
    concat_batches, null_column,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator, build_predicate
from auron_tpu_torch.ir.schema import DataType, Field, Schema
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


class UnionExec(Operator):
    """A union whose inputs carry their partition assignments: input i
    is partition `partition` of its child, read by the union's output
    partition `out_partition`, so a task streams exactly the child
    partitions assigned to it, each child partition read once across
    the union's tasks.  A task of a single-partition stage (the
    exchanges inlined) streams every assignment.  Without assignments,
    each task streams every child at its own partition id."""

    def __init__(self, children: List[Operator], schema: Schema,
                 assignments: Optional[List[Tuple[int, int]]] = None):
        super().__init__(schema, children)
        self.assignments = assignments

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        assignments = self.assignments if self.assignments is not None \
            else [(ctx.partition_id, ctx.partition_id)] * len(self.children)
        collapsed = ctx.num_partitions == 1
        for i, (out_pid, local_pid) in enumerate(assignments):
            if not collapsed and out_pid != ctx.partition_id:
                continue
            sub = dataclasses.replace(ctx, partition_id=local_pid)
            for b in self.child_stream(sub, i):
                yield Batch(self.schema, b.columns, b.num_rows, b.capacity)


def _conform(col: Column, dtype: DataType) -> Column:
    """A projection's column as the declared type: a flat column cast to
    its torch dtype, a null of no type as an all-null string column."""
    if dtype.is_stringlike:
        if isinstance(col, DeviceStringColumn):
            return col
        return null_column(dtype, col.capacity, col.validity.device)
    if isinstance(col, DeviceColumn) and col.dtype != dtype:
        return DeviceColumn(dtype, col.data.to(dtype.torch_dtype()),
                            col.validity)
    return col


class ExpandExec(Operator):
    """Grouping sets: each input batch once per projection list, the
    copies in one output batch (the first projection's rows, then the
    second's; the JAX package emits them one batch each), so that the
    consumer, a partial aggregation as a rule, reduces one batch where
    it would reduce one a projection (q27r's store_sales stage took
    32.9-35.1 s this way and 52.1-54.5 s with one batch a projection on
    an NVIDIA H100 80GB HBM3 at 700 W, tools/chip_q27r.py).  A string
    column's copies come at one width
    (the widest of its projections): a null string literal's copy does
    not put the consumer's batches in another width bucket."""

    def __init__(self, child: Operator, projections, names, types=None):
        self.projections = tuple(tuple(p) for p in projections)
        self._evals = [build_evaluator(p, child.schema)
                       for p in self.projections]
        types = tuple(types) if types else self._evals[0].out_types
        super().__init__(Schema(tuple(
            Field(n, t) for n, t in zip(names, types))), [child])

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        dtypes = [f.dtype for f in self.schema]
        for b in self.child_stream(ctx):
            if b.num_rows == 0:
                continue
            copies = [b.with_columns(self.schema, [
                _conform(c, t) for c, t in zip(ev(b), dtypes)])
                for ev in self._evals]
            yield copies[0] if len(copies) == 1 else \
                concat_batches(self.schema, copies)


class CoalesceBatchesExec(Operator):
    """Small batches concatenated up to the target row count
    (`auron.batch.size` when 0); a batch at the target passes through."""

    def __init__(self, child: Operator, target: int = 0):
        super().__init__(child.schema, [child])
        self.target = target or int(conf.get("auron.batch.size"))

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        staged: List[Batch] = []
        staged_rows = 0
        for b in self.child_stream(ctx):
            if b.num_rows == 0:
                continue
            if b.num_rows >= self.target and not staged:
                yield b
                continue
            staged.append(b)
            staged_rows += b.num_rows
            if staged_rows >= self.target:
                yield concat_batches(self.schema, staged)
                staged, staged_rows = [], 0
        if staged:
            yield concat_batches(self.schema, staged)


class RenameColumnsExec(Operator):
    def __init__(self, child: Operator, names):
        self.names = tuple(names)
        super().__init__(child.schema.rename(self.names), [child])

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        for b in self.child_stream(ctx):
            yield b.rename(self.names)


class DebugExec(Operator):
    """Pass-through that logs each batch's row count and first 10 rows
    to the `auron_tpu_torch.debug` logger at INFO.  The rows are read
    back from the device only while that level is enabled."""

    def __init__(self, child: Operator, debug_id: str = ""):
        super().__init__(child.schema, [child])
        self.debug_id = debug_id

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        log = logging.getLogger("auron_tpu_torch.debug")
        for i, b in enumerate(self.child_stream(ctx)):
            if log.isEnabledFor(logging.INFO):
                arrays, _ = b.head(10).to_numpy()
                log.info("[%s] batch %d: %d rows\n%s", self.debug_id, i,
                         b.num_rows, dict(zip(self.schema.names(),
                                              (a.tolist() for a in arrays))))
            yield b


class EmptyPartitionsExec(Operator):
    """No rows, in every partition."""

    def __init__(self, schema: Schema, num_partitions: int = 1):
        super().__init__(schema, [])
        self.num_partitions = num_partitions

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        return iter(())
