"""Expression evaluation on torch tensors (counterpart of
auron_tpu/exprs/compiler.py, with the type rules of exprs/typing.py and
exprs/values.py that these kinds need).

The kinds this slice evaluates: column reference, literal, cast and
multiply, with SQL null propagation (a null operand gives a null result,
and null slots hold zeros).  torch runs eagerly, so `build_evaluator`
resolves column indices once and each call evaluates the tree directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

from auron_tpu_torch.columnar.batch import Batch, DeviceColumn, flat
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir.schema import DataType, Schema, TypeId

_RANK = {
    TypeId.BOOL: 0, TypeId.INT8: 1, TypeId.INT16: 2, TypeId.INT32: 3,
    TypeId.INT64: 4, TypeId.FLOAT32: 5, TypeId.FLOAT64: 6,
}


def promote(a: DataType, b: DataType) -> DataType:
    """Numeric binary-op result type (the JAX package's widening)."""
    if a.id == b.id and not a.is_decimal:
        return a
    if a.is_decimal or b.is_decimal:
        return DataType.float64()
    if {a.id, b.id} == {TypeId.INT64, TypeId.FLOAT32}:
        return DataType.float64()
    return a if _RANK.get(a.id, 6) >= _RANK.get(b.id, 6) else b


def infer_type(expr: E.Expr, schema: Schema) -> DataType:
    k = expr.kind
    if k == "column":
        return schema.field(expr.name).dtype
    if k in ("literal", "cast"):
        return expr.dtype
    if k == "binary" and expr.op == "*":
        return promote(infer_type(expr.left, schema),
                       infer_type(expr.right, schema))
    raise NotImplementedError(
        f"expression {k!r}{' ' + expr.op if k == 'binary' else ''} is not "
        f"in auron_tpu_torch yet")


@dataclass
class EvalCtx:
    cols: List[DeviceColumn]
    schema: Schema
    capacity: int
    device: torch.device


def evaluate(expr: E.Expr, ctx: EvalCtx) -> DeviceColumn:
    fn = _DISPATCH.get(expr.kind)
    if fn is None:
        raise NotImplementedError(
            f"expression {expr.kind!r} is not in auron_tpu_torch yet")
    return fn(expr, ctx)


def _eval_column(e: E.Column, ctx: EvalCtx) -> DeviceColumn:
    return ctx.cols[ctx.schema.index_of(e.name)]


def _eval_literal(e: E.Literal, ctx: EvalCtx) -> DeviceColumn:
    dt = e.dtype if e.dtype.id != TypeId.NULL else DataType.bool_()
    tdt = dt.torch_dtype()
    if e.value is None:
        return DeviceColumn(
            dt, torch.zeros(ctx.capacity, dtype=tdt, device=ctx.device),
            torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device))
    return DeviceColumn(
        dt, torch.full((ctx.capacity,), e.value, dtype=tdt,
                       device=ctx.device),
        torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device))


def cast_column(col: DeviceColumn, dst: DataType) -> DeviceColumn:
    """Numeric casts: to float converts; float to integral truncates,
    saturates at the type's bounds and maps NaN to 0 (Spark); integral
    narrowing wraps (Java)."""
    src = col.dtype
    if src == dst:
        return col
    tdt = dst.torch_dtype()
    data, valid = col.data, col.validity
    if dst.is_integral and src.is_floating:
        info = torch.iinfo(tdt)
        x = torch.where(torch.isnan(data), 0.0, data)
        big, small = x >= float(info.max), x <= float(info.min)
        out = torch.trunc(torch.where(big | small, 0.0, x)).to(tdt)
        out = torch.where(big, info.max, torch.where(small, info.min, out))
        return flat(dst, out.to(tdt), valid)
    return flat(dst, data.to(tdt), valid)


def _eval_cast(e: E.Cast, ctx: EvalCtx) -> DeviceColumn:
    return cast_column(evaluate(e.child, ctx), e.dtype)


def _eval_binary(e: E.BinaryExpr, ctx: EvalCtx) -> DeviceColumn:
    if e.op != "*":
        raise NotImplementedError(
            f"binary op {e.op!r} is not in auron_tpu_torch yet")
    lc, rc = evaluate(e.left, ctx), evaluate(e.right, ctx)
    t = promote(lc.dtype, rc.dtype)
    tdt = t.torch_dtype()
    return flat(t, lc.data.to(tdt) * rc.data.to(tdt),
                lc.validity & rc.validity)


_DISPATCH: Dict[str, Callable[..., DeviceColumn]] = {
    "column": _eval_column,
    "literal": _eval_literal,
    "cast": _eval_cast,
    "binary": _eval_binary,
}


class CompiledExprs:
    """A fixed expression list over one input schema."""

    def __init__(self, exprs, schema: Schema):
        self.exprs = tuple(exprs)
        self.schema = schema
        self.out_types = [infer_type(x, schema) for x in self.exprs]

    def __call__(self, batch: Batch) -> List[DeviceColumn]:
        ctx = EvalCtx(batch.columns, self.schema, batch.capacity,
                      batch.device)
        return [evaluate(x, ctx) for x in self.exprs]


def build_evaluator(exprs, schema: Schema) -> CompiledExprs:
    return CompiledExprs(exprs, schema)
