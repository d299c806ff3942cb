"""Static type inference over expression trees (counterpart of
auron_tpu/exprs/typing.py `infer_type`, with `promote` of
exprs/values.py and `_binary_result_type` of exprs/compiler.py).

The front end supplies explicit result types where the semantics are
subtle (casts, aggregate returns); these rules give the rest, the same
as the JAX package's for the kinds the port evaluates.
"""

from __future__ import annotations

from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir.schema import (
    MAX_DEVICE_DECIMAL_PRECISION, DataType, Schema, TypeId,
)

CMP_OPS = {"==", "=", "!=", "<", "<=", ">", ">=", "<=>"}
LOGIC_OPS = {"and", "or"}
BIT_OPS = {"&", "|", "^", "<<", ">>"}

_RANK = {
    TypeId.BOOL: 0, TypeId.INT8: 1, TypeId.INT16: 2, TypeId.INT32: 3,
    TypeId.INT64: 4, TypeId.FLOAT32: 5, TypeId.FLOAT64: 6,
}

# the scalar functions whose result has their first argument's type
# where the plan gives no return type
_KEEPS_ARG_TYPE = {"round", "normalize_nan_and_zero", "check_overflow"}

_BOOL_KINDS = {"is_null", "is_not_null", "not", "sc_and", "sc_or",
               "in_list"}


def promote(a: DataType, b: DataType) -> DataType:
    """Numeric binary-op result type (the JAX package's widening): a
    decimal gives float64, a date or timestamp side wins, else the wider
    rank, and int64 with float32 gives float64."""
    if a.id == b.id and not a.is_decimal:
        return a
    if a.is_decimal or b.is_decimal:
        return DataType.float64()
    if a.id in (TypeId.DATE32, TypeId.TIMESTAMP_US):
        return a
    if b.id in (TypeId.DATE32, TypeId.TIMESTAMP_US):
        return b
    if {a.id, b.id} == {TypeId.INT64, TypeId.FLOAT32}:
        return DataType.float64()
    return a if _RANK.get(a.id, 6) >= _RANK.get(b.id, 6) else b


def binary_result_type(op: str, lt: DataType, rt: DataType) -> DataType:
    """Result type of an arithmetic or bitwise op (the JAX package's
    `_binary_result_type`): `/` of two integral operands or of a decimal
    gives float64; `+` and `-` of two decimals of one scale stay decimal
    at that scale, one digit wider up to 18; the rest promote (any other
    op over a decimal: float64)."""
    if op == "/" and (lt.is_decimal or rt.is_decimal or
                      (lt.is_integral and rt.is_integral)):
        return DataType.float64()
    if op in ("+", "-") and lt.is_decimal and rt.is_decimal and \
            lt.scale == rt.scale:
        return DataType.decimal(min(max(lt.precision, rt.precision) + 1,
                                    MAX_DEVICE_DECIMAL_PRECISION), lt.scale)
    return promote(lt, rt)


def infer_type(expr: E.Expr, schema: Schema) -> DataType:
    k = expr.kind
    if k == "column":
        return schema.field(expr.name).dtype
    if k == "literal":
        return expr.dtype
    if k == "binary":
        if expr.op in CMP_OPS or expr.op in LOGIC_OPS:
            return DataType.bool_()
        lt = infer_type(expr.left, schema)
        rt = infer_type(expr.right, schema)
        if expr.op == "+" and lt.id == TypeId.DATE32 and rt.is_integral:
            return lt
        if expr.op == "-" and lt.id == TypeId.DATE32:
            return DataType.int32() if rt.id == TypeId.DATE32 else lt
        return binary_result_type(expr.op, lt, rt)
    if k in _BOOL_KINDS:
        return DataType.bool_()
    if k in ("cast", "try_cast"):
        return expr.dtype
    if k == "negative":
        return infer_type(expr.child, schema)
    if k == "case":
        # promote across all branch and else values (Spark coerces to
        # their least common type); null literals do not take part
        out = None
        ts = [infer_type(b.then, schema) for b in expr.branches]
        if expr.else_expr is not None:
            ts.append(infer_type(expr.else_expr, schema))
        for t in ts:
            if t.id == TypeId.NULL:
                continue
            out = t if out is None or out == t else promote(out, t)
        return out if out is not None else DataType.null()
    if k == "scalar_function":
        if expr.return_type.id != TypeId.NULL:
            return expr.return_type
        if expr.name == "unscaled_value":
            return DataType.int64()
        if expr.name == "make_decimal":
            return DataType.decimal(MAX_DEVICE_DECIMAL_PRECISION, 0)
        # round and normalize_nan_and_zero keep their argument's type;
        # coalesce takes the first argument that is not a null literal
        for a in expr.args[:1] if expr.name in _KEEPS_ARG_TYPE \
                else expr.args:
            t = infer_type(a, schema)
            if t.id != TypeId.NULL:
                return t
        return DataType.null()
    raise NotImplementedError(
        f"expression {k!r} is not in auron_tpu_torch yet")
