"""Expression evaluation on torch tensors (counterpart of
auron_tpu/exprs/compiler.py; the type rules are in exprs/typing.py and
the casts in exprs/cast.py).

The kinds the port evaluates: column reference, literal, the binary
node (`+ - * / %`, `& | ^ << >>`, the comparisons `== != < <= > >= <=>`
and Kleene `and`/`or`), `is_null`, `is_not_null`, `not`, `negative`,
`cast`, `try_cast`, `case`, `in_list` and the short-circuit `sc_and` /
`sc_or` (evaluated as Kleene logic over both sides).  SQL semantics:
- a null operand gives a null result, and null slots hold zeros;
- Spark's division and remainder by zero give null, integer division
  truncates toward zero and the remainder takes the dividend's sign;
- float comparisons hold NaN equal to NaN and above every number;
- a date plus or minus an integer is a date, a date minus a date an
  int32 count of days.
Over string and binary columns (`DeviceStringColumn`): a column
reference passes its column through, a string literal is a broadcast
string column (the JAX package's `values.py::literal_column`), built
once per batch capacity and reused, CASE picks among string branches
(`_case_strings`, the JAX package's), `is_null` / `is_not_null` read
the validity, the comparisons `== != <=> < <= > >=` of two strings and
`IN` over strings go through `exprs/strings.py` (a literal operand as
one broadcast row), and `coalesce` / `nvl` take string arguments
(`exprs/functions.py`).  Any other kind with a string operand, and a
scalar function outside `exprs/functions.py`'s registry, raise
NotImplementedError naming the kind where the expression is built
(`check_string_operands`), as the string, row-id, UDF, subquery and
bloom kinds do.  torch runs eagerly, so `build_evaluator` resolves the
output types once and each call evaluates the trees directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, DeviceStringColumn, bucket_width, flat,
    string_col, string_width,
)
from auron_tpu_torch.exprs import functions as F
from auron_tpu_torch.exprs.cast import cast_column
from auron_tpu_torch.exprs.strings import string_cmp, string_eq
from auron_tpu_torch.exprs.typing import (
    CMP_OPS, binary_result_type, infer_type, promote,
)
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir.schema import DataType, Schema, TypeId


@dataclass
class EvalCtx:
    cols: List[Column]
    schema: Schema
    capacity: int
    device: torch.device
    # broadcast string literals by (node id, capacity, device), kept by
    # the CompiledExprs across its batches
    literals: Dict[tuple, DeviceStringColumn] = field(default_factory=dict)

    def ones(self) -> torch.Tensor:
        return torch.ones(self.capacity, dtype=torch.bool, device=self.device)


def evaluate(expr: E.Expr, ctx: EvalCtx) -> Column:
    fn = _DISPATCH.get(expr.kind)
    if fn is None:
        raise NotImplementedError(
            f"expression {expr.kind!r} is not in auron_tpu_torch yet")
    return fn(expr, ctx)


def _eval_column(e: E.Column, ctx: EvalCtx) -> Column:
    return ctx.cols[ctx.schema.index_of(e.name)]


def _string_literal(e: E.Literal, dt: DataType, ctx: EvalCtx
                    ) -> DeviceStringColumn:
    """A string literal broadcast to every row (a None value: all null),
    built once for each capacity: no operator writes a column in place."""
    key = (id(e), ctx.capacity, ctx.device)
    col = ctx.literals.get(key)
    if col is not None:
        return col
    value = e.value
    raw = b"" if value is None else \
        value.encode("utf-8") if isinstance(value, str) else bytes(value)
    data = torch.zeros(ctx.capacity, string_width(len(raw), dt),
                       dtype=torch.uint8, device=ctx.device)
    if raw:
        data[:, :len(raw)] = torch.frombuffer(
            bytearray(raw), dtype=torch.uint8).to(ctx.device)
    valid = torch.full((ctx.capacity,), value is not None, dtype=torch.bool,
                       device=ctx.device)
    col = ctx.literals[key] = DeviceStringColumn(dt, data, torch.full(
        (ctx.capacity,), len(raw), dtype=torch.int32, device=ctx.device),
        valid)
    return col


def _string_literal_row(e: E.Literal, ctx: EvalCtx) -> DeviceStringColumn:
    """A string literal as one row (`[1, W]` bytes), which broadcasts
    against a column in a comparison; built once per device."""
    key = (id(e), "row", ctx.device)
    col = ctx.literals.get(key)
    if col is None:
        value = e.value
        raw = b"" if value is None else \
            value.encode("utf-8") if isinstance(value, str) else bytes(value)
        data = torch.zeros(1, string_width(len(raw), e.dtype),
                           dtype=torch.uint8)
        if raw:
            data[0, :len(raw)] = torch.frombuffer(bytearray(raw),
                                                  dtype=torch.uint8)
        col = ctx.literals[key] = DeviceStringColumn(
            e.dtype, data.to(ctx.device),
            torch.full((1,), len(raw), dtype=torch.int32, device=ctx.device),
            torch.full((1,), value is not None, dtype=torch.bool,
                       device=ctx.device))
    return col


def operand(x: E.Expr, ctx: EvalCtx) -> Column:
    """An operand of a comparison: a string literal as one broadcast row
    (`_string_literal_row`), anything else evaluated."""
    if x.kind == "literal" and x.dtype.is_stringlike:
        return _string_literal_row(x, ctx)
    return evaluate(x, ctx)


def _rows(t: torch.Tensor, ctx: EvalCtx) -> torch.Tensor:
    """A per-row result at the batch capacity (two literal rows compared
    give one row)."""
    return t if t.shape[0] == ctx.capacity else t.expand(ctx.capacity)


def _string_binary(op: str, lc: DeviceStringColumn, rc: DeviceStringColumn,
                   ctx: EvalCtx) -> DeviceColumn:
    """A comparison of two strings (the JAX package's `_string_binary`)."""
    if op in ("==", "=", "<=>", "!="):
        data = string_eq(lc, rc)
        if op == "!=":
            data = ~data
    else:
        c = string_cmp(lc, rc)
        data = {"<": c < 0, "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op]
    both = lc.validity & rc.validity
    if op == "<=>":     # null-safe equal: never null
        data = torch.where(both, data, ~lc.validity & ~rc.validity)
        return DeviceColumn(DataType.bool_(), _rows(data, ctx), ctx.ones())
    return flat(DataType.bool_(), _rows(data, ctx), _rows(both, ctx))


def _eval_literal(e: E.Literal, ctx: EvalCtx) -> Column:
    dt = e.dtype if e.dtype.id != TypeId.NULL else DataType.bool_()
    if dt.is_stringlike:
        return _string_literal(e, dt, ctx)
    tdt = dt.torch_dtype()
    if e.value is None:
        return DeviceColumn(
            dt, torch.zeros(ctx.capacity, dtype=tdt, device=ctx.device),
            torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device))
    return DeviceColumn(
        dt, torch.full((ctx.capacity,), e.value, dtype=tdt,
                       device=ctx.device), ctx.ones())


def _eval_is_null(e: E.IsNull, ctx: EvalCtx) -> DeviceColumn:
    c = evaluate(e.child, ctx)
    return DeviceColumn(DataType.bool_(), ~c.validity, ctx.ones())


def _eval_is_not_null(e: E.IsNotNull, ctx: EvalCtx) -> DeviceColumn:
    c = evaluate(e.child, ctx)
    return DeviceColumn(DataType.bool_(), c.validity, ctx.ones())


def _eval_not(e: E.Not, ctx: EvalCtx) -> DeviceColumn:
    c = evaluate(e.child, ctx)
    return flat(DataType.bool_(), c.data == 0, c.validity)


def _eval_negative(e: E.Negative, ctx: EvalCtx) -> DeviceColumn:
    c = evaluate(e.child, ctx)
    if c.dtype.id == TypeId.BOOL:
        raise TypeError("negative of a bool")
    return flat(c.dtype, -c.data, c.validity)


def _eval_cast(e, ctx: EvalCtx) -> DeviceColumn:
    return cast_column(evaluate(e.child, ctx), e.dtype,
                       try_=e.kind == "try_cast")


def _as(col: DeviceColumn, t: DataType) -> torch.Tensor:
    return col.data.to(t.torch_dtype())


def compare(op: str, a: torch.Tensor, b: torch.Tensor, t: DataType
            ) -> torch.Tensor:
    """Spark's comparison of two tensors of type t: floats hold NaN equal
    to NaN and above every number (and -0.0 equal to 0.0)."""
    if t.is_floating:
        an, bn = torch.isnan(a), torch.isnan(b)
        both_num = ~an & ~bn
        eq = (an & bn) | (both_num & (a == b))
        lt = (~an & bn) | (both_num & (a < b))
    else:
        eq, lt = a == b, a < b
    if op in ("==", "=", "<=>"):
        return eq
    if op == "!=":
        return ~eq
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return ~(lt | eq)
    if op == ">=":
        return ~lt
    raise NotImplementedError(f"comparison {op!r}")


def _int_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncated (toward zero) integer division, Java/Spark semantics."""
    q = torch.div(torch.abs(a), torch.abs(b), rounding_mode="floor")
    return torch.sign(a) * torch.sign(b) * q


def _eval_binary(e: E.BinaryExpr, ctx: EvalCtx) -> DeviceColumn:
    op = e.op
    if op in CMP_OPS:
        lc, rc = operand(e.left, ctx), operand(e.right, ctx)
        if isinstance(lc, DeviceStringColumn):
            return _string_binary(op, lc, rc, ctx)
    else:
        lc, rc = evaluate(e.left, ctx), evaluate(e.right, ctx)
    if op in ("and", "or"):
        return kleene(op, lc, rc)
    both = lc.validity & rc.validity
    if op in CMP_OPS:
        t = promote(lc.dtype, rc.dtype)
        data = compare(op, _as(lc, t), _as(rc, t), t)
        if op == "<=>":     # null-safe equal: never null
            data = torch.where(both, data, ~lc.validity & ~rc.validity)
            return DeviceColumn(DataType.bool_(), data, ctx.ones())
        return flat(DataType.bool_(), data, both)
    if lc.dtype.id == TypeId.DATE32 and op in ("+", "-"):
        if rc.dtype.id == TypeId.DATE32 and op == "-":
            return flat(DataType.int32(), lc.data - rc.data, both)
        delta = rc.data.to(torch.int32)
        return flat(DataType.date32(),
                    lc.data + delta if op == "+" else lc.data - delta, both)
    t = binary_result_type(op, lc.dtype, rc.dtype)
    if t.id == TypeId.BOOL and op not in ("&", "|", "^"):
        raise TypeError(f"arithmetic {op!r} on bool operands")
    a, b = _as(lc, t), _as(rc, t)
    if op == "+":
        data = a + b
    elif op == "-":
        data = a - b
    elif op == "*":
        data = a * b
    elif op in ("/", "%", "mod"):
        # Spark: a zero divisor gives null
        zero = b == 0
        both = both & ~zero
        one = torch.ones((), dtype=b.dtype, device=b.device)
        if op == "/":
            bb = torch.where(zero, one, b)
            data = a / bb if t.is_floating else _int_div(a, bb)
        else:
            # Java's %: the exact remainder with the dividend's sign; x % -1
            # is 0 (= x % 1), which spares MIN % -1 its overflow
            bb = torch.where(zero | (b == -1), one, b)
            data = torch.fmod(a, bb)
    elif op == "&":
        data = a & b
    elif op == "|":
        data = a | b
    elif op == "^":
        data = a ^ b
    elif op in ("<<", ">>"):
        n = torch.remainder(b, a.element_size() * 8)
        data = a << n if op == "<<" else a >> n
    else:
        raise NotImplementedError(
            f"binary op {op!r} is not in auron_tpu_torch yet")
    return flat(t, data, both)


def kleene(op: str, lc: DeviceColumn, rc: DeviceColumn) -> DeviceColumn:
    """SQL three-valued AND/OR: false AND null is false, true OR null is
    true, otherwise a null side gives null."""
    a, av = lc.data != 0, lc.validity
    b, bv = rc.data != 0, rc.validity
    if op == "and":
        data = (a | ~av) & (b | ~bv)
        valid = (av & bv) | (av & ~a) | (bv & ~b)
    else:
        data = (a & av) | (b & bv)
        valid = (av & bv) | (av & a) | (bv & b)
    return flat(DataType.bool_(), data, valid)


def _eval_sc(e, ctx: EvalCtx) -> DeviceColumn:
    # both sides are evaluated over the whole batch: the short circuit is
    # an optimisation of row-at-a-time engines, the value is Kleene logic
    lc, rc = evaluate(e.left, ctx), evaluate(e.right, ctx)
    return kleene("and" if e.kind == "sc_and" else "or", lc, rc)


def _eval_case(e: E.Case, ctx: EvalCtx) -> Column:
    out_dtype = infer_type(e, ctx.schema)
    if out_dtype.id == TypeId.NULL:
        out_dtype = DataType.bool_()
    if out_dtype.is_stringlike:
        return _case_strings(e, out_dtype, ctx)
    tdt = out_dtype.torch_dtype()
    data = torch.zeros(ctx.capacity, dtype=tdt, device=ctx.device)
    valid = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    decided = torch.zeros_like(valid)
    for br in e.branches:
        w, t = evaluate(br.when, ctx), evaluate(br.then, ctx)
        fire = ~decided & w.validity & (w.data != 0)
        data = torch.where(fire, t.data.to(tdt), data)
        valid = torch.where(fire, t.validity, valid)
        decided = decided | fire
    if e.else_expr is not None:
        el = evaluate(e.else_expr, ctx)
        data = torch.where(decided, data, el.data.to(tdt))
        valid = torch.where(decided, valid, el.validity)
    return flat(out_dtype, data, valid)


def _case_strings(e: E.Case, out_dtype: DataType, ctx: EvalCtx
                  ) -> DeviceStringColumn:
    """CASE whose value is a string (the JAX package's `_case_strings`):
    the branches' byte matrices padded to the widest; a null-literal
    branch contributes no bytes, only a decided, null slot."""
    def value(x: E.Expr):
        return None if _null_literal(x) else evaluate(x, ctx)
    branches = [(evaluate(br.when, ctx), value(br.then))
                for br in e.branches]
    el = value(e.else_expr) if e.else_expr is not None else None
    strs = [t for _, t in branches if t is not None] + \
        ([el] if el is not None else [])
    w_max = max([t.width for t in strs], default=bucket_width(1))
    data = torch.zeros(ctx.capacity, w_max, dtype=torch.uint8,
                       device=ctx.device)
    lens = torch.zeros(ctx.capacity, dtype=torch.int32, device=ctx.device)
    valid = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    decided = torch.zeros_like(valid)
    for w, t in branches:
        fire = ~decided & w.validity & (w.data != 0)
        if t is not None:
            data = torch.where(fire[:, None], t.widened(w_max), data)
            lens = torch.where(fire, t.lengths, lens)
            valid = torch.where(fire, t.validity, valid)
        decided = decided | fire
    if el is not None:
        data = torch.where(decided[:, None], data, el.widened(w_max))
        lens = torch.where(decided, lens, el.lengths)
        valid = torch.where(decided, valid, el.validity)
    return string_col(out_dtype, data, lens, valid)


def _eval_in_list(e: E.InList, ctx: EvalCtx) -> DeviceColumn:
    """SQL IN: true on a match; with no match, null when the list holds a
    null, else false (NOT IN negates, null stays null)."""
    c = evaluate(e.child, ctx)
    hit = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    null_in_list = torch.zeros_like(hit)
    for v in e.values:
        if isinstance(c, DeviceStringColumn):
            if _null_literal(v):
                null_in_list = torch.ones_like(hit)
                continue
            lv = operand(v, ctx)
            hit = hit | (string_eq(c, lv) & lv.validity)
        else:
            lv = evaluate(v, ctx)
            t = promote(c.dtype, lv.dtype)
            hit = hit | (compare("==", _as(c, t), _as(lv, t), t) &
                         lv.validity)
        null_in_list = null_in_list | ~lv.validity
    data = ~hit if e.negated else hit
    return flat(DataType.bool_(), data, c.validity & (hit | ~null_in_list))


_DISPATCH: Dict[str, Callable[..., Column]] = {
    "column": _eval_column,
    "literal": _eval_literal,
    "binary": _eval_binary,
    "is_null": _eval_is_null,
    "is_not_null": _eval_is_not_null,
    "not": _eval_not,
    "negative": _eval_negative,
    "cast": _eval_cast,
    "try_cast": _eval_cast,
    "case": _eval_case,
    "in_list": _eval_in_list,
    "sc_and": _eval_sc,
    "sc_or": _eval_sc,
    "scalar_function": lambda e, ctx: F.eval_scalar_function(
        e, [evaluate(a, ctx) for a in e.args], ctx.ones()),
}


def _null_literal(x: E.Expr) -> bool:
    return x.kind == "literal" and x.value is None


def _operands(e: E.Expr) -> tuple:
    if e.kind in ("column", "literal"):
        return ()
    if e.kind in ("binary", "sc_and", "sc_or"):
        return (e.left, e.right)
    if e.kind == "in_list":
        return (e.child,) + tuple(e.values)
    if e.kind == "scalar_function":
        return tuple(e.args)
    return (e.child,)


def _string_operands_ok(e: E.Expr, schema: Schema) -> bool:
    """The kinds that take string operands: a comparison of two strings,
    IN over a string with string or null values, `coalesce`/`nvl` of
    strings or nulls."""
    ts = [infer_type(x, schema) for x in _operands(e)]
    if e.kind == "binary":
        return e.op in CMP_OPS and all(t.is_stringlike for t in ts)
    if e.kind == "in_list":
        return ts[0].is_stringlike and all(
            t.is_stringlike or _null_literal(v)
            for t, v in zip(ts[1:], e.values))
    if e.kind == "scalar_function":
        return e.name in F.STRING_FUNCTIONS and all(
            t.is_stringlike or _null_literal(a) for t, a in zip(ts, e.args))
    return e.kind in ("is_null", "is_not_null")


def check_string_operands(e: E.Expr, schema: Schema) -> None:
    """Raise NotImplementedError for a kind that would read a string
    operand as flat values (the kinds of `_string_operands_ok` take
    them, and a string CASE takes string or null-literal values), and
    for a scalar function the port has not (`functions.check_function`)."""
    if e.kind == "case":
        values = [br.then for br in e.branches] + \
            ([e.else_expr] if e.else_expr is not None else [])
        string_case = infer_type(e, schema).is_stringlike
        for x in [br.when for br in e.branches] + values:
            check_string_operands(x, schema)
        for br in e.branches:
            t = infer_type(br.when, schema)
            if t.is_stringlike:
                raise NotImplementedError(
                    f"expression 'case' over {t!r} is not in "
                    f"auron_tpu_torch yet")
        for x in values:
            t = infer_type(x, schema)
            if string_case and not t.is_stringlike and not _null_literal(x):
                raise NotImplementedError(
                    f"a string CASE with a {t!r} branch is not in "
                    f"auron_tpu_torch yet")
        return
    if e.kind == "scalar_function":
        F.check_function(e)
    ops = _operands(e)
    for x in ops:
        check_string_operands(x, schema)
    strings = [t for t in (infer_type(x, schema) for x in ops)
               if t.is_stringlike]
    if strings and not _string_operands_ok(e, schema):
        kind = f"binary {e.op}" if e.kind == "binary" else e.kind
        raise NotImplementedError(
            f"expression {kind!r} over {strings[0]!r} is not in "
            f"auron_tpu_torch yet")


class CompiledExprs:
    """A fixed expression list over one input schema."""

    def __init__(self, exprs, schema: Schema):
        self.exprs = tuple(exprs)
        self.schema = schema
        self.out_types = [infer_type(x, schema) for x in self.exprs]
        for x in self.exprs:
            check_string_operands(x, schema)
        self._literals: Dict[tuple, DeviceStringColumn] = {}

    def __call__(self, batch: Batch) -> List[Column]:
        ctx = EvalCtx(batch.columns, self.schema, batch.capacity,
                      batch.device, self._literals)
        return [evaluate(x, ctx) for x in self.exprs]


def build_evaluator(exprs, schema: Schema) -> CompiledExprs:
    return CompiledExprs(exprs, schema)


def build_predicate(predicates, schema: Schema) -> CompiledExprs:
    """The conjunction of predicates as one boolean expression."""
    pred = predicates[0]
    for p in predicates[1:]:
        pred = E.ScAnd(left=pred, right=p)
    return CompiledExprs((pred,), schema)
