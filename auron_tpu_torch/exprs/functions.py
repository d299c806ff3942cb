"""Scalar functions on torch tensors (counterpart of
auron_tpu/exprs/functions_device.py).

The registry holds the functions the TPC-DS corpus calls, and the
decimal functions of Spark's decimal arithmetic:
- `round(x, scale)`, half-up (the JAX package's `_round`): an integral
  column at a negative scale rounds its magnitude at 10^-scale, away
  from zero on a tie, and is unchanged at scale >= 0; a decimal rounds
  its unscaled value at 10^(its scale - scale) (`rescale_half_up`); a
  float64 or float32 column is `round_half_up(x * 10^scale) / 10^scale`
  in float64 (`data_round_half_up` of exprs/cast.py), in its own type.
  Where the plan gives a decimal return type (Spark's
  decimal(p - s + scale + 1, scale)), the rounded decimal is rescaled to
  it; the JAX package keeps the argument's type and scale under that
  declared type, which reads its unscaled value at the wrong scale
  (ROADMAP Queue 3).
- `check_overflow(x)` (Spark's `CheckOverflow`): x cast to the return
  type, null past its precision (exprs/cast.py: a float64 product of
  decimals rounds half up to the decimal);
- `make_decimal(x)`: int64 x as the unscaled value of the return type
  (decimal(18, 0) without one), null past its precision;
- `unscaled_value(x)`: a decimal's int64 unscaled value;
- `normalize_nan_and_zero(x)`: a float's -0.0 as 0.0 and every NaN as
  the positive quiet NaN (Spark's `NormalizeNaNAndZero`); any other type
  passes through.
- `coalesce` and its alias `nvl`: the first non-null argument of each
  row, over flat columns and over strings (padded to the widest
  argument).
Any other name raises NotImplementedError naming the function where the
expression is built (`check_function`); the rest of the JAX package's
registry is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from auron_tpu_torch.columnar.batch import Column, flat, string_col
from auron_tpu_torch.exprs.cast import (
    cast_column, data_round_half_up, fits_digits, rescale_half_up,
)
from auron_tpu_torch.exprs.strings import _pad_width
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir.schema import DataType, TypeId


def _literal_int(x: E.Expr, default: int) -> int:
    return int(x.value) if x.kind == "literal" and x.value is not None \
        else default


def _round(e: E.ScalarFunctionCall, args: List[Column], ones) -> Column:
    c = args[0]
    scale = _literal_int(e.args[1], 0) if len(e.args) > 1 else 0
    if c.dtype.is_decimal:
        shift = c.dtype.scale - scale
        if shift > 0:
            m = 10 ** shift
            c = flat(c.dtype, rescale_half_up(c.data, m) * m, c.validity)
        rt = e.return_type
        return cast_column(c, rt) if rt.is_decimal else c
    if c.dtype.is_integral:
        if scale >= 0:
            return c
        m = 10 ** (-scale)
        a = torch.abs(c.data)
        q = torch.div(a, m, rounding_mode="floor")
        q = q + ((a - q * m) >= m // 2).to(q.dtype)
        return flat(c.dtype, torch.sign(c.data) * q * m, c.validity)
    m = 10.0 ** scale
    x = c.data.to(torch.float64)
    # divided by a tensor: CUDA divides a tensor by a Python number as a
    # multiply by its reciprocal, an ulp off the CPU's correctly rounded
    # quotient on some rows
    div = torch.tensor(m, dtype=torch.float64, device=x.device)
    return flat(c.dtype, (data_round_half_up(x * m) / div).to(c.data.dtype),
                c.validity)


def _out_type(e: E.ScalarFunctionCall, args: List[Column]) -> DataType:
    if e.return_type.id != TypeId.NULL:
        return e.return_type
    return next((a.dtype for a, x in zip(args, e.args)
                 if not _is_null_literal(x)), DataType.bool_())


def _is_null_literal(x: E.Expr) -> bool:
    return x.kind == "literal" and x.value is None


def _coalesce(e: E.ScalarFunctionCall, args: List[Column], ones) -> Column:
    dt = _out_type(e, args)
    # a null literal never supplies a value
    vals = [a for a, x in zip(args, e.args) if not _is_null_literal(x)]
    if dt.is_stringlike:
        if not vals:
            raise NotImplementedError(
                "coalesce of null literals only is not in auron_tpu_torch")
        w = max(a.width for a in vals)
        out = vals[0]
        data, lens, valid = _pad_width(out.data, w), out.lengths, \
            out.validity
        for a in vals[1:]:
            use = ~valid & a.validity
            data = torch.where(use[:, None], _pad_width(a.data, w), data)
            lens = torch.where(use, a.lengths, lens)
            valid = valid | a.validity
        return string_col(dt, data, lens, valid)
    tdt = dt.torch_dtype()
    if not vals:
        return flat(dt, torch.zeros_like(ones, dtype=tdt), ~ones)
    data, valid = vals[0].data.to(tdt), vals[0].validity
    for a in vals[1:]:
        use = ~valid & a.validity
        data = torch.where(use, a.data.to(tdt), data)
        valid = valid | a.validity
    return flat(dt, data, valid)


def _check_overflow(e: E.ScalarFunctionCall, args: List[Column], ones
                    ) -> Column:
    c = args[0]
    return cast_column(c, e.return_type if e.return_type.is_decimal
                       else c.dtype)


def _make_decimal(e: E.ScalarFunctionCall, args: List[Column], ones
                  ) -> Column:
    c = args[0]
    dst = e.return_type if e.return_type.is_decimal else \
        DataType.decimal(18, 0)
    x = c.data.to(torch.int64)
    return flat(dst, x, c.validity & fits_digits(x, dst.precision))


def _unscaled_value(e: E.ScalarFunctionCall, args: List[Column], ones
                    ) -> Column:
    c = args[0]
    return flat(DataType.int64(), c.data.to(torch.int64), c.validity)


def _normalize_nan_and_zero(e: E.ScalarFunctionCall, args: List[Column],
                            ones) -> Column:
    c = args[0]
    if not c.dtype.is_floating:
        return c
    x = torch.where(c.data == 0, 0.0, c.data)
    return flat(c.dtype, torch.where(torch.isnan(x), float("nan"), x),
                c.validity)


_FUNCS: Dict[str, Callable[..., Column]] = {
    "round": _round,
    "check_overflow": _check_overflow,
    "make_decimal": _make_decimal,
    "unscaled_value": _unscaled_value,
    "normalize_nan_and_zero": _normalize_nan_and_zero,
    "coalesce": _coalesce,
    "nvl": _coalesce,
}

# the functions that take string arguments
STRING_FUNCTIONS = frozenset({"coalesce", "nvl"})


def check_function(e: E.ScalarFunctionCall) -> None:
    if e.name not in _FUNCS:
        raise NotImplementedError(
            f"scalar function {e.name!r} is not in auron_tpu_torch yet")


def eval_scalar_function(e: E.ScalarFunctionCall, args: List[Column],
                         ones: torch.Tensor) -> Column:
    """The function's column from its evaluated arguments; `ones` is an
    all-true row mask of the batch capacity."""
    check_function(e)
    return _FUNCS[e.name](e, args, ones)
