"""Scalar functions on torch tensors (counterpart of
auron_tpu/exprs/functions_device.py).

The registry holds the functions the TPC-DS corpus calls:
- `round(x, scale)`, half-up (the JAX package's `_round`): an integral
  column at a negative scale rounds its magnitude at 10^-scale, away
  from zero on a tie, and is unchanged at scale >= 0; a float column is
  `round_half_up(x * 10^scale) / 10^scale` in float64
  (`data_round_half_up`, a copy of the JAX package's `exprs/cast.py`).
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
from auron_tpu_torch.exprs.strings import _pad_width
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir.schema import DataType, TypeId


def data_round_half_up(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _literal_int(x: E.Expr, default: int) -> int:
    return int(x.value) if x.kind == "literal" and x.value is not None \
        else default


def _round(e: E.ScalarFunctionCall, args: List[Column], ones) -> Column:
    c = args[0]
    scale = _literal_int(e.args[1], 0) if len(e.args) > 1 else 0
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


_FUNCS: Dict[str, Callable[..., Column]] = {
    "round": _round,
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
