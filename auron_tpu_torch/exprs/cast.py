"""Spark-semantics casts on torch tensors (counterpart of
auron_tpu/exprs/cast.py `cast_column`).

Non-ANSI Spark (`Cast`):
- to bool: a number is true unless it is 0 (NaN is true);
- to float64: the value;
- float to int32/int64 truncates toward zero and saturates at the type's
  bounds, NaN gives 0; float to int8/int16 goes through int32 and then
  wraps, as Spark's `castToByte`/`castToShort` compute
  `toInt(x).toByte` (the JAX package saturates at the byte's own bounds,
  ROADMAP Queue 3);
- integral narrowing wraps (Java), widening and bool to int convert;
- date32 to timestamp_us multiplies by the microseconds of a day,
  timestamp_us to date32 floor-divides by them;
- a decimal (the int64 unscaled value) to a decimal rescales: up by a
  power of ten, down rounding half up (`rescale_half_up`); to an
  integral type it truncates toward zero and then wraps as Java's
  `toLong.toInt` does (Spark's `Decimal.toInt`); to a float it is
  `unscaled / 10^scale`, correctly rounded in float64; to bool, not 0;
- an integral or bool value to a decimal is the value times 10^scale;
- a float to a decimal rounds, half up, the double's shortest decimal
  text (Spark's `Decimal(double)` through `Double.toString`), not the
  binary value: `cast(1.005 as decimal(3,2))` is 1.01 (`_float_to_unscaled`;
  a float32 widens to float64 first, as Spark's `toDouble`);
- a decimal result past its precision, and a NaN or infinite float cast
  to a decimal, give null (`CheckOverflow`, non-ANSI).
`try_cast` (Spark's `TryCast`, the ANSI cast with errors as null): a
float that is NaN or whose floor/ceil leaves the target's range, and an
integral or decimal value outside a narrower target's range, give null;
the rest casts as above.  Casts between a number and a string format or
parse text on the host in the JAX package (ROADMAP Queue 1 item 11), and
casts between a date or timestamp and a number, raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import DeviceColumn, flat
from auron_tpu_torch.ir.schema import DataType, TypeId

US_PER_DAY = 86_400_000_000

_INT_BOUNDS = {
    TypeId.INT8: (-2**7, 2**7 - 1),
    TypeId.INT16: (-2**15, 2**15 - 1),
    TypeId.INT32: (-2**31, 2**31 - 1),
    TypeId.INT64: (-2**63, 2**63 - 1),
}
_TEMPORAL = (TypeId.DATE32, TypeId.TIMESTAMP_US)


def _float_to_int(x: torch.Tensor, dst: TypeId) -> torch.Tensor:
    """Java's (int)/(long) of a double: truncate, saturate, NaN -> 0; to
    int8/int16 through int32, then wrap."""
    wide = dst if dst == TypeId.INT64 else TypeId.INT32
    lo, hi = _INT_BOUNDS[wide]
    tdt = torch.int64 if wide == TypeId.INT64 else torch.int32
    x = torch.where(torch.isnan(x), 0.0, x)
    # compare before converting: float(2^63 - 1) rounds up to 2^63
    big, small = x >= float(hi), x <= float(lo)
    out = torch.trunc(torch.where(big | small, 0.0, x)).to(tdt)
    out = torch.where(big, hi, torch.where(small, lo, out))
    return out


def data_round_half_up(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def rescale_half_up(x: torch.Tensor, div: int) -> torch.Tensor:
    """Unscaled int64 values divided by `div` (a power of ten), rounded
    half up on the magnitude (half away from zero)."""
    mag = torch.abs(x)
    q = torch.div(mag, div, rounding_mode="floor")
    q = q + (2 * (mag - q * div) >= div).to(q.dtype)
    return torch.sign(x) * q


def decimal_to_float64(col: DeviceColumn) -> torch.Tensor:
    """A decimal column's values as float64: unscaled / 10^scale, one
    correctly rounded division (a tensor divisor: CUDA divides by a
    Python number as a multiply by its reciprocal)."""
    div = torch.tensor(10.0 ** col.dtype.scale, dtype=torch.float64,
                       device=col.data.device)
    return col.data.to(torch.float64) / div


def fits_digits(x: torch.Tensor, digits: int) -> torch.Tensor:
    """|x| < 10^digits, exactly (no product that could wrap)."""
    if digits < 0:
        return torch.zeros_like(x, dtype=torch.bool)
    if digits > 18:
        return torch.ones_like(x, dtype=torch.bool)
    bound = 10 ** digits
    return (x > -bound) & (x < bound)


def _float_to_unscaled(x: torch.Tensor, scale: int):
    """(unscaled int64, finite) of floats cast to a decimal at `scale`:
    Spark's HALF_UP rounding of the double's shortest decimal text.  The
    float product x * 10^scale rounds to t; the text rounds otherwise
    only where x is the double nearest to a rounding boundary
    (|t| +- 1/2) / 10^scale, which is then the shortest text of x.  That
    double is one correctly rounded division, (2|t| +- 1) / (2 * 10^s)
    with both operands exact, so |t| moves by one where |x| reaches the
    upper boundary's double, or falls below the lower one's.  Past
    |t| = 2^51 a double's shortest text may not be that boundary, and
    the product's rounding stands."""
    x = x.to(torch.float64)
    ok = torch.isfinite(x)
    x = torch.where(ok, x, 0.0)
    t = data_round_half_up(x * (10.0 ** scale))
    at, ax = torch.abs(t), torch.abs(x)
    two_m = torch.tensor(2.0 * 10.0 ** scale, dtype=torch.float64,
                         device=x.device)
    near = at < 2.0 ** 51
    up = near & (ax >= (2 * at + 1) / two_m)
    down = near & (at > 0) & (ax < (2 * at - 1) / two_m)
    at = at + up.to(at.dtype) - down.to(at.dtype)
    # an int64 holds every |t| below 2^63; past 10^18 is an overflow
    ok = ok & (at < 1e18)
    at = torch.where(ok, at, 0.0)
    return (torch.sign(x) * at).to(torch.int64), ok


def _to_decimal(col: DeviceColumn, dst: DataType) -> DeviceColumn:
    src, data, valid = col.dtype, col.data, col.validity
    p, s = dst.precision, dst.scale
    if src.is_decimal:
        shift = s - src.scale
        if shift >= 0:
            ok = fits_digits(data, p - shift)
            out = torch.where(ok, data, 0) * 10 ** shift
        else:
            out = rescale_half_up(data, 10 ** -shift)
            ok = fits_digits(out, p)
    elif src.is_floating:
        out, ok = _float_to_unscaled(data, s)
        ok = ok & fits_digits(out, p)
    elif src.is_integral or src.id == TypeId.BOOL:
        x = data.to(torch.int64)
        ok = fits_digits(x, p - s)
        out = torch.where(ok, x, 0) * 10 ** s
    else:
        raise NotImplementedError(
            f"cast {src!r} -> {dst!r} is not in auron_tpu_torch yet")
    return flat(dst, out, valid & ok)


def _from_decimal(col: DeviceColumn, dst: DataType, try_: bool
                  ) -> DeviceColumn:
    data, valid = col.data, col.validity
    if dst.id == TypeId.BOOL:
        return flat(dst, data != 0, valid)
    if dst.is_floating:
        return flat(dst, decimal_to_float64(col).to(dst.torch_dtype()),
                    valid)
    if not dst.is_integral:
        raise NotImplementedError(
            f"cast {col.dtype!r} -> {dst!r} is not in auron_tpu_torch yet")
    # truncate toward zero, exactly, then wrap (Java's toLong.toInt)
    m = 10 ** col.dtype.scale
    whole = torch.sign(data) * torch.div(torch.abs(data), m,
                                         rounding_mode="floor")
    if try_:
        lo, hi = _INT_BOUNDS[dst.id]
        valid = valid & (whole >= lo) & (whole <= hi)
    return flat(dst, whole.to(dst.torch_dtype()), valid)


def numeric_data(col: DeviceColumn, t: DataType) -> torch.Tensor:
    """A column's data in the representation of the numeric type t, with
    no Spark cast semantics (the JAX package's `_to_numeric`, for
    promotions whose values are in range): a decimal to a non-decimal
    through its float64 value; to a decimal of the same scale as it is;
    anything else to a decimal through `cast_column` (an overflow reads
    as 0)."""
    src = col.dtype
    if src.is_decimal and not t.is_decimal:
        return decimal_to_float64(col).to(t.torch_dtype())
    if t.is_decimal and not (src.is_decimal and src.scale == t.scale):
        return cast_column(col, t).data
    return col.data.to(t.torch_dtype())


def cast_column(col: DeviceColumn, dst: DataType, try_: bool = False
                ) -> DeviceColumn:
    src = col.dtype
    if src == dst:
        return col
    for t in (src, dst):
        if t.id in (TypeId.STRING, TypeId.BINARY):
            raise NotImplementedError(
                f"cast {src!r} -> {dst!r} formats or parses text on the "
                f"host in the JAX package; host casts are not in "
                f"auron_tpu_torch yet (ROADMAP Queue 1 item 11)")
    data, valid = col.data, col.validity
    if (src.id in _TEMPORAL) != (dst.id in _TEMPORAL):
        raise NotImplementedError(
            f"cast {src!r} -> {dst!r} is not in auron_tpu_torch yet")
    if dst.is_decimal:
        return _to_decimal(col, dst)
    if src.is_decimal:
        return _from_decimal(col, dst, try_)
    tdt = dst.torch_dtype()
    if dst.id == TypeId.BOOL:
        return flat(dst, data != 0, valid)
    if dst.is_floating:
        return flat(dst, data.to(tdt), valid)
    if src.id == TypeId.DATE32 and dst.id == TypeId.TIMESTAMP_US:
        return flat(dst, data.to(torch.int64) * US_PER_DAY, valid)
    if src.id == TypeId.TIMESTAMP_US and dst.id == TypeId.DATE32:
        days = torch.div(data, US_PER_DAY, rounding_mode="floor")
        return flat(dst, days.to(torch.int32), valid)
    lo, hi = _INT_BOUNDS[dst.id]
    if src.is_floating:
        # a float32 widens exactly: Java's (int) of a float is that of
        # the double
        data = data.to(torch.float64)
        out = _float_to_int(data, dst.id).to(tdt)
        if try_:
            valid = valid & ~torch.isnan(data) & \
                (torch.floor(data) <= float(hi)) & \
                (torch.ceil(data) >= float(lo))
        return flat(dst, out, valid)
    # integral or bool source: narrowing wraps (Java), widening converts
    if try_ and src.is_integral and \
            _INT_BOUNDS[src.id][1] > hi:
        valid = valid & (data >= lo) & (data <= hi)
    return flat(dst, data.to(tdt), valid)
