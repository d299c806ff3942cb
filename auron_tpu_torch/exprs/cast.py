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
  timestamp_us to date32 floor-divides by them.
`try_cast` (Spark's `TryCast`, the ANSI cast with errors as null): a
float that is NaN or whose floor/ceil leaves the target's range, and an
integral value outside a narrower target's range, give null; the rest
casts as above.  Decimal and string casts, and casts between a date or
timestamp and a number, raise NotImplementedError: the port has no
device layout for decimal or string columns yet.
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


def cast_column(col: DeviceColumn, dst: DataType, try_: bool = False
                ) -> DeviceColumn:
    src = col.dtype
    if src.id == dst.id:
        return col
    for t in (src, dst):
        if t.is_decimal or t.id in (TypeId.STRING, TypeId.BINARY):
            raise NotImplementedError(
                f"cast {src!r} -> {dst!r} is not in auron_tpu_torch yet")
    data, valid = col.data, col.validity
    if (src.id in _TEMPORAL) != (dst.id in _TEMPORAL):
        raise NotImplementedError(
            f"cast {src!r} -> {dst!r} is not in auron_tpu_torch yet")
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
