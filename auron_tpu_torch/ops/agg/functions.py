"""Aggregate function state machines (counterpart of
auron_tpu/ops/agg/functions.py): Sum, Count, Min, Max, Average,
StddevSamp / VarianceSamp, First and FirstIgnoresNull.

Each spec defines
- state_fields: the partial-state schema a `partial` agg emits;
- update_segments(cols, seg, n): input values -> n state rows;
- merge_segments(states, seg, n): partial states -> n state rows;
- eval_final(states): states -> result column.
`seg` holds each row's segment id in [0, n), ascending, rows of a
segment in input order.  Reductions are ops/segments.py's (an
`index_add_` or `scatter_reduce_` over the segment ids: on the card
float additions land in no fixed order, so float sums match other
engines to a tolerance, not bit for bit).  Spark null semantics: Sum,
Min and Max of only nulls are null; Count counts non-null values and is
never null; Average is sum / count over the non-null values, null where
there are none; the sample variance is null over no row and NaN over
one (the JAX package's choice; Spark gives NaN there only under
spark.sql.legacy.statisticalAggregate, else null); First takes the segment's first row (its value may be null),
FirstIgnoresNull its first non-null row.  Every state keeps zeros under
its nulls (the invariant of columnar/batch.py): a later stage that
groups by a result column finds one null group.
Decimal(p <= 18) and float32 (the JAX package's specs over both): a
decimal sum keeps the int64 unscaled sum as its state, and its result
is null past the result type's precision (Spark's non-ANSI sum; the
JAX package's state wraps, ROADMAP Queue 3); a decimal average keeps
(unscaled sum at the input's scale, count) and rounds sum / count half
up at the result's scale, Spark's decimal(p + 4, s + 4); a float
result (the sum, average or deviation of a float32) sums float64
values, a decimal's by its value; Min, Max and First keep the input
type.  The state names and types are the JAX package's, which are also
the converter's wire.
"""

from __future__ import annotations

from typing import List

import torch

from auron_tpu_torch.columnar.batch import DeviceColumn, flat
from auron_tpu_torch.exprs.cast import fits_digits, numeric_data
from auron_tpu_torch.ir.schema import DataType, Field, is_flat_type
from auron_tpu_torch.ops.segments import sorted_segment_max as _seg_max
from auron_tpu_torch.ops.segments import sorted_segment_min as _seg_min
from auron_tpu_torch.ops.segments import sorted_segment_sum as _seg_sum


class AggSpec:
    def __init__(self, fn: str, out_dtype: DataType, name: str):
        self.fn = fn
        self.out_dtype = out_dtype
        self.name = name

    def state_fields(self) -> List[Field]:
        raise NotImplementedError

    def update_segments(self, cols: List[DeviceColumn], seg: torch.Tensor,
                        n: int) -> List[DeviceColumn]:
        raise NotImplementedError

    def merge_segments(self, states: List[DeviceColumn], seg: torch.Tensor,
                       n: int) -> List[DeviceColumn]:
        raise NotImplementedError

    def eval_final(self, states: List[DeviceColumn]) -> DeviceColumn:
        return flat(self.out_dtype, states[0].data, states[0].validity)


def decimal_average(s: torch.Tensor, cnt: torch.Tensor, in_scale: int,
                    out_dtype: DataType) -> DeviceColumn:
    """Unscaled sums at `in_scale` over counts, as `out_dtype`: sum * 10^k
    / count (k = its scale - in_scale), rounded half up on the magnitude
    as the JAX package's; the quotient's whole part is taken first, so
    no product of the sum and 10^k forms.  Null where the count is 0 or
    the average passes the precision."""
    k = out_dtype.scale - in_scale
    c = torch.clamp(cnt, min=1)
    mag = torch.abs(s)
    if k >= 0:
        q1 = torch.div(mag, c, rounding_mode="floor")
        r = (mag - q1 * c) * 10 ** k
        q2 = torch.div(r, c, rounding_mode="floor")
        q = q1 * 10 ** k + q2 + (2 * (r - q2 * c) >= c).to(s.dtype)
    else:
        div = c * 10 ** -k
        q = torch.div(mag, div, rounding_mode="floor")
        q = q + (2 * (mag - q * div) >= div).to(s.dtype)
    q = torch.sign(s) * q
    return flat(out_dtype, q,
                (cnt > 0) & fits_digits(q, out_dtype.precision))


class SumSpec(AggSpec):
    def state_fields(self):
        return [Field(f"{self.name}#sum", self.out_dtype)]

    def eval_final(self, states):
        s = states[0]
        valid = s.validity
        if self.out_dtype.is_decimal:
            valid = valid & fits_digits(s.data, self.out_dtype.precision)
        return flat(self.out_dtype, s.data, valid)

    def _sum(self, c: DeviceColumn, seg, n):
        x = numeric_data(c, self.out_dtype)
        s = _seg_sum(torch.where(c.validity, x, torch.zeros_like(x)), seg, n)
        has = _seg_sum(c.validity.to(torch.int64), seg, n) > 0
        return [DeviceColumn(self.out_dtype, s, has)]

    def update_segments(self, cols, seg, n):
        return self._sum(cols[0], seg, n)

    def merge_segments(self, states, seg, n):
        return self._sum(states[0], seg, n)


class CountSpec(AggSpec):
    """count(expr) counts non-null values; count(*) (no children) rows."""

    def state_fields(self):
        return [Field(f"{self.name}#count", DataType.int64(), nullable=False)]

    def _counted(self, ones: torch.Tensor, seg, n):
        return [DeviceColumn(DataType.int64(), _seg_sum(ones, seg, n),
                             torch.ones(n, dtype=torch.bool,
                                        device=seg.device))]

    def update_segments(self, cols, seg, n):
        ones = cols[0].validity.to(torch.int64) if cols else \
            torch.ones(seg.shape[0], dtype=torch.int64, device=seg.device)
        return self._counted(ones, seg, n)

    def merge_segments(self, states, seg, n):
        c = states[0]
        return self._counted(torch.where(c.validity, c.data,
                                         torch.zeros_like(c.data)), seg, n)


class AvgSpec(AggSpec):
    """avg(expr) over (sum, count int64) states: the sum float64, or for
    a decimal result the input's unscaled int64 sum, typed as the
    input's decimal (`sum_dtype`, the JAX package's state field)."""

    def __init__(self, fn: str, out_dtype: DataType, name: str,
                 sum_dtype: DataType):
        super().__init__(fn, out_dtype, name)
        self.sum_dtype = sum_dtype

    def state_fields(self):
        return [Field(f"{self.name}#sum", self.sum_dtype),
                Field(f"{self.name}#count", DataType.int64(),
                      nullable=False)]

    def _states(self, x, valid, counts, seg, n):
        s = _seg_sum(torch.where(valid, x, torch.zeros_like(x)), seg, n)
        cnt = _seg_sum(counts, seg, n)
        return [DeviceColumn(self.sum_dtype, s, cnt > 0),
                DeviceColumn(DataType.int64(), cnt,
                             torch.ones(n, dtype=torch.bool,
                                        device=seg.device))]

    def update_segments(self, cols, seg, n):
        c = cols[0]
        return self._states(numeric_data(c, self.sum_dtype), c.validity,
                            c.validity.to(torch.int64), seg, n)

    def merge_segments(self, states, seg, n):
        s, c = states
        return self._states(s.data, s.validity,
                            torch.where(c.validity, c.data,
                                        torch.zeros_like(c.data)), seg, n)

    def eval_final(self, states):
        s, cnt = states
        if self.sum_dtype.is_decimal:
            return decimal_average(s.data, cnt.data, self.sum_dtype.scale,
                                   self.out_dtype)
        avg = s.data / torch.clamp(cnt.data, min=1)
        return flat(DataType.float64(), avg, cnt.data > 0)


class MinMaxSpec(AggSpec):
    """min / max in the output type, over Spark's order (float64 NaN the
    greatest, -0.0 equal to 0.0: ops/segments.py).  Null rows go to a
    segment of their own past the last, so they take no part."""

    def state_fields(self):
        return [Field(f"{self.name}#{self.fn}", self.out_dtype)]

    def _reduce(self, c: DeviceColumn, seg, n):
        x = c.data.to(self.out_dtype.torch_dtype())
        red = (_seg_min if self.fn == "min" else _seg_max)(
            x, torch.where(c.validity, seg, n), n + 1)[:n]
        has = _seg_sum(c.validity.to(torch.int64), seg, n) > 0
        return [flat(self.out_dtype, red, has)]

    def update_segments(self, cols, seg, n):
        return self._reduce(cols[0], seg, n)

    def merge_segments(self, states, seg, n):
        return self._reduce(states[0], seg, n)


class StddevSpec(AggSpec):
    """stddev_samp / var_samp over the power-sum states (sum, sum of
    squares, count), merge-associative like the JAX package's."""

    def state_fields(self):
        return [Field(f"{self.name}#sum", DataType.float64()),
                Field(f"{self.name}#sumsq", DataType.float64()),
                Field(f"{self.name}#count", DataType.int64(),
                      nullable=False)]

    def _states(self, x, vx, x2, vx2, counts, seg, n):
        zero = torch.zeros((), dtype=torch.float64, device=seg.device)
        s = _seg_sum(torch.where(vx, x, zero), seg, n)
        s2 = _seg_sum(torch.where(vx2, x2, zero), seg, n)
        cnt = _seg_sum(counts, seg, n)
        return [DeviceColumn(DataType.float64(), s, cnt > 0),
                DeviceColumn(DataType.float64(), s2, cnt > 0),
                DeviceColumn(DataType.int64(), cnt,
                             torch.ones(n, dtype=torch.bool,
                                        device=seg.device))]

    def update_segments(self, cols, seg, n):
        c = cols[0]
        x = numeric_data(c, DataType.float64())
        return self._states(x, c.validity, x * x, c.validity,
                            c.validity.to(torch.int64), seg, n)

    def merge_segments(self, states, seg, n):
        s, s2, c = states
        return self._states(s.data, s.validity, s2.data, s2.validity,
                            torch.where(c.validity, c.data,
                                        torch.zeros_like(c.data)), seg, n)

    def eval_final(self, states):
        s, s2, cnt = states
        nf = cnt.data.to(torch.float64)
        # (sum_sq - sum^2 / n) / (n - 1), clamped at 0 against the
        # cancellation of near-constant groups, in the JAX package's order
        var = (s2.data - s.data * s.data / torch.clamp(nf, min=1.0)) / \
            torch.clamp(nf - 1.0, min=1.0)
        var = torch.clamp(var, min=0.0)
        out = torch.sqrt(var) if self.fn == "stddev_samp" else var
        out = torch.where(cnt.data == 1, float("nan"), out)
        return flat(DataType.float64(), out, cnt.data > 0)


# a row index no segment reaches: FirstIgnoresNull's stand-in for a null
_NO_ROW = 1 << 62


class FirstSpec(AggSpec):
    """first / first_ignores_null: the value at the segment's first row
    (first non-null row), in the rows' order, which the stable grouping
    sort keeps."""

    def state_fields(self):
        return [Field(f"{self.name}#first", self.out_dtype)]

    def _take(self, c: DeviceColumn, seg, n):
        rows = int(c.data.shape[0])
        idx = torch.arange(rows, dtype=torch.int64, device=seg.device)
        if self.fn == "first_ignores_null":
            idx = torch.where(c.validity, idx, _NO_ROW)
        first = _seg_min(idx, seg, n)      # empty: int64's maximum
        has = first < rows
        src = torch.clamp(first, max=max(rows - 1, 0))
        return [flat(self.out_dtype, c.data[src],
                     has & c.validity[src])]

    def update_segments(self, cols, seg, n):
        return self._take(cols[0], seg, n)

    def merge_segments(self, states, seg, n):
        return self._take(states[0], seg, n)


def make_spec(fn: str, out_dtype: DataType, name: str,
              sum_dtype: DataType = DataType.float64()) -> AggSpec:
    """The spec of aggregate `fn` with result type `out_dtype` (the JAX
    package's dispatch, for the flat device types the port holds).  Min,
    Max and First return their input's type; an input the port cannot
    hold already fails where its expression is built.  `sum_dtype` is a
    decimal average's input type, whose scale its sum state keeps."""
    flat_out = is_flat_type(out_dtype)
    if fn == "sum" and flat_out and (out_dtype.is_integral or
                                     out_dtype.is_floating or
                                     out_dtype.is_decimal):
        return SumSpec(fn, out_dtype, name)
    if fn == "count":
        return CountSpec(fn, DataType.int64(), name)
    if fn in ("min", "max") and flat_out:
        return MinMaxSpec(fn, out_dtype, name)
    if fn == "avg" and out_dtype.is_floating:
        return AvgSpec(fn, DataType.float64(), name, DataType.float64())
    if fn == "avg" and flat_out and out_dtype.is_decimal and \
            sum_dtype.is_decimal:
        return AvgSpec(fn, out_dtype, name, sum_dtype)
    if fn in ("stddev_samp", "var_samp") and out_dtype.is_floating:
        return StddevSpec(fn, DataType.float64(), name)
    if fn in ("first", "first_ignores_null") and flat_out:
        return FirstSpec(fn, out_dtype, name)
    raise NotImplementedError(
        f"aggregate {fn!r} -> {out_dtype!r} is not in auron_tpu_torch yet")
