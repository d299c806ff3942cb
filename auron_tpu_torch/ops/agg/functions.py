"""Aggregate function state machines (counterpart of
auron_tpu/ops/agg/functions.py): Sum, Count and Average.

Each spec defines
- state_fields: the partial-state schema a `partial` agg emits;
- update_segments(cols, seg, n): input values -> n state rows;
- merge_segments(states, seg, n): partial states -> n state rows;
- eval_final(states): states -> result column.
`seg` holds each row's segment id in [0, n).  Reductions are
`segments.sorted_segment_sum` (an `index_add_` over the segment ids: on
the card its float additions land in no fixed order, so float sums match
other engines to a tolerance, not bit for bit).  Spark null semantics:
Sum of only nulls is null; Count counts non-null values and is never
null; Average is sum / count over the non-null values, null where there
are none.
"""

from __future__ import annotations

from typing import List

import torch

from auron_tpu_torch.columnar.batch import DeviceColumn, flat
from auron_tpu_torch.ir.schema import DataType, Field
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


class SumSpec(AggSpec):
    def state_fields(self):
        return [Field(f"{self.name}#sum", self.out_dtype)]

    def _sum(self, c: DeviceColumn, seg, n):
        x = c.data.to(self.out_dtype.torch_dtype())
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
    """avg(expr) over (sum float64, count int64) states; the decimal
    branch of the JAX package waits for decimal columns."""

    def state_fields(self):
        return [Field(f"{self.name}#sum", DataType.float64()),
                Field(f"{self.name}#count", DataType.int64(),
                      nullable=False)]

    def _states(self, x, valid, counts, seg, n):
        s = _seg_sum(torch.where(valid, x, torch.zeros_like(x)), seg, n)
        cnt = _seg_sum(counts, seg, n)
        return [DeviceColumn(DataType.float64(), s, cnt > 0),
                DeviceColumn(DataType.int64(), cnt,
                             torch.ones(n, dtype=torch.bool,
                                        device=seg.device))]

    def update_segments(self, cols, seg, n):
        c = cols[0]
        return self._states(c.data.to(torch.float64), c.validity,
                            c.validity.to(torch.int64), seg, n)

    def merge_segments(self, states, seg, n):
        s, c = states
        return self._states(s.data, s.validity,
                            torch.where(c.validity, c.data,
                                        torch.zeros_like(c.data)), seg, n)

    def eval_final(self, states):
        s, cnt = states
        avg = s.data / torch.clamp(cnt.data, min=1)
        return flat(DataType.float64(), avg, cnt.data > 0)


def make_spec(fn: str, out_dtype: DataType, name: str) -> AggSpec:
    if fn == "sum" and (out_dtype.is_integral or out_dtype.is_floating):
        return SumSpec(fn, out_dtype, name)
    if fn == "count":
        return CountSpec(fn, DataType.int64(), name)
    if fn == "avg" and out_dtype.is_floating:
        return AvgSpec(fn, DataType.float64(), name)
    raise NotImplementedError(
        f"aggregate {fn!r} -> {out_dtype!r} is not in auron_tpu_torch yet")
