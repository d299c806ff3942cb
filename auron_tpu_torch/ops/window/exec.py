"""Window operator (counterpart of auron_tpu/ops/window/exec.py).

The task's rows are sorted once by (partition_by, order_by) over the
sort-key words of ops/sort_keys.py; every function is then a segmented
scan or reduction over the sorted batch: row_number, rank, dense_rank,
percent_rank, cume_dist, lead/lag, first_value, nth_value,
nth_value_ignore_nulls, last_value, and count, sum, avg, min and max
over the window, with an optional group limit (top k rows a partition
by row_number, rank or dense_rank).  The frame is Spark's default:
RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW when there is an
order, so peers (rows of one order group) share it, and the whole
partition otherwise.

Scans: torch has no segmented associative scan, so the running minimum
and maximum, and the running float sum, are log-step (Hillis-Steele)
scans in which each row combines only with rows of its own partition:
ceil(log2(rows)) steps.  Floats order as Spark orders them (every NaN
equal and above +inf, -0.0 equal to 0.0, as ops/segments.py reduces
them).  Each partition's running float sum starts from its own first
row; the JAX package subtracts a global prefix sum at each partition's
start, which loses a small partition's digits after a large one.
Integer running sums are that prefix difference, exact (and wrapping)
as the JAX package's.

Decimal(p <= 18) and float32 values: count, sum, avg, min and max take
both.  A decimal sums its unscaled values in int64, null past the
result's precision, and its average is Spark's decimal(p + 4, s + 4),
the unscaled sum over the count rounded half up
(`ops/agg/functions.py::decimal_average`); a float32's sum and average
are float64; min and max keep the input's type, a float32 over its
ordered words as a float64 is.

Where the port keeps Spark's semantics and the JAX package does not
(ROADMAP Queue 3):
- the average of a decimal, which the JAX package divides as the
  unscaled float64 sum and returns as float64;
- the running float sum, above;
- the running min and max over NaN (the JAX package's `jnp.minimum`
  gives NaN);
- a string default of lead/lag, which the JAX package ignores;
- nth_value over Spark's frame (to the end of the current row's order
  group, or of the partition with no order; the JAX package stops at
  the current row), and nth_value_ignore_nulls, which counts only the
  non-null values.

Spill: the operator is a memory consumer.  Under pressure its staged
input is sorted by (partition, order) and spilled as a run
(memmgr/spill.py); at the end the runs merge through the sort's
`HostKeyMerger`, and each merged batch's rows below its last partition
key close their partitions, which are processed with the rows carried
from before; the last partition stays carried.  Equal keys merge in
input order, so a spilled window equals the in-memory one row for row.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, DeviceStringColumn, bucket_capacity,
    concat_batches, flat, string_col,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import EvalCtx, build_evaluator, operand
from auron_tpu_torch.exprs.strings import _pad_width
from auron_tpu_torch.ir.expr import Literal
from auron_tpu_torch.ir.plan import WindowFuncCall, WindowGroupLimit
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops import segments
from auron_tpu_torch.ops.base import (
    Operator, StagingOperator, TaskContext, compact_indices,
)
from auron_tpu_torch.ops.sort import _rechunk
from auron_tpu_torch.exprs.cast import fits_digits, numeric_data
from auron_tpu_torch.ops.agg.functions import decimal_average
from auron_tpu_torch.ops.sort_keys import (
    encode_sort_keys, encode_sort_keys_bits,
    keys_equal_prev, lexsort_indices,
)

Ctx = Dict[str, Any]


class WindowExec(StagingOperator):
    def __init__(self, child: Operator, window_funcs, partition_by,
                 order_by, group_limit: Optional[WindowGroupLimit] = None,
                 output_window_cols: bool = True):
        in_schema = child.schema
        self.window_funcs = tuple(window_funcs)
        self.partition_by = tuple(partition_by)
        self.order_by = tuple(order_by)
        self.group_limit = group_limit
        self.output_window_cols = output_window_cols
        fields = list(in_schema.fields)
        if output_window_cols:
            for wf in self.window_funcs:
                fields.append(Field(wf.name or wf.fn, _declared_type(wf)))
        StagingOperator.__init__(self, Schema(tuple(fields)), [child],
                                 "WindowExec", "window")
        for wf in self.window_funcs:
            _check_function(wf)
        self._part_eval = build_evaluator(self.partition_by, in_schema)
        self._order_eval = build_evaluator(
            tuple(s.child for s in self.order_by), in_schema)
        self._arg_evals = [build_evaluator(
            tuple(wf.args) + (wf.agg.children if wf.agg else ()), in_schema)
            for wf in self.window_funcs]
        self._literals: Dict[tuple, DeviceStringColumn] = {}

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        yield from self.run_staged(ctx, self._process_batches,
                                   self._merge_spilled)

    # -- spill: staged input as (partition, order)-sorted runs ----------

    def _key_orders(self):
        return [(True, True)] * len(self.partition_by) + \
            [(s.asc, s.nulls_first) for s in self.order_by]

    def _sort_perm(self, merged: Batch):
        """(perm, partition words, order words) of a padded batch: the
        stable (partition, order) sort of its live rows."""
        n, cap = merged.num_rows, merged.capacity
        pcols = self._part_eval(merged)
        ocols = self._order_eval(merged)
        orders = tuple((s.asc, s.nulls_first) for s in self.order_by)
        pwords = encode_sort_keys(pcols, [(True, True)] * len(pcols))
        owords = encode_sort_keys(ocols, orders)
        # no key (OVER ()): the live rows are already first, in order
        perm = lexsort_indices(pwords + owords, n, cap,
                               encode_sort_keys_bits(pcols) +
                               encode_sort_keys_bits(ocols)) \
            if pwords or owords else torch.arange(cap, device=merged.device)
        return perm, pwords, owords

    def sorted_run(self, batches: List[Batch]) -> List[Batch]:
        merged = concat_batches(self.children[0].schema, batches)
        perm, _, _ = self._sort_perm(merged)
        return _rechunk(merged.gather(perm, merged.num_rows),
                        int(conf.get("auron.batch.size")))

    def _merge_spilled(self, runs: List[Iterator[Batch]]
                       ) -> Iterator[Batch]:
        """The runs' merge, processed a group of complete partitions at a
        time: only the open partition at the end of each merged batch
        stays carried."""
        from auron_tpu_torch.ops.sort import HostKeyMerger
        merger = HostKeyMerger(
            lambda b: list(self._part_eval(b)) + list(self._order_eval(b)),
            self._key_orders())
        carry: List[Batch] = []
        for mb in merger.merge(runs):
            n = mb.num_rows
            if self.partition_by:
                pcols = [c.prefix(n) for c in self._part_eval(mb)]
                pwords = encode_sort_keys(pcols,
                                          [(True, True)] * len(pcols))
                same = torch.ones(n, dtype=torch.bool, device=mb.device)
                for w in pwords:
                    same &= w == w[n - 1]
                # the batch is sorted: the last partition is a suffix
                k = n - int(same.sum())
                if k:
                    yield from self._process_batches(
                        carry + [mb.slice(0, k)])
                    carry = []
                    mb = mb.slice(k, n - k)
            carry.append(mb)
            self.update_mem_used(sum(b.mem_bytes() for b in carry))
        if carry:
            yield from self._process_batches(carry)

    def _process_batches(self, batches: List[Batch]) -> Iterator[Batch]:
        if not batches:
            return
        n = sum(b.num_rows for b in batches)
        merged = concat_batches(self.children[0].schema, batches,
                                bucket_capacity(n))
        result = self.window_batch(merged)
        if result is not None:
            yield from _rechunk(result, int(conf.get("auron.batch.size")))

    def window_batch(self, merged: Batch) -> Optional[Batch]:
        """The window over every row of one padded batch, as one batch
        (None when the group limit keeps no row)."""
        n, cap = merged.num_rows, merged.capacity
        perm, pwords, owords = self._sort_perm(merged)
        sorted_b = merged.gather(perm, n)
        live = torch.arange(cap, device=merged.device) < n
        c = segment_context([w[perm] for w in pwords],
                            [w[perm] for w in owords], live, cap)

        out_cols: List[Column] = []
        for wf, arg_eval in zip(self.window_funcs, self._arg_evals):
            args = arg_eval(sorted_b)
            col = compute_window_fn(wf, args, c, bool(self.order_by),
                                    self._default(wf, sorted_b))
            out_cols.append(_coerce_to(wf, col))
        result = sorted_b
        if self.output_window_cols:
            result = Batch(self.schema, list(sorted_b.columns) + out_cols,
                           n, cap)
        if self.group_limit is not None:
            keep = (group_limit_rank(self.group_limit.rank_fn, c)
                    <= self.group_limit.k) & live
            idx, cnt = compact_indices(keep)
            if cnt == 0:
                return None
            result = result.gather(torch.nn.functional.pad(
                idx, (0, bucket_capacity(cnt) - cnt)), cnt)
        return result

    def _default(self, wf: WindowFuncCall, b: Batch) -> Optional[Column]:
        """lead/lag's default value (its third argument, a literal), a
        string as one broadcast row."""
        if wf.fn not in ("lead", "lag") or len(wf.args) < 3 or \
                not isinstance(wf.args[2], Literal) or \
                wf.args[2].value is None:
            return None
        ctx = EvalCtx(b.columns, self.children[0].schema, b.capacity,
                      b.device, self._literals)
        return operand(wf.args[2], ctx)


def segment_context(sp: List[torch.Tensor], so: List[torch.Tensor],
                    live: torch.Tensor, cap: int) -> Ctx:
    """The segment structure of (partition, order)-sorted key words:
    partition and order-group boundaries and starts, partition ids,
    sizes and ends (exclusive), row numbers and ranks."""
    part_bound = _boundaries(sp, live, cap)
    order_bound = part_bound | _boundaries(so, live, cap) if so \
        else part_bound
    idx = torch.arange(cap, dtype=torch.int64, device=live.device)
    seg_start = torch.cummax(torch.where(part_bound, idx, -1), 0).values
    og_start = torch.cummax(torch.where(order_bound, idx, -1), 0).values
    seg_id = torch.cumsum(part_bound.to(torch.int64), 0) - 1
    seg_id = torch.where(live, seg_id, cap - 1)
    seg_sizes = segments.sorted_segment_sum(live.to(torch.int64), seg_id,
                                            cap)
    part_n = seg_sizes[seg_id]
    return {"row_number": idx - seg_start + 1,
            "rank": og_start - seg_start + 1, "idx": idx,
            "seg_start": seg_start, "seg_end": seg_start + part_n,
            "part_n": part_n, "seg_id": seg_id, "og_start": og_start,
            "order_bound": order_bound, "part_bound": part_bound,
            "live": live, "cap": cap}


def group_limit_rank(rank_fn: str, c: Ctx) -> torch.Tensor:
    if rank_fn == "dense_rank":
        return _dense_rank(c["part_bound"], c["order_bound"])
    if rank_fn not in ("row_number", "rank"):
        raise ValueError(f"window group limit by {rank_fn!r}")
    return c[rank_fn]


def _dense_rank(part_bound: torch.Tensor, order_bound: torch.Tensor
                ) -> torch.Tensor:
    og = torch.cumsum(order_bound.to(torch.int64), 0)
    at_start = torch.cummax(torch.where(part_bound, og, -1), 0).values
    return og - at_start + 1


_RANKS = ("row_number", "rank", "dense_rank")
_VALUES = ("first_value", "nth_value", "nth_value_ignore_nulls",
           "last_value")
_AGGS = ("count", "sum", "avg", "min", "max")


def _check_function(wf: WindowFuncCall) -> None:
    ok = wf.fn in _RANKS + _VALUES + ("percent_rank", "cume_dist", "lead",
                                      "lag")
    if wf.fn == "agg":
        ok = wf.agg is not None and wf.agg.fn in _AGGS
    if not ok:
        what = f"agg {wf.agg.fn!r}" if wf.fn == "agg" and wf.agg else \
            repr(wf.fn)
        raise NotImplementedError(
            f"window function {what} is not in auron_tpu_torch yet")


def _int_arg(wf: WindowFuncCall, i: int, default: int) -> int:
    if len(wf.args) > i and isinstance(wf.args[i], Literal) and \
            wf.args[i].value is not None:
        return int(wf.args[i].value)
    return default


def compute_window_fn(wf: WindowFuncCall, args: List[Column], c: Ctx,
                      ordered: bool, default: Optional[Column] = None
                      ) -> Column:
    fn = wf.fn
    live = c["live"]
    if fn in _RANKS:
        d = c[fn] if fn != "dense_rank" else \
            _dense_rank(c["part_bound"], c["order_bound"])
        return flat(DataType.int64(), d, live)
    if fn == "percent_rank":
        denom = torch.clamp(c["part_n"] - 1, min=1).to(torch.float64)
        pr = (c["rank"] - 1).to(torch.float64) / denom
        return flat(DataType.float64(),
                    torch.where(c["part_n"] <= 1, 0.0, pr), live)
    if fn == "cume_dist":
        cd = (_order_group_end(c) - c["seg_start"]).to(torch.float64) / \
            torch.clamp(c["part_n"], min=1).to(torch.float64)
        return flat(DataType.float64(), cd, live)
    if fn in ("lead", "lag"):
        k = _int_arg(wf, 1, 1)
        src = c["idx"] + (k if fn == "lead" else -k)
        in_seg = (src >= c["seg_start"]) & (src < c["seg_end"])
        out = _gather(args[0], src, in_seg, c)
        if default is None:
            return out
        fill = ~in_seg & live
        if isinstance(out, DeviceStringColumn):
            w = max(out.width, default.width)
            return string_col(
                out.dtype, torch.where(fill[:, None],
                                       _pad_width(default.data, w),
                                       _pad_width(out.data, w)),
                torch.where(fill, default.lengths, out.lengths),
                out.validity | fill)
        return flat(out.dtype, torch.where(
            fill, default.data.to(out.data.dtype), out.data),
            out.validity | fill)
    if fn in _VALUES:
        frame_end = _order_group_end(c)
        if fn == "last_value":
            src, ok = frame_end - 1, live
        elif fn == "nth_value_ignore_nulls":
            src = _nth_valid(args[0].validity, c, _int_arg(wf, 1, 1))
            ok = (src < frame_end) & live
        else:
            nth = _int_arg(wf, 1, 1) if fn == "nth_value" else 1
            src = c["seg_start"] + (nth - 1)
            ok = (src < frame_end) & live
        return _gather(args[0], src, ok, c)
    return _agg_over_window(wf, args, c, ordered)


def _nth_valid(valid: torch.Tensor, c: Ctx, nth: int) -> torch.Tensor:
    """Each row's index of the nth non-null value from its partition's
    start (at or past the partition's end where there is none)."""
    incl = torch.cumsum(valid.to(torch.int64), 0)
    before = (incl - valid.to(torch.int64))[c["seg_start"].clamp(min=0)]
    return torch.searchsorted(incl, before + nth)


def _agg_over_window(wf: WindowFuncCall, args: List[Column], c: Ctx,
                     running: bool) -> Column:
    agg = wf.agg
    live = c["live"]
    val = args[-1] if args else None

    def frame(rowwise: torch.Tensor) -> torch.Tensor:
        """The running value at each order group's last row, for every
        row of the group (RANGE frame)."""
        if not running:
            return rowwise
        return rowwise[torch.clamp(_order_group_end(c) - 1, 0,
                                   c["cap"] - 1)]

    def total_or_running(x: torch.Tensor) -> torch.Tensor:
        return frame(_seg_running_sum(x, c)) if running else \
            _seg_total(x, c)

    if agg.fn == "count":
        x = (val.validity if agg.children else live).to(torch.int64)
        return flat(DataType.int64(), total_or_running(x), live)
    has = (total_or_running(val.validity.to(torch.int64)) > 0) & live
    rt = agg.return_type
    if agg.fn in ("sum", "avg"):
        # a decimal sums its unscaled ints; a float result sums values
        fl = rt.is_floating or (agg.fn == "avg" and not rt.is_decimal)
        acc = torch.float64 if fl else torch.int64
        x = numeric_data(val, DataType.float64()) if fl else \
            val.data.to(acc)
        x = torch.where(val.validity, x,
                        torch.zeros((), dtype=acc, device=live.device))
        if running and fl:
            s = frame(_seg_scan(x, c, torch.add))
        else:
            s = total_or_running(x)
        if agg.fn == "avg":
            cnt = total_or_running(val.validity.to(torch.int64))
            if rt.is_decimal:
                out = decimal_average(s, cnt, val.dtype.scale, rt)
                return flat(rt, out.data, out.validity & has)
            return flat(DataType.float64(), s / torch.clamp(cnt, min=1),
                        has)
        if rt.is_decimal:
            has = has & fits_digits(s, rt.precision)
        return flat(rt, s.to(rt.torch_dtype()), has)
    # min / max
    is_min = agg.fn == "min"
    x = val.data
    words = segments.FLOAT_WORDS.get(x.dtype)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if words is not None:
        x = words[0](x)
    info = torch.iinfo(x.dtype)
    neutral = torch.tensor(info.max if is_min else info.min, dtype=x.dtype,
                           device=x.device)
    x = torch.where(val.validity, x, neutral)
    if running:
        out = frame(_seg_scan(x, c, torch.minimum if is_min
                              else torch.maximum))
    else:
        red = segments.sorted_segment_min(x, c["seg_id"], c["cap"]) \
            if is_min else \
            segments.sorted_segment_max(x, c["seg_id"], c["cap"])
        out = red[c["seg_id"]]
    if words is not None:
        out = words[1](out)
    return flat(val.dtype, out.to(val.data.dtype), has)


def _coerce_to(wf: WindowFuncCall, col: Column) -> Column:
    """The computed column as the declared return type (Spark's rank and
    row_number are IntegerType, computed here in int64)."""
    want = _declared_type(wf)
    if isinstance(col, DeviceStringColumn) or want.is_stringlike or \
            col.dtype == want:
        return col
    return DeviceColumn(want, col.data.to(want.torch_dtype()),
                        col.validity)


def _declared_type(wf: WindowFuncCall) -> DataType:
    if wf.return_type is not None:
        return wf.return_type
    if wf.fn in _RANKS:
        return DataType.int64()
    return DataType.float64()


def _boundaries(words: List[torch.Tensor], live: torch.Tensor, cap: int
                ) -> torch.Tensor:
    if not words:       # one partition: row 0 is its only boundary
        return (torch.arange(cap, device=live.device) == 0) & live
    return ~keys_equal_prev(words) & live


def _order_group_end(c: Ctx) -> torch.Tensor:
    """Exclusive end of each row's order group (its peers), within its
    partition: the first order boundary after the row."""
    cap = c["cap"]
    nb = torch.where(c["order_bound"], c["idx"], cap)
    next_bound = torch.flip(torch.cummin(torch.flip(nb, (0,)), 0).values,
                            (0,))
    after = torch.cat([next_bound[1:], next_bound.new_full((1,), cap)])
    return torch.minimum(after, c["seg_end"])


def _gather(val: Column, src: torch.Tensor, ok: torch.Tensor, c: Ctx
            ) -> Column:
    return val.gather(torch.clamp(src, 0, c["cap"] - 1), ok)


def _seg_running_sum(x: torch.Tensor, c: Ctx) -> torch.Tensor:
    """Integer running sum from each partition's start: the global
    prefix sum less the prefix before the start (exact, wrapping)."""
    pref = torch.cumsum(x, 0)
    start = torch.clamp(c["seg_start"], min=0)
    return pref - pref[start] + x[start]


def _seg_total(x: torch.Tensor, c: Ctx) -> torch.Tensor:
    seg = c["seg_id"]
    return segments.sorted_segment_sum(x, seg, c["cap"])[seg]


def _seg_scan(x: torch.Tensor, c: Ctx, op) -> torch.Tensor:
    """Inclusive scan of a binary op within each partition: log-step
    (Hillis-Steele), a row combining with the row d before it only
    where that row is in its own partition."""
    n = int(x.shape[0])
    stop = c["idx"] - c["seg_start"]        # rows before, in the partition
    d = 1
    while d < n:
        prev = torch.cat([x[:1].expand(d), x[:-d]])
        x = torch.where(stop >= d, op(x, prev), x)
        d <<= 1
    return x

