"""Aggregation operator, sort-based grouping on the device (counterpart
of auron_tpu/ops/agg/exec.py: `AggExec` and `_group_reduce_body`).

Per input batch: evaluate the keys, encode them into the
order-preserving key words of ops/sort_keys.py (ascending, nulls first),
stable-sort the live rows by the words, flag the boundaries between
equal-key runs (`keys_equal_prev`), number the segments, and reduce every
agg state over the segments.  The grouped batches are staged and merged,
`_MERGE_FANIN` at a time, with the same reduction over partial states.
Every key type the encoder holds groups: bool, int8/16/32/64, date32,
timestamp, float64, string and binary.  Null keys form one group (nulls
first).  A string key's words depend on its column's width, so every
batch the operator reduces holds its rows at one width: the staged
merges concatenate at the widest part (`concat_batches`), and so does
the reduce side, one batch at a time.  A group's string key comes out
at the width of the batch that formed it.  Over string inputs only
Count runs; string Min, Max and First are host aggregates in the JAX
package and are not ported.  Float64
keys group as Spark's `NormalizeFloatingNumbers` leaves them: -0.0 with
0.0 and every NaN together, and the key comes out normalized (0.0, the
positive quiet NaN); the JAX package's words keep -0.0 apart from 0.0
and split NaNs by sign (ROADMAP Queue 3).  A global aggregate (no keys)
takes every live row as one segment, with no sort and no host read.
Modes: `partial` updates and emits states, `final` merges states and
finalizes, `single` (the converter's default) updates and finalizes in
one operator.  A partial
aggregate over a stream with no rows emits nothing; a final or single
global aggregate over one emits the one row of `_empty_global_agg`
(count 0, every other state null).  In `partial` mode the partial-agg
skipping rule of the JAX package applies: once enough rows came in and
the groups are nearly as many as the rows, the operator emits what it
holds and passes the rest of its input through, grouped batch by batch.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, bucket_capacity, concat_batches,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.expr import AggExpr
from auron_tpu_torch.ir.schema import Field, Schema, TypeId
from auron_tpu_torch.ops.agg.functions import AggSpec, make_spec
from auron_tpu_torch.ops.base import Operator, TaskContext
from auron_tpu_torch.ops.sort_keys import (
    encode_sort_keys, encode_sort_keys_bits, keys_equal_prev,
    lexsort_indices, normalize_f64, value_bits,
)

# staged grouped batches merged at once (the JAX package's
# `auron.agg.merge.fanin` default)
_MERGE_FANIN = 8


class AggExec(Operator):
    def __init__(self, child: Operator, exec_mode: str, grouping,
                 grouping_names, aggs: Tuple[AggExpr, ...], agg_names,
                 supports_partial_skipping: bool = False):
        if exec_mode not in ("partial", "final", "single"):
            raise ValueError(f"unknown agg mode {exec_mode!r}")
        in_schema = child.schema
        self.exec_mode = exec_mode
        self.nk = len(grouping)
        self.specs: List[AggSpec] = [make_spec(a.fn, a.return_type, n)
                                     for a, n in zip(aggs, agg_names)]
        self._key_eval = build_evaluator(grouping, in_schema)
        for t in self._key_eval.out_types:
            value_bits(t)          # raises for a type it cannot encode
        key_fields = [Field(n, t) for n, t in
                      zip(grouping_names, self._key_eval.out_types)]
        self.state_schema = Schema(tuple(
            key_fields + [f for s in self.specs for f in s.state_fields()]))
        if exec_mode != "final":
            flat_inputs: List = []
            self._arg_slices: List[Tuple[int, int]] = []
            for a in aggs:
                start = len(flat_inputs)
                flat_inputs.extend(a.children)
                self._arg_slices.append((start, len(flat_inputs)))
            self._val_eval = build_evaluator(flat_inputs, in_schema)
            for a, (lo, hi) in zip(aggs, self._arg_slices):
                if a.fn != "count" and any(
                        t.is_stringlike
                        for t in self._val_eval.out_types[lo:hi]):
                    raise NotImplementedError(
                        f"aggregate {a.fn!r} over a string is not in "
                        f"auron_tpu_torch yet")
        out_schema = self.state_schema if exec_mode == "partial" else \
            Schema(tuple(key_fields + [Field(n, a.return_type)
                                       for n, a in zip(agg_names, aggs)]))
        super().__init__(out_schema, [child])
        self.supports_partial_skipping = supports_partial_skipping and \
            exec_mode == "partial" and \
            bool(conf.get("auron.partial.agg.skipping.enable"))
        self._staged: List[Batch] = []

    # -- grouping ------------------------------------------------------

    def _state_slices(self, cols: List[Column]) -> List[List[Column]]:
        out, off = [], 0
        for spec in self.specs:
            k = len(spec.state_fields())
            out.append(cols[off:off + k])
            off += k
        return out

    def _eval(self, b: Batch, merge_input: bool):
        keys = self._key_eval(b)
        if merge_input:
            return keys, self._state_slices(b.columns[self.nk:])
        vals = self._val_eval(b)
        return keys, [vals[s:e] for s, e in self._arg_slices]

    def _reduce(self, keys, vcols, num_rows: int, merge: bool,
                device: torch.device) -> Batch:
        cols, n_groups, cap = group_reduce(keys, vcols, num_rows,
                                           self.specs, merge, device)
        return Batch(self.state_schema, cols, n_groups, cap)

    # -- staged accumulation -------------------------------------------

    def _stage(self, grouped: Batch, device: torch.device) -> None:
        self._staged.append(grouped)
        if len(self._staged) >= _MERGE_FANIN:
            self._compact(device)

    def _compact(self, device: torch.device) -> Optional[Batch]:
        """Merge the staged grouped batches into one."""
        if len(self._staged) > 1:
            merged = concat_batches(self.state_schema, self._staged)
            self._staged = [self._reduce(
                merged.columns[:self.nk],
                self._state_slices(merged.columns[self.nk:]),
                merged.num_rows, merge=True, device=device)]
        return self._staged[0] if self._staged else None

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        merge_input = self.exec_mode == "final"
        dev = ctx.device
        input_rows = 0
        passthrough = False
        stream = self.child_stream(ctx)   # one iterator: both loops share
        for b in stream:
            if b.num_rows == 0:
                continue
            self._stage(self._reduce(*self._eval(b, merge_input),
                                     b.num_rows, merge_input, dev), dev)
            if not self.supports_partial_skipping:
                continue
            input_rows += b.num_rows
            if input_rows >= int(conf.get(
                    "auron.partial.agg.skipping.min.rows")):
                acc = self._compact(dev)
                if acc.num_rows / input_rows >= float(conf.get(
                        "auron.partial.agg.skipping.ratio")):
                    passthrough = True
                    self.count("partial_skipped", 1)
                    yield acc
                    self._staged = []
                    break
        if passthrough:
            for b in stream:
                if b.num_rows:
                    yield self._reduce(*self._eval(b, False), b.num_rows,
                                       merge=False, device=dev)
            return
        acc = self._compact(dev)
        self._staged = []
        if acc is None:
            if self.nk == 0 and self.exec_mode != "partial":
                yield self._empty_global_agg(dev)
            return
        yield acc if self.exec_mode == "partial" else self._finalize(acc)

    def _finalize(self, acc: Batch) -> Batch:
        out = list(acc.columns[:self.nk])
        for spec, states in zip(self.specs,
                                self._state_slices(acc.columns[self.nk:])):
            out.append(spec.eval_final(states))
        return Batch(self.schema, out, acc.num_rows, acc.capacity)

    def _empty_global_agg(self, dev: torch.device) -> Batch:
        """A global aggregate over no rows: one row, Count's state 0 and
        every other state null, finalized."""
        cap = bucket_capacity(1)
        out = []
        for spec in self.specs:
            states = []
            for f in spec.state_fields():
                valid = torch.zeros(cap, dtype=torch.bool, device=dev)
                valid[:1] = spec.fn == "count"
                states.append(DeviceColumn(f.dtype, torch.zeros(
                    cap, dtype=f.dtype.torch_dtype(), device=dev), valid))
            out.append(spec.eval_final(states))
        return Batch(self.schema, out, 1, cap)


def group_reduce(keys: List[Column],
                 value_cols: List[List[Column]], num_rows: int,
                 specs: List[AggSpec], merge: bool, device: torch.device
                 ) -> Tuple[List[Column], int, int]:
    """Sort-based group reduction of the first `num_rows` rows (with no
    keys, `_global_reduce` on `device`), as the JAX package's
    `_group_reduce_body`: the keys' words (ascending, nulls first) are
    stably lexsorted, and a row whose words differ from the previous
    row's starts a group.  Returns (key columns + state columns at
    capacity bucket_capacity(n_groups), n_groups, that capacity); the
    group count is read back to the host once."""
    n = num_rows
    if not keys:
        return _global_reduce(value_cols, n, specs, merge, device)
    live = [k.prefix(n) for k in keys]
    words = encode_sort_keys(live, [(True, True)] * len(live))
    perm = lexsort_indices(words, n, n, encode_sort_keys_bits(live))
    boundary = ~keys_equal_prev([w[perm] for w in words])
    seg = torch.cumsum(boundary, 0) - 1
    first = torch.nonzero(boundary).squeeze(1)
    n_groups = int(first.shape[0])
    cap = bucket_capacity(n_groups)
    dev = perm.device
    valid = torch.arange(cap, device=dev) < n_groups
    key_src = torch.nn.functional.pad(perm[first], (0, cap - n_groups))
    out: List[Column] = [_group_key(k.gather(key_src, valid)) for k in keys]
    for spec, cols in zip(specs, value_cols):
        scols = [c.take(perm) for c in cols]
        states = spec.merge_segments(scols, seg, cap) if merge else \
            spec.update_segments(scols, seg, cap)
        # rows past the group count hold reductions of nothing
        out.extend(DeviceColumn(s.dtype, s.data, s.validity & valid)
                   for s in states)
    return out, n_groups, cap


def _group_key(k: Column) -> Column:
    """A group's key as Spark emits it: a float64 key normalized."""
    if k.dtype.id != TypeId.FLOAT64:
        return k
    return DeviceColumn(k.dtype, normalize_f64(k.data), k.validity)


def _global_reduce(value_cols: List[List[Column]], n: int,
                   specs: List[AggSpec], merge: bool, device: torch.device
                   ) -> Tuple[List[DeviceColumn], int, int]:
    """group_reduce with no keys: the first n rows (n > 0) are segment 0,
    one group, no sort and no host read."""
    cap = bucket_capacity(1)
    seg = torch.zeros(n, dtype=torch.int64, device=device)
    first = torch.arange(cap, device=device) < 1
    out: List[DeviceColumn] = []
    for spec, cols in zip(specs, value_cols):
        live = [c.prefix(n) for c in cols]
        states = spec.merge_segments(live, seg, cap) if merge else \
            spec.update_segments(live, seg, cap)
        # rows past the one group hold reductions of nothing
        out.extend(DeviceColumn(s.dtype, s.data, s.validity & first)
                   for s in states)
    return out, 1, cap
