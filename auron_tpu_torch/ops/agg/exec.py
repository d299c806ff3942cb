"""Aggregation operator, sort-based grouping on the device (counterpart
of auron_tpu/ops/agg/exec.py: `AggExec` and `_group_reduce_body`).

Per input batch: evaluate the keys, encode them into the
order-preserving key words of ops/sort_keys.py (ascending, nulls first),
stable-sort the live rows by the words, flag the boundaries between
equal-key runs (`keys_equal_prev`), number the segments, and reduce every
agg state over the segments.  The grouped batches are staged and merged,
`_MERGE_FANIN` at a time, with the same reduction over partial states.
Every key type the encoder holds groups: bool, int8/16/32/64, date32,
timestamp, float32, float64, decimal(p <= 18) (by its unscaled value),
string and binary.  Null keys form one group (nulls
first).  A string key's words depend on its column's width, so every
batch the operator reduces holds its rows at one width: the staged
merges concatenate at the widest part (`concat_batches`), and so does
the reduce side, one batch at a time.  A group's string key comes out
at the width of the batch that formed it.  Over string inputs only
Count runs; string Min, Max and First are host aggregates in the JAX
package and are not ported.  Float64 and float32
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

The partial-aggregation prologue (`auron.fuse.enable`, the JAX
package's composition): over a fused fragment child of one lane and no
limit, outside final mode and partial skipping, the operator pulls the
fragment's child itself, runs the fragment's stages uncompacted
(`FusedFragmentExec.apply_stages`) and groups under the fragment's live
mask (`group_reduce(..., live=...)`), so the fragment's compaction goes
away; the fragment's node counts `fused_batches` and
`fused_into_parent`, and yields no batch.

Spill: the operator is a memory consumer.  Under pressure its staged
groups merge into one key-sorted state run and spill (memmgr/spill.py);
at the end the runs merge through the sort's `HostKeyMerger`, each
merged batch is merge-reduced with the group carried from the last one,
and every group but the last goes out (`_merge_spilled`).  A global
aggregate's one-row runs are concatenated and reduced once.  A spilled
float sum adds in another order than the in-memory one.  A partial
aggregate that starts passing its input through with runs already
spilled (`auron.partial.agg.skipping.skip.spill`) emits those runs'
partial states first.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, bucket_capacity, concat_batches, flat,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.exprs.typing import infer_type
from auron_tpu_torch.ir.expr import AggExpr
from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId
from auron_tpu_torch.ops.agg.functions import AggSpec, make_spec
from auron_tpu_torch.ops.base import Operator, StagingOperator, TaskContext
from auron_tpu_torch.ops.sort_keys import (
    encode_sort_keys, encode_sort_keys_bits, keys_equal_prev,
    lexsort_indices, lexsort_indices_live, normalize_f64, value_bits,
)

# staged grouped batches merged at once (the JAX package's
# `auron.agg.merge.fanin` default)
_MERGE_FANIN = 8


class AggExec(StagingOperator):
    def __init__(self, child: Operator, exec_mode: str, grouping,
                 grouping_names, aggs: Tuple[AggExpr, ...], agg_names,
                 supports_partial_skipping: bool = False):
        if exec_mode not in ("partial", "final", "single"):
            raise ValueError(f"unknown agg mode {exec_mode!r}")
        in_schema = child.schema
        self.exec_mode = exec_mode
        self.nk = len(grouping)
        self.specs: List[AggSpec] = [
            make_spec(a.fn, a.return_type, n,
                      _sum_dtype(a, n, exec_mode, in_schema))
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
        StagingOperator.__init__(self, out_schema, [child], "AggExec", "agg")
        self.supports_partial_skipping = supports_partial_skipping and \
            exec_mode == "partial" and \
            bool(conf.get("auron.partial.agg.skipping.enable"))
        self._dev = torch.device("cpu")
        self._prologue = self._fused_prologue(child, grouping, aggs,
                                              in_schema)

    def _fused_prologue(self, child: Operator, grouping, aggs,
                        in_schema: Schema):
        """The partial-aggregation prologue: a composable fused fragment
        child (one lane, no limit) whose stages this operator runs
        itself, grouping the fragment's uncompacted columns under its
        live mask, so the fragment's compaction goes away.  The JAX
        package's conditions: not in final mode, no partial skipping, no
        host aggregate (the port has none), `auron.fuse.enable`, and
        every key and aggregate input able to run inside the fragment."""
        from auron_tpu_torch.ops.fused import FusedFragmentExec
        if self.exec_mode == "final" or self.supports_partial_skipping or \
                not bool(conf.get("auron.fuse.enable")) or \
                not isinstance(child, FusedFragmentExec) or \
                not child.composable():
            return None
        from auron_tpu_torch.runtime.fusion import (
            _static_host_cols, device_capable, tree_has_row_base,
        )
        host = _static_host_cols(in_schema)
        exprs = list(grouping) + [x for a in aggs for x in a.children]
        if any(tree_has_row_base(x) or not device_capable(x, in_schema, host)
               for x in exprs):
            return None
        child.metrics.set("fused_into_parent", 1)
        return child

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

    def _prologue_groups(self, ctx: TaskContext) -> Iterator[Batch]:
        """The prologue's input loop: each batch of the fragment's child
        through the fragment's stages, uncompacted, and grouped under
        the live mask; a batch that keeps no row groups to nothing."""
        frag = self._prologue
        for b in frag.child_stream(ctx):
            if b.num_rows == 0:
                continue
            cols, live = frag.apply_stages(b)
            frag.count("fused_batches")
            keys, vcols = self._eval(
                Batch(frag.schema, cols, b.num_rows, b.capacity), False)
            out, n_groups, cap = group_reduce(keys, vcols, b.num_rows,
                                              self.specs, False, ctx.device,
                                              live)
            if n_groups:
                yield Batch(self.state_schema, out, n_groups, cap)

    # -- staged accumulation -------------------------------------------

    def _stage(self, grouped: Batch, device: torch.device) -> None:
        if len(self._staged) + 1 >= _MERGE_FANIN:
            self.set_staged([self._merged(self._staged + [grouped], device)])
        else:
            self.stage(grouped)

    def _merged(self, batches: List[Batch], device: torch.device) -> Batch:
        """The grouped batches merged into one, key-sorted."""
        if len(batches) == 1:
            return batches[0]
        merged = concat_batches(self.state_schema, batches)
        return self._reduce(merged.columns[:self.nk],
                            self._state_slices(merged.columns[self.nk:]),
                            merged.num_rows, merge=True, device=device)

    def _compact(self, device: torch.device) -> Optional[Batch]:
        """The staged grouped batches merged into one, staged alone."""
        if len(self._staged) > 1:
            self.set_staged([self._merged(self._staged, device)])
        return self._staged[0] if self._staged else None

    # -- memory --------------------------------------------------------

    def sorted_run(self, batches: List[Batch]) -> List[Batch]:
        return [self._merged(batches, self._dev)]

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        self._dev = ctx.device
        with self.spill_scope(ctx):
            yield from self._execute(ctx)

    def _execute(self, ctx: TaskContext) -> Iterator[Batch]:
        merge_input = self.exec_mode == "final"
        dev = ctx.device
        input_rows = 0
        passthrough = False
        if self._prologue is not None:
            for g in self._prologue_groups(ctx):
                self._stage(g, dev)
            stream = iter(())
        else:
            stream = self.child_stream(ctx)   # both loops share it
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
                if acc is None:     # the state went to a spill just now
                    continue
                skip_ok = not len(self._spills) or bool(conf.get(
                    "auron.partial.agg.skipping.skip.spill"))
                if skip_ok and acc.num_rows / input_rows >= float(conf.get(
                        "auron.partial.agg.skipping.ratio")):
                    passthrough = True
                    self.count("partial_skipped", 1)
                    for sp in self._spills.spills:
                        yield from sp.read_batches()
                    yield acc
                    self.set_staged([])
                    break
        if passthrough:
            for b in stream:
                if b.num_rows:
                    yield self._reduce(*self._eval(b, False), b.num_rows,
                                       merge=False, device=dev)
            return
        if len(self._spills):
            self.spill()
            yield from self._merge_spilled(dev)
            return
        staged = self.take_staged()
        if not staged:
            if self.nk == 0 and self.exec_mode != "partial":
                yield self._empty_global_agg(dev)
            return
        yield self._emit(self._merged(staged, dev))

    def _emit(self, acc: Batch) -> Batch:
        return acc if self.exec_mode == "partial" else self._finalize(acc)

    def _merge_spilled(self, dev: torch.device) -> Iterator[Batch]:
        """The k-way merge of the spilled key-sorted state runs: each
        merged batch, after the group carried from the last, is
        merge-reduced, and every group but the last goes out; resident
        memory is one merged batch, not every run."""
        from auron_tpu_torch.ops.sort import HostKeyMerger
        runs = [s.read_batches() for s in self._spills.spills]
        if self.nk == 0:
            # a global aggregate: one state row a run
            merged = concat_batches(self.state_schema,
                                    [b for r in runs for b in r])
            yield self._emit(self._reduce(
                [], self._state_slices(merged.columns), merged.num_rows,
                merge=True, device=dev))
            return
        nk = self.nk
        merger = HostKeyMerger(lambda b: b.columns[:nk],
                               [(True, True)] * nk)
        carry: Optional[Batch] = None
        for mb in merger.merge(runs):
            if carry is not None:
                mb = concat_batches(self.state_schema, [carry, mb])
            g = self._reduce(mb.columns[:nk],
                             self._state_slices(mb.columns[nk:]),
                             mb.num_rows, merge=True, device=dev)
            if g.num_rows > 1:
                yield self._emit(g.head(g.num_rows - 1))
            carry = g.slice(g.num_rows - 1, 1)
        if carry is not None:
            yield self._emit(carry)

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
                 specs: List[AggSpec], merge: bool, device: torch.device,
                 live: Optional[torch.Tensor] = None
                 ) -> Tuple[List[Column], int, int]:
    """Sort-based group reduction of the first `num_rows` rows (with no
    keys, `_global_reduce` on `device`), as the JAX package's
    `_group_reduce_body`: the keys' words (ascending, nulls first) are
    stably lexsorted, and a row whose words differ from the previous
    row's starts a group.  Returns (key columns + state columns at
    capacity bucket_capacity(n_groups), n_groups, that capacity); the
    group count is read back to the host once.

    With a `live` mask (the fused prologue's) only its rows group: the
    dead rows sort last with their words zeroed, so they form one group
    after the live ones, which reduces into the slot past the last group
    (the capacity holds n_groups + 1) and is dropped, data and validity.
    The live groups, and each group's rows in input order, are those of
    the compacted rows."""
    n = num_rows
    if not keys:
        return _global_reduce(value_cols, n, specs, merge, device, live)
    kcols = [k.prefix(n) for k in keys]
    words = encode_sort_keys(kcols, [(True, True)] * len(kcols))
    bits = encode_sort_keys_bits(kcols)
    if live is None:
        perm = lexsort_indices(words, n, n, bits)
        boundary = ~keys_equal_prev([w[perm] for w in words])
        starts = boundary
        spare = 0
    else:
        live = live[:n]
        words = [torch.where(live, w, 0) for w in words]
        perm = lexsort_indices_live(words, live, bits)
        live_sorted = live[perm]
        boundary = ~keys_equal_prev([live_sorted] +
                                    [w[perm] for w in words])
        starts = boundary & live_sorted
        spare = 1
    seg = torch.cumsum(boundary, 0) - 1
    first = torch.nonzero(starts).squeeze(1)
    n_groups = int(first.shape[0])
    cap = bucket_capacity(n_groups + spare)
    dev = perm.device
    valid = torch.arange(cap, device=dev) < n_groups
    key_src = torch.nn.functional.pad(perm[first], (0, cap - n_groups))
    out: List[Column] = [_group_key(k.gather(key_src, valid)) for k in keys]
    for spec, cols in zip(specs, value_cols):
        scols = [c.take(perm) for c in cols]
        states = spec.merge_segments(scols, seg, cap) if merge else \
            spec.update_segments(scols, seg, cap)
        out.extend(_past_groups_dropped(states, valid, live is not None))
    return out, n_groups, cap


def _past_groups_dropped(states: List[DeviceColumn], valid: torch.Tensor,
                         masked: bool) -> List[DeviceColumn]:
    """States with the rows past the group count null: they hold
    reductions of nothing, and under a live mask the dead rows' group,
    whose data is zeroed too."""
    if masked:
        return [flat(s.dtype, s.data, s.validity & valid) for s in states]
    return [DeviceColumn(s.dtype, s.data, s.validity & valid)
            for s in states]


def _sum_dtype(a: AggExpr, name: str, exec_mode: str, in_schema: Schema
               ) -> DataType:
    """A decimal average's sum state type: its input's type, read from
    the state column in final mode (whose children name the partial
    stage's input)."""
    if a.fn != "avg" or not a.return_type.is_decimal:
        return DataType.float64()
    if exec_mode == "final":
        return in_schema.field(f"{name}#sum").dtype
    return infer_type(a.children[0], in_schema)


def _group_key(k: Column) -> Column:
    """A group's key as Spark emits it: a float key normalized."""
    if k.dtype.id not in (TypeId.FLOAT64, TypeId.FLOAT32):
        return k
    return DeviceColumn(k.dtype, normalize_f64(k.data), k.validity)


def _global_reduce(value_cols: List[List[Column]], n: int,
                   specs: List[AggSpec], merge: bool, device: torch.device,
                   live: Optional[torch.Tensor] = None
                   ) -> Tuple[List[DeviceColumn], int, int]:
    """group_reduce with no keys: the first n rows (n > 0) are segment 0,
    one group, no sort and no host read.  Under a `live` mask the dead
    rows reduce into segment 1, dropped (the capacity holds it); the
    count of live rows is read back once, and with none there is no
    group."""
    cap = bucket_capacity(1 if live is None else 2)
    if live is None:
        seg = torch.zeros(n, dtype=torch.int64, device=device)
    else:
        live = live[:n]
        if not int(live.sum()):
            return [], 0, cap
        seg = (~live).to(torch.int64)
    first = torch.arange(cap, device=device) < 1
    out: List[DeviceColumn] = []
    for spec, cols in zip(specs, value_cols):
        rows = [c.prefix(n) for c in cols]
        states = spec.merge_segments(rows, seg, cap) if merge else \
            spec.update_segments(rows, seg, cap)
        out.extend(_past_groups_dropped(states, first, live is not None))
    return out, 1, cap
