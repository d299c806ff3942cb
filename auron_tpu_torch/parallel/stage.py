"""The single-device stage executor (counterpart of
auron_tpu/parallel/stage.py on a one-device mesh).

A converted query (its root plan, and the exchanges, broadcasts and
sources behind its readers) runs as one whole-table evaluation: every
operator is evaluated once over a `DeviceTable`, all of a table's rows
on the device with a live mask, in place of the serial path's task per
partition and batch per scan slice.  On one device an exchange and a
broadcast are identities (the JAX package's `n_dev == 1` branch), so a
query's stages chain on the device with no shuffle.

torch runs eagerly, so where the JAX package traces one program of
static shapes under runtime guards, this executor reads each size it
needs (a join's pair count, an aggregation's group count, a table's
live count) back to the host and sizes every buffer exactly.  It has
no program cache, no capacity buckets and no guard retry ladder (match
factor, aggregation capacity hint, join compaction): a duplicate build
key, a join that fans out and an aggregation of any group count give
the same answer with no retry.  The JAX package's injected device
faults and its multi-device sharding are not in the port.

The acceptance rules are the JAX package's, with its reasons: a plan
the executor cannot express raises `SpmdUnsupported` (from
`precheck_plan` before any source is uploaded, or while evaluating:
a limit over a sort, a union that reads a child's partitions unevenly,
an expression, aggregate or window function the port has no device
form of), and `frontend/session.py` runs the serial path instead.
Where the JAX package's stage path departs from Spark (a mid-plan top-k
sort's fetch offset, float join keys), the port keeps Spark's semantics
(ROADMAP Queue 3).

Host reads (`host_syncs` in the result's metrics): one per live-row
compaction, per grouped aggregation, and two to four per pair-emitting
join; the filter, projection, union, expand, top-k sort and limit read
nothing back.  Sources go through a device-resident cache
(`auron.spmd.source.cache.mb`): a table is uploaded once per (table,
device, string layout) and evicted least recently used.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, bucket_capacity, concat_device_columns,
    from_numpy, null_column,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import EvalCtx, build_evaluator, evaluate
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops.agg.exec import AggExec, group_reduce
from auron_tpu_torch.ops.basic import _conform
from auron_tpu_torch.ops.joins.exec import join_output_schema
from auron_tpu_torch.ops.joins.kernel import (
    NULL_BUILD, expand_pairs, join_key_hash, mark_matched, probe_ranges,
    stable_hash_argsort, verify_pairs,
)
from auron_tpu_torch.ops.sort_keys import (
    encode_sort_keys, encode_sort_keys_bits, lexsort_indices_live,
)
from auron_tpu_torch.ops.strategy import join_probe_strategy
from auron_tpu_torch.ops.window.exec import WindowExec
from auron_tpu_torch.runtime.executor import ExecutionResult, execute_plan
from auron_tpu_torch.runtime.resources import ResourceRegistry


class SpmdUnsupported(Exception):
    """A plan the stage executor cannot express; the caller runs the
    serial per-partition path."""


@dataclass
class DeviceTable:
    """A table on the device: every row, padding included, and a live
    mask.  `dense` says every row is live (the live rows were compacted
    and the capacity is their count), so a consumer compacts nothing."""
    schema: Schema
    cols: List[Column]
    live: torch.Tensor      # bool[capacity]
    dense: bool = False

    @property
    def capacity(self) -> int:
        return int(self.live.shape[0])


class _SchemaOnly:
    """The child an operator is built over for its metadata alone."""

    def __init__(self, schema: Schema):
        self.schema = schema


def _empty_table(schema: Schema, dev: torch.device) -> DeviceTable:
    """No rows: one padding row, so every kernel sees a non-empty
    tensor."""
    return DeviceTable(schema, [null_column(f.dtype, 1, dev)
                                for f in schema],
                       torch.zeros(1, dtype=torch.bool, device=dev))


def _dense(schema: Schema, cols: List[Column], n: int,
           dev: torch.device) -> DeviceTable:
    """The first n rows of `cols`, all live."""
    if n == 0:
        return _empty_table(schema, dev)
    return DeviceTable(schema, [c.prefix(n) for c in cols],
                       torch.ones(n, dtype=torch.bool, device=dev), True)


# ---------------------------------------------------------------------------
# plan walk
# ---------------------------------------------------------------------------

class _StageTracer:
    _JOIN_TYPES = ("inner", "left", "left_semi", "left_anti", "existence")
    _JOIN_TYPES_COLOCATED = _JOIN_TYPES + ("full", "right")

    def __init__(self, conv_ctx, bindings: Dict[str, DeviceTable],
                 device: torch.device, shadow_sort: Optional[P.Sort] = None):
        self.exchanges = getattr(conv_ctx, "exchanges", None) or {}
        self.broadcasts = getattr(conv_ctx, "broadcasts", None) or {}
        self.bindings = bindings
        self.dev = device
        # the host tail's global sort: a top-k sort it shadows (same key
        # prefix, limit at least as strict) is skipped
        self.shadow_sort = shadow_sort
        self.syncs = 0
        # exchange and broadcast children by identity: a stage two
        # readers share is evaluated once
        self._jobs: Dict[int, Tuple[Any, DeviceTable]] = {}

    # -- host reads ---------------------------------------------------------

    def _read(self, x: torch.Tensor) -> int:
        self.syncs += 1
        return int(x)

    def _nonzero(self, mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
        idx = torch.nonzero(mask).squeeze(1)
        self.syncs += 1
        return idx, int(idx.shape[0])

    def _live_cols(self, t: DeviceTable) -> Tuple[List[Column], int]:
        """The live rows' columns, in table order, and their count."""
        if t.dense:
            return list(t.cols), t.capacity
        idx, n = self._nonzero(t.live)
        return [c.take(idx) for c in t.cols], n

    def gather(self, t: DeviceTable) -> Batch:
        """The live rows as one batch whose capacity is its row count."""
        cols, n = self._live_cols(t)
        return Batch(t.schema, cols, n, n)

    # -- expression eval ------------------------------------------------------

    def _compiled(self, exprs, schema: Schema):
        try:
            return build_evaluator(exprs, schema)
        except NotImplementedError as e:
            raise SpmdUnsupported(f"expr not device-capable: {e}") from e

    def _run(self, ev, t: DeviceTable) -> List[Column]:
        ctx = EvalCtx(list(t.cols), t.schema, t.capacity, self.dev)
        try:
            return [evaluate(x, ctx) for x in ev.exprs]
        except NotImplementedError as e:
            raise SpmdUnsupported(f"expr not device-capable: {e}") from e

    def _eval_exprs(self, exprs, t: DeviceTable) -> List[Column]:
        return self._run(self._compiled(exprs, t.schema), t)

    # -- node dispatch --------------------------------------------------------

    def eval_node(self, node) -> DeviceTable:
        if not isinstance(node, P.PlanNode):
            raise SpmdUnsupported(f"non-native section: {type(node).__name__}")
        handler = getattr(self, f"_do_{node.kind}", None)
        if handler is None:
            raise SpmdUnsupported(f"operator not SPMD-compilable: {node.kind}")
        return handler(node)

    # sources -----------------------------------------------------------------

    def _binding(self, rid: str) -> DeviceTable:
        if rid not in self.bindings:
            raise SpmdUnsupported(f"unbound resource {rid!r}")
        return self.bindings[rid]

    def _do_ffi_reader(self, n: P.FFIReader) -> DeviceTable:
        return self._binding(n.resource_id)

    def _job_table(self, child) -> DeviceTable:
        got = self._jobs.get(id(child))
        if got is None:
            got = self._jobs[id(child)] = (
                child, self.eval_node(_require_native(child)))
        return got[1]

    def _do_ipc_reader(self, n: P.IpcReader) -> DeviceTable:
        # an exchange or a broadcast is an identity on one device; the
        # reader's schema names the columns, as the serial reader's does
        rid = n.resource_id
        job = self.exchanges.get(rid) or self.broadcasts.get(rid)
        if job is None:
            return self._binding(rid)
        t = self._job_table(job.child)
        return DeviceTable(n.schema, t.cols, t.live, t.dense)

    # row ops -----------------------------------------------------------------

    def _concat_tables(self, schema: Schema,
                       tables: List[DeviceTable]) -> DeviceTable:
        if len(tables) == 1:
            t = tables[0]
            return DeviceTable(schema, t.cols, t.live, t.dense)
        cols = [concat_device_columns([t.cols[i] for t in tables])
                for i in range(len(schema))]
        return DeviceTable(schema, cols, torch.cat([t.live for t in tables]),
                           all(t.dense for t in tables))

    def _do_union(self, n: P.Union) -> DeviceTable:
        # the whole table of every child is here, so the per-partition
        # inputs collapse to one copy of each child; a child whose
        # partitions are each read m times contributes m copies
        by_child: Dict[int, Any] = {}
        order: List[int] = []
        for i in n.inputs:
            if id(i.child) not in by_child:
                by_child[id(i.child)] = (i.child, {})
                order.append(id(i.child))
            counts = by_child[id(i.child)][1]
            counts[i.partition] = counts.get(i.partition, 0) + 1
        tables: List[DeviceTable] = []
        for cid in order:
            child, part_counts = by_child[cid]
            counts = set(part_counts.values())
            if len(counts) != 1:
                raise SpmdUnsupported(
                    "union references a child's partitions unevenly")
            t = self.eval_node(child)
            tables.extend([t] * counts.pop())
        return self._concat_tables(n.schema, tables)

    def _do_expand(self, n: P.Expand) -> DeviceTable:
        # each projection contributes one copy of the child's rows, cast
        # to the declared types as the serial operator casts them
        t = self.eval_node(n.child)
        evs = [self._compiled(p, t.schema) for p in n.projections]
        types = tuple(n.types) if n.types else tuple(evs[0].out_types)
        schema = Schema(tuple(Field(nm, dt)
                              for nm, dt in zip(n.names, types)))
        parts = [DeviceTable(schema, [_conform(c, dt) for c, dt in
                                      zip(self._run(ev, t), types)],
                             t.live, t.dense) for ev in evs]
        return self._concat_tables(schema, parts)

    def _do_filter(self, n: P.Filter) -> DeviceTable:
        t = self.eval_node(n.child)
        live = t.live
        for m in self._eval_exprs(n.predicates, t):
            live = live & m.validity & (m.data != 0)
        return DeviceTable(t.schema, t.cols, live)

    def _do_projection(self, n: P.Projection) -> DeviceTable:
        t = self.eval_node(n.child)
        ev = self._compiled(n.exprs, t.schema)
        schema = Schema(tuple(Field(nm, dt)
                              for nm, dt in zip(n.names, ev.out_types)))
        return DeviceTable(schema, self._run(ev, t), t.live, t.dense)

    def _do_rename_columns(self, n: P.RenameColumns) -> DeviceTable:
        t = self.eval_node(n.child)
        return DeviceTable(t.schema.rename(tuple(n.names)), t.cols, t.live,
                           t.dense)

    def _do_coalesce_batches(self, n: P.CoalesceBatches) -> DeviceTable:
        return self.eval_node(n.child)

    def _do_debug(self, n: P.Debug) -> DeviceTable:
        return self.eval_node(n.child)

    # aggregation -------------------------------------------------------------

    def _do_agg(self, n: P.Agg) -> DeviceTable:
        # one device holds every partition: a single-mode aggregation
        # that precheck_plan admitted (colocated by its feeding exchange)
        # groups the whole table at once
        t = self.eval_node(n.child)
        try:
            agg = AggExec(_SchemaOnly(t.schema), n.exec_mode, n.grouping,
                          n.grouping_names, n.aggs, n.agg_names, False)
        except NotImplementedError as e:
            raise SpmdUnsupported(f"host-path agg function in SPMD ({e})") \
                from e
        merge = n.exec_mode == "final"
        nk = agg.nk
        cols, rows = self._live_cols(t)
        if rows == 0:
            if nk == 0 and n.exec_mode != "partial":
                # a global aggregation over no rows still emits its
                # identity row (count 0, every other result null)
                b = agg._empty_global_agg(self.dev)
                return _dense(agg.schema, b.columns, 1, self.dev)
            return _empty_table(agg.schema, self.dev)
        t = _dense(t.schema, cols, rows, self.dev)
        keys = self._run(agg._key_eval, t)
        if merge:
            vcols = agg._state_slices(list(t.cols[nk:]))
        else:
            vals = self._run(agg._val_eval, t)
            vcols = [vals[s:e] for s, e in agg._arg_slices]
        cols, n_groups, cap = group_reduce(keys, vcols, rows, agg.specs,
                                           merge, self.dev)
        if nk:
            self.syncs += 1          # group_reduce reads the group count
        b = Batch(agg.state_schema, cols, n_groups, cap)
        if n.exec_mode != "partial":
            b = agg._finalize(b)
        return _dense(b.schema, b.columns, n_groups, self.dev)

    # joins -------------------------------------------------------------------

    def _do_broadcast_join(self, n: P.BroadcastJoin) -> DeviceTable:
        # a broadcast build's unmatched rows would repeat on every device
        # of a mesh, so full and right broadcast joins are rejected
        return self._join(n.left, n.right, n.on, n.join_type,
                          build_side=n.broadcast_side,
                          existence_name=n.existence_output_name)

    def _do_hash_join(self, n: P.HashJoin) -> DeviceTable:
        # both sides hash-colocated on the join keys (precheck_plan)
        return self._join(n.left, n.right, n.on, n.join_type,
                          build_side=n.build_side,
                          existence_name=n.existence_output_name,
                          colocated=True)

    def _do_broadcast_join_build_hash_map(self, n) -> DeviceTable:
        return self.eval_node(n.child)

    def _do_sort_merge_join(self, n: P.SortMergeJoin) -> DeviceTable:
        # both sides colocated on their keys (precheck_plan); the sorts
        # under it are no-ops here, the hash kernel needs no key order
        return self._join(n.left, n.right, n.on, n.join_type,
                          build_side="right",
                          existence_name=n.existence_output_name,
                          colocated=True)

    def _join(self, left_ir, right_ir, on, join_type: str,
              build_side: str, existence_name: str = "exists",
              colocated: bool = False) -> DeviceTable:
        allowed = self._JOIN_TYPES_COLOCATED if colocated \
            else self._JOIN_TYPES
        if join_type not in allowed:
            raise SpmdUnsupported(f"SPMD join type {join_type!r}")
        if build_side != "right":
            raise SpmdUnsupported("SPMD join requires build_side=right")
        probe = self.eval_node(left_ir)
        build = self.eval_node(right_ir)
        pkeys = self._eval_exprs(on.left_keys, probe)
        bkeys = self._eval_exprs(on.right_keys, build)
        dev = self.dev
        join_probe_strategy()
        bh, bvalid = join_key_hash(bkeys)
        bh = torch.where(build.live & bvalid, bh, NULL_BUILD)
        perm = stable_hash_argsort(bh)
        ph, pvalid = join_key_hash(pkeys)
        lo, counts = probe_ranges(bh[perm], ph, pvalid, probe.live)
        # every candidate pair at once, exactly sized by their count
        total = self._read(counts.sum())
        if total:
            probe_idx, offset, _ = expand_pairs(lo, counts, 0, total)
            build_idx = perm[torch.clamp(lo[probe_idx] + offset, 0,
                                         build.capacity - 1)]
        else:
            probe_idx = build_idx = torch.zeros(0, dtype=torch.int64,
                                                device=dev)
        ok = verify_pairs(pkeys, bkeys, probe_idx, build_idx,
                          torch.ones(total, dtype=torch.bool, device=dev))
        schema = join_output_schema(probe.schema, build.schema, join_type,
                                    existence_name)
        if join_type in ("left_semi", "left_anti", "existence"):
            matched = mark_matched(torch.zeros(probe.capacity,
                                               dtype=torch.bool, device=dev),
                                   probe_idx, ok)
            if join_type == "existence":
                exists = DeviceColumn(DataType.bool_(), matched & probe.live,
                                      torch.ones_like(matched))
                return DeviceTable(schema, list(probe.cols) + [exists],
                                   probe.live, probe.dense)
            keep = matched if join_type == "left_semi" else ~matched
            return DeviceTable(schema, list(probe.cols), probe.live & keep)
        kept, _ = self._nonzero(ok)
        pi, bi = probe_idx[kept], build_idx[kept]
        if join_type in ("left", "full"):
            # unmatched probe rows emit once each, with null build
            # columns, at their place in probe order
            matched = mark_matched(torch.zeros(probe.capacity,
                                               dtype=torch.bool, device=dev),
                                   probe_idx, ok)
            um, n_um = self._nonzero(probe.live & ~matched)
            rows = torch.cat([pi, um])
            order = torch.sort(rows, stable=True).indices
            pi = rows[order]
            has = torch.cat([torch.ones_like(bi, dtype=torch.bool),
                             torch.zeros(n_um, dtype=torch.bool,
                                         device=dev)])[order]
            bi = torch.cat([bi, torch.zeros_like(um)])[order]
            bcols = [c.gather(bi, has) for c in build.cols]
        else:
            bcols = [c.take(bi) for c in build.cols]
        cols = [c.take(pi) for c in probe.cols] + bcols
        n_out = int(pi.shape[0])
        if join_type in ("right", "full"):
            # the build rows no probe row matched, after the pairs
            bmatched = mark_matched(torch.zeros(build.capacity,
                                                dtype=torch.bool,
                                                device=dev), build_idx, ok)
            bum, n_bum = self._nonzero(build.live & ~bmatched)
            tail = [null_column(f.dtype, n_bum, dev)
                    for f in probe.schema] + [c.take(bum)
                                              for c in build.cols]
            cols = [concat_device_columns([a, b])
                    for a, b in zip(cols, tail)]
            n_out += n_bum
        return _dense(schema, cols, n_out, dev)

    # sort / limit -------------------------------------------------------
    #
    # Operator order matters only at the emission, which the host tail
    # re-establishes.  A mid-plan sort with no fetch limit is a no-op; one
    # with a fetch limit is a top-k mask (rows keep their places, the rest
    # go dead), skipped when the tail's global sort shadows it.

    def _do_sort(self, n: P.Sort) -> DeviceTable:
        if n.fetch_limit is None:
            return self.eval_node(n.child)
        s = self.shadow_sort
        if s is not None and s.fetch_limit is not None and \
                s.fetch_limit <= n.fetch_limit and \
                s.sort_exprs == n.sort_exprs[:len(s.sort_exprs)]:
            return self.eval_node(n.child)
        t = self.eval_node(n.child)
        keys = self._eval_exprs(tuple(x.child for x in n.sort_exprs), t)
        orders = tuple((x.asc, x.nulls_first) for x in n.sort_exprs)
        perm = lexsort_indices_live(encode_sort_keys(keys, orders), t.live,
                                    encode_sort_keys_bits(keys))
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(t.capacity, device=self.dev)
        # Spark's fetch: rows [offset, offset + limit) of the order (the
        # JAX package's stage path drops the offset, ROADMAP Queue 3)
        off = n.fetch_offset
        return DeviceTable(t.schema, t.cols, t.live & (rank >= off) &
                           (rank < off + n.fetch_limit))

    def _do_limit(self, n: P.Limit) -> DeviceTable:
        # a limit over the device's row order: a sort below it would make
        # the prefix order-dependent, which the serial engine computes
        for node in _walk_native(n.child, self):
            if node.kind == "sort":
                raise SpmdUnsupported(
                    "limit over a sorted input is order-sensitive")
        t = self.eval_node(n.child)
        live_rank = torch.cumsum(t.live.to(torch.int64), 0)   # 1-based
        return DeviceTable(t.schema, t.cols, t.live &
                           (live_rank > n.offset) &
                           (live_rank <= n.offset + n.limit))

    # window -------------------------------------------------------------

    def _do_window(self, n: P.Window) -> DeviceTable:
        if not _window_ok(n, self.exchanges):
            raise SpmdUnsupported(
                "window needs a colocating exchange (hash on a subset of "
                "its partition keys, or single) under it")
        t = self.eval_node(n.child)
        try:
            w = WindowExec(_SchemaOnly(t.schema), n.window_funcs,
                           n.partition_by, n.order_by, n.group_limit,
                           n.output_window_cols)
        except (NotImplementedError, ValueError) as e:
            raise SpmdUnsupported(str(e)) from e
        cols, rows = self._live_cols(t)
        if rows == 0:
            return _empty_table(w.schema, self.dev)
        # the serial operator's sort and scans over one padded batch
        cap = bucket_capacity(rows)
        idx = torch.arange(cap, device=self.dev)
        merged = Batch(t.schema, cols, rows, rows).gather(
            torch.where(idx < rows, idx, 0), rows)
        out = w.window_batch(merged)
        if out is None:
            return _empty_table(w.schema, self.dev)
        if n.group_limit is not None:
            self.syncs += 1          # the group limit's compaction
        return _dense(out.schema, out.columns, out.num_rows, self.dev)


# ---------------------------------------------------------------------------
# acceptance rules: the JAX package's, with its reasons
# ---------------------------------------------------------------------------

def _feeding_exchange(node, exchanges):
    """The exchange Partitioning feeding `node`, looking through
    row-preserving pass-through ops (coalesce/debug); None otherwise."""
    child = node.child
    while isinstance(child, (P.CoalesceBatches, P.Debug)):
        child = child.child
    if isinstance(child, P.IpcReader) and child.resource_id in exchanges:
        return exchanges[child.resource_id].partitioning
    return None


def _colocating(part, keys) -> bool:
    """True when `part` guarantees rows with equal `keys` land on one
    device: a single-partition exchange, or a hash exchange whose
    expressions are a subset of `keys`."""
    if part is None:
        return False
    if part.mode == "single":
        return True
    if part.mode == "hash":
        ks = set(keys)
        return all(e in ks for e in (part.expressions or ()))
    return False


def _single_agg_ok(agg, exchanges) -> bool:
    """A single-mode agg is per-partition: admitted when the exchange
    feeding it colocates its grouping keys, or, for an ungrouped agg,
    after a round-robin exchange."""
    part = _feeding_exchange(agg, exchanges)
    if part is None:
        return False
    if _colocating(part, agg.grouping):
        return True
    if part.mode == "round_robin":
        return not agg.grouping
    return False


def _key_positions(part, keys):
    """The index set of `keys` a partitioning hashes on, or None when it
    gives no colocation guarantee for `keys`.  single -> empty set."""
    if part is None:
        return None
    if part.mode == "single":
        return frozenset()
    if part.mode != "hash" or not part.expressions:
        return None
    keys = list(keys)
    try:
        return frozenset(keys.index(e) for e in part.expressions)
    except ValueError:
        return None


def _side_positions(node, keys, exchanges):
    """Colocation guarantee of one join side for `keys`, looked through
    distribution-preserving operators: fetch-less sorts, coalesce/debug,
    filters, grouped aggs (through their feeding exchange) and joins
    (the probe side's placement)."""
    while True:
        if isinstance(node, (P.CoalesceBatches, P.Debug, P.Filter)):
            node = node.child
            continue
        if isinstance(node, P.Sort) and node.fetch_limit is None:
            node = node.child
            continue
        break
    if isinstance(node, P.IpcReader) and node.resource_id in exchanges:
        return _key_positions(exchanges[node.resource_id].partitioning,
                              keys)
    if isinstance(node, P.Agg):
        return _key_positions(_feeding_exchange(node, exchanges), keys)
    if isinstance(node, (P.HashJoin, P.SortMergeJoin)):
        return _side_positions(node.left, keys, exchanges)
    if isinstance(node, P.BroadcastJoin):
        probe = node.left if node.broadcast_side == "right" else node.right
        return _side_positions(probe, keys, exchanges)
    return None


def _smj_colocated(n, exchanges) -> bool:
    """Equal join keys land on one device: both sides carry the same
    positional hash-key guarantee, or both funnel through single
    exchanges."""
    pl = _side_positions(n.left, tuple(n.on.left_keys), exchanges)
    pr = _side_positions(n.right, tuple(n.on.right_keys), exchanges)
    return pl is not None and pl == pr


def _window_ok(win, exchanges) -> bool:
    """Window partitions must be complete: the feeding exchange colocates
    the PARTITION BY keys (none: only a single exchange qualifies)."""
    return _colocating(_feeding_exchange(win, exchanges),
                       win.partition_by)


def _require_native(node) -> P.PlanNode:
    if not isinstance(node, P.PlanNode):
        raise SpmdUnsupported("foreign subtree inside SPMD stage")
    return node


def _walk_native(node, conv_ctx) -> Iterator[P.PlanNode]:
    """Every native plan node reachable from `node`, following exchange
    and broadcast readers into their children."""
    exchanges = getattr(conv_ctx, "exchanges", None) or {}
    broadcasts = getattr(conv_ctx, "broadcasts", None) or {}
    stack = [node]
    while stack:
        n = stack.pop()
        if not isinstance(n, P.PlanNode):
            continue
        yield n
        if isinstance(n, P.IpcReader):
            job = exchanges.get(n.resource_id) or \
                broadcasts.get(n.resource_id)
            if job is not None:
                stack.append(job.child)
            continue
        if isinstance(n, P.Union):
            pushed = set()           # one walk per child, not per partition
            for i in n.inputs:
                if id(i.child) not in pushed:
                    pushed.add(id(i.child))
                    stack.append(i.child)
            continue
        for c in n.children_nodes():
            stack.append(c)


# node kinds the executor can (conditionally) express; the scans are the
# JAX package's, which the port's plans never hold
_PRECHECK_OK = frozenset({
    "ffi_reader", "ipc_reader", "parquet_scan", "orc_scan", "filter",
    "projection", "rename_columns", "coalesce_batches", "debug", "agg",
    "broadcast_join", "hash_join", "broadcast_join_build_hash_map",
    "sort_merge_join", "sort", "limit", "union", "expand", "window",
})


def iter_spmd_rejections(plan, conv_ctx):
    """(node, reason) for every kind-level problem in the tree, in walk
    order: the enumerating form behind precheck_plan."""
    exchanges = getattr(conv_ctx, "exchanges", None) or {}
    for node in _walk_native(plan, conv_ctx):
        if node.kind not in _PRECHECK_OK:
            yield node, f"operator not SPMD-compilable: {node.kind}"
            continue
        if node.kind == "broadcast_join" and \
                node.join_type not in _StageTracer._JOIN_TYPES:
            yield node, f"SPMD broadcast-join type {node.join_type!r}"
        if node.kind in ("hash_join", "sort_merge_join"):
            if node.join_type not in _StageTracer._JOIN_TYPES_COLOCATED:
                yield node, f"SPMD join type {node.join_type!r}"
            elif not _smj_colocated(node, exchanges):
                yield (node,
                       "join sides are not hash-colocated on the join "
                       "keys")
        if node.kind == "agg" and node.exec_mode == "single" and \
                not _single_agg_ok(node, exchanges):
            yield (node, "single-mode agg needs an exchange (or "
                         "partial/final shape)")
        if node.kind == "window" and not _window_ok(node, exchanges):
            yield node, "window needs a colocating exchange under it"
        # (the limit-over-sort rejection is _do_limit's, at evaluation)


def precheck_plan(plan, conv_ctx) -> None:
    """The kind-level check, before any source is uploaded."""
    for _node, reason in iter_spmd_rejections(plan, conv_ctx):
        raise SpmdUnsupported(reason)


# ---------------------------------------------------------------------------
# the device-resident source cache
# ---------------------------------------------------------------------------

class _ByteBudgetLRU:
    """Byte-bounded LRU map: key -> (value, nbytes).  Eviction keeps at
    least one entry, so a single oversized value still caches."""

    def __init__(self):
        self._entries: "collections.OrderedDict[Any, Tuple[Any, int]]" = \
            collections.OrderedDict()
        self._bytes = 0

    def _budget(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _lookup(self, key):
        if self._entries and self._budget() <= 0:
            # a budget lowered to 0 releases every entry's device memory
            self.clear()
            return None
        e = self._entries.get(key)
        if e is None:
            return None
        self._entries.move_to_end(key)
        return e[0]

    def _evict_key(self, key) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e[1]

    def _store(self, key, value, nbytes: int) -> bool:
        budget = self._budget()
        if budget <= 0:
            return False
        self._evict_key(key)
        self._entries[key] = (value, nbytes)
        self._bytes += nbytes
        while self._bytes > budget and len(self._entries) > 1:
            old_key, (_v, b) = self._entries.popitem(last=False)
            self._bytes -= b
            self._dropped(old_key)
        return True

    def _dropped(self, key) -> None:
        """Hook: called for keys evicted by the byte budget."""

    def keys(self) -> List[Any]:
        """Keys, least recently used first."""
        return list(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0


class _DeviceSourceCache(_ByteBudgetLRU):
    """Source tables on the device, keyed by (table identity, device,
    schema, string layout).  A weak reference to the table evicts its
    entries once it is collected, so an id is never served to another
    table."""

    def __init__(self):
        super().__init__()
        self._tid_keys: Dict[int, set] = {}

    def _budget(self) -> int:
        return int(conf.get("auron.spmd.source.cache.mb")) << 20

    def _dropped(self, key) -> None:
        self._tid_keys.get(key[0], set()).discard(key)

    def _evict_tid(self, tid: int) -> None:
        for key in self._tid_keys.pop(tid, ()):
            self._evict_key(key)

    def get(self, table, key: Tuple) -> Optional[DeviceTable]:
        e = self._lookup((id(table),) + key)
        if e is None or e[0]() is not table:
            return None
        return e[1]

    def put(self, table, key: Tuple, value: DeviceTable,
            nbytes: int) -> None:
        tid = id(table)
        ref = weakref.ref(table, lambda _r, tid=tid: self._evict_tid(tid))
        full = (tid,) + key
        if self._store(full, (ref, value), nbytes):
            self._tid_keys.setdefault(tid, set()).add(full)

    def clear(self) -> None:
        super().clear()
        self._tid_keys.clear()


_DEVICE_SOURCES = _DeviceSourceCache()


def clear_source_caches() -> None:
    """Drop every device-resident source table."""
    _DEVICE_SOURCES.clear()


def _string_cfg() -> Tuple:
    return (int(conf.get("auron.string.device.max.width")),
            str(conf.get("auron.string.width.buckets")))


def _table_nbytes(t: DeviceTable) -> int:
    return sum(c.nbytes() for c in t.cols) + t.live.numel()


def _upload(src, schema: Schema, dev: torch.device,
            stats: Dict[str, int]) -> DeviceTable:
    """A source table on the device, through the cache."""
    if not hasattr(src, "columns"):
        raise TypeError(f"stage source of type {type(src).__name__}: want "
                        f"an ops.scan.ipc.SourceTable")
    key = (str(dev), schema, _string_cfg())
    hit = _DEVICE_SOURCES.get(src, key)
    if hit is not None:
        stats["source_cache_hits"] += 1
        return hit
    arrays, validities = src.columns(len(schema))
    n = len(arrays[0]) if len(arrays) else 0
    try:
        b = from_numpy(schema, arrays, validities, device=dev,
                       capacity=max(n, 1))
    except NotImplementedError as e:
        raise SpmdUnsupported("host-resident column in SPMD source") from e
    t = DeviceTable(schema, b.columns,
                    torch.arange(b.capacity, device=dev) < n, n > 0)
    nbytes = _table_nbytes(t)
    stats["bytes_uploaded"] += nbytes
    _DEVICE_SOURCES.put(src, key, t, nbytes)
    return t


def _source_schemas(plan, conv_ctx) -> Dict[str, Schema]:
    """rid -> schema of every FFI reader the plan reaches."""
    out: Dict[str, Schema] = {}
    for node in _walk_native(plan, conv_ctx):
        if node.kind == "ffi_reader":
            out.setdefault(node.resource_id, node.schema)
    return out


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

_GATHERED = "__spmd_gathered"


def execute_plan_stage(plan: P.PlanNode, conv_ctx, sources: Dict[str, Any],
                       device=None) -> ExecutionResult:
    """Evaluate a converted query over whole device tables.

    `sources` maps each FFI reader's resource id to its table (an
    `ops.scan.ipc.SourceTable`).  The root's tail of Projection, Sort,
    Limit and RenameColumns is peeled and replayed through the serial
    `execute_plan` over the gathered live rows (on the device), as
    Spark's final collect.  Returns the result batches, the result
    schema, and metrics: host_syncs, bytes_uploaded, source_cache_hits,
    gathered_rows.  Raises SpmdUnsupported for a plan it cannot
    express."""
    dev = resolve_device(device)
    exchanges = getattr(conv_ctx, "exchanges", None) or {}
    tail: List[P.PlanNode] = []
    shadow_sort: Optional[P.Sort] = None
    while isinstance(plan, (P.Projection, P.Sort, P.Limit,
                            P.RenameColumns)):
        tail.append(plan)
        if isinstance(plan, P.Sort) and shadow_sort is None:
            shadow_sort = plan
        plan = plan.child
    # a root single-mode exchange is the gather itself
    while isinstance(plan, P.IpcReader) and plan.resource_id in exchanges:
        job = exchanges[plan.resource_id]
        if job.partitioning.mode != "single":
            break
        plan = _require_native(job.child)
    precheck_plan(plan, conv_ctx)

    stats = {"host_syncs": 0, "bytes_uploaded": 0, "source_cache_hits": 0,
             "gathered_rows": 0}
    bindings = {rid: _upload(sources[rid], schema, dev, stats)
                for rid, schema in _source_schemas(plan, conv_ctx).items()
                if rid in sources}
    tracer = _StageTracer(conv_ctx, bindings, dev, shadow_sort)
    out = tracer.eval_node(plan)
    gathered = tracer.gather(out)
    stats["host_syncs"] = tracer.syncs
    stats["gathered_rows"] = gathered.num_rows
    batches = [gathered] if gathered.num_rows else []
    if not tail:
        return ExecutionResult(batches, out.schema, stats)
    replay: P.PlanNode = P.IpcReader(schema=out.schema, resource_id=_GATHERED)
    for node in reversed(tail):
        replay = dataclasses.replace(node, child=replay)
    res = ResourceRegistry()
    res.put(_GATHERED, batches)
    r = execute_plan(replay, resources=res, device=dev)
    return ExecutionResult(r.batches, r.schema, stats)
