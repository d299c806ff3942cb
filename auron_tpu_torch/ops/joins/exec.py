"""Join operators over the shared sorted-hash kernel (counterpart of
auron_tpu/ops/joins/exec.py).

Every join type of the reference: inner, left / right / full outer,
left / right semi, left / right anti and existence.  The build side is
materialized on the device; the probe side streams, one pair program a
chunk of `bucket_capacity(auron.batch.size)` candidate pairs, and the
outer variants track build-side matched flags.

Each chunk makes one host read, the packed (total pairs, pairs kept,
probe-side rows) of `kernel.pair_chunk`, as the JAX package reads one
3-vector a chunk; the compactions stay on the device
(`kernel.compact_padded`).  Chunk 0 computes the probe-side emission
too, so a probe batch of at most one chunk of pairs costs one read.

The sort-merge join is a memory consumer: under pressure the larger
of its cursors' buffers spills (ops/joins/smj.py), and a frontier window
of one key past `auron.smj.window.max.rows` escapes to
`_join_giant_group`, whose build chunks and probe rows of that key go
through the spill tiers.

Not in the port yet: the JAX package's eager probe over host columns
(the port keeps every column on the device) and its bucket-partitioned
probe index (`ops/strategy.py::join_probe_strategy`).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Tuple

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, DeviceColumn, bucket_capacity, concat_batches,
    concat_device_columns, empty_batch,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.plan import JoinOn
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.memmgr import MemConsumer, SpillManager
from auron_tpu_torch.ops.base import Operator, TaskContext, compact_indices
from auron_tpu_torch.ops.joins.kernel import (
    BuildTable, compact_padded, null_columns_like, pair_chunk, probe_range,
)

_PAIR_SIDES = {"inner", "left", "right", "full"}


def _nullable(fields) -> Tuple[Field, ...]:
    return tuple(Field(f.name, f.dtype, True) for f in fields)


def join_output_schema(left: Schema, right: Schema, join_type: str,
                       existence_name: str = "exists") -> Schema:
    if join_type == "inner":
        return Schema(left.fields + right.fields)
    if join_type == "left":
        return Schema(left.fields + _nullable(right.fields))
    if join_type == "right":
        return Schema(_nullable(left.fields) + right.fields)
    if join_type == "full":
        return Schema(_nullable(left.fields) + _nullable(right.fields))
    if join_type in ("left_semi", "left_anti"):
        return left
    if join_type in ("right_semi", "right_anti"):
        return right
    if join_type == "existence":
        return Schema(left.fields +
                      (Field(existence_name, DataType.bool_(), False),))
    raise ValueError(f"unknown join type {join_type!r}")


class _HashJoinBase(Operator):
    """Probe-side streaming join; build side materialized on the device."""

    def __init__(self, left: Operator, right: Operator, on: JoinOn,
                 join_type: str, build_side: str,
                 existence_name: str = "exists"):
        schema = join_output_schema(left.schema, right.schema, join_type,
                                    existence_name)
        super().__init__(schema, [left, right])
        self.on = on
        self.join_type = join_type
        self.build_side = build_side
        self.probe_is_left = build_side == "right"
        if join_type in ("left_semi", "left_anti", "existence") \
                and not self.probe_is_left:
            raise ValueError(f"{join_type} requires build_side=right")
        if join_type in ("right_semi", "right_anti") and self.probe_is_left:
            raise ValueError(f"{join_type} requires build_side=left")
        self._left_keys = build_evaluator(on.left_keys, left.schema)
        self._right_keys = build_evaluator(on.right_keys, right.schema)
        self._build_i = 0 if build_side == "left" else 1
        self._build_keys = self._left_keys if build_side == "left" \
            else self._right_keys
        self._probe_keys = self._right_keys if build_side == "left" \
            else self._left_keys

    # -- build --------------------------------------------------------------

    def _collect_build(self, ctx: TaskContext) -> BuildTable:
        batches = [b for b in self.child_stream(ctx, self._build_i)
                   if b.num_rows]
        return self._build_from_batches(batches, ctx)

    def _build_from_batches(self, batches: List[Batch],
                            ctx: TaskContext) -> BuildTable:
        """The build table over `batches`: their columns concatenated
        whole (padding included) under a live mask, so collecting the
        build side gathers nothing."""
        schema = self.children[self._build_i].schema
        self.count("build_hash_maps")
        if not batches:
            merged = empty_batch(schema, bucket_capacity(0), ctx.device)
            return BuildTable.build(merged, self._build_keys(merged))
        cols = [concat_device_columns([b.columns[i] for b in batches])
                for i in range(len(schema))]
        live = torch.cat([torch.arange(b.capacity, device=ctx.device) <
                          b.num_rows for b in batches])
        merged = Batch(schema, cols, sum(b.num_rows for b in batches),
                       int(live.shape[0]))
        return BuildTable.build(merged, self._build_keys(merged), live)

    def _get_build_table(self, ctx: TaskContext) -> BuildTable:
        return self._collect_build(ctx)

    # -- probe --------------------------------------------------------------

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        table = self._get_build_table(ctx)
        yield from self._probe_all(ctx, table,
                                   self.child_stream(ctx, 1 - self._build_i))

    def _probe_all(self, ctx: TaskContext, table: BuildTable,
                   probe_batches) -> Iterator[Batch]:
        """Probe every batch against the table, then emit the build rows
        no probe row matched (the outer side of the build)."""
        state = {"build_matched": torch.zeros(
            table.batch.capacity, dtype=torch.bool, device=ctx.device)}
        for b in probe_batches:
            if b.num_rows == 0:
                continue
            yield from self._probe_batch(b, self._probe_keys(b), table,
                                         state)
        if self._track_build():
            yield from self._emit_build_unmatched(table,
                                                  state["build_matched"])

    def _track_build(self) -> bool:
        jt = self.join_type
        return jt == "full" or (jt == "right" and self.probe_is_left) \
            or (jt == "left" and not self.probe_is_left)

    def _side_kind(self) -> str:
        """The probe-side emission, from the final probe-matched flags."""
        jt = self.join_type
        if jt == "full" or (jt == "left" and self.probe_is_left) \
                or (jt == "right" and not self.probe_is_left):
            return "unmatched"
        if jt in ("left_semi", "right_semi"):
            return "semi"
        if jt in ("left_anti", "right_anti"):
            return "anti"
        if jt == "existence":
            return "existence"
        return "none"

    def _pairs(self, probe_cols, build_cols, n: int, cap: int) -> Batch:
        """Probe-side and build-side columns as the output's left and
        right."""
        left, right = (probe_cols, build_cols) if self.probe_is_left \
            else (build_cols, probe_cols)
        return Batch(self.schema, list(left) + list(right), n, cap)

    def _probe_batch(self, b: Batch, pkeys, table: BuildTable,
                     state) -> Iterator[Batch]:
        emit_pairs = self.join_type in _PAIR_SIDES
        side_kind = self._side_kind()
        chunk_cap = bucket_capacity(int(conf.get("auron.batch.size")))
        lo, counts, total_dev = probe_range(pkeys, table.sorted_hashes,
                                            b.num_rows)
        probe_matched = torch.zeros(b.capacity, dtype=torch.bool,
                                    device=b.device)

        def run_chunk(start: int, is_final: bool):
            nonlocal probe_matched
            out = pair_chunk(
                b.columns, pkeys, table.batch.columns, table.key_cols, lo,
                counts, total_dev, table.perm, b.num_rows, probe_matched,
                state["build_matched"], start, chunk_cap,
                emit_pairs=emit_pairs, track_build=self._track_build(),
                side_kind=side_kind, is_final=is_final)
            probe_matched = out.probe_matched
            state["build_matched"] = out.build_matched
            self.count("probe_chunks")
            total, n_pairs, n_side = out.counts3.tolist()
            return out, total, n_pairs, n_side

        # chunk 0 computes the side emission too (one read when the batch
        # has at most one chunk of pairs); later chunks redo it on the
        # true final chunk
        out, total, n_pairs, n_side = run_chunk(0, is_final=True)
        if n_pairs:
            yield self._pairs(out.out_p, out.out_b, n_pairs, chunk_cap)
        for start in range(chunk_cap, total, chunk_cap):
            out, _, n_pairs, n_side = run_chunk(
                start, is_final=start + chunk_cap >= total)
            if n_pairs:
                yield self._pairs(out.out_p, out.out_b, n_pairs, chunk_cap)
        if side_kind == "existence":
            live = torch.arange(b.capacity, device=b.device) < b.num_rows
            ex = DeviceColumn(DataType.bool_(), probe_matched & live, live)
            yield Batch(self.schema, list(b.columns) + [ex], b.num_rows,
                        b.capacity)
        elif side_kind != "none" and n_side:
            if side_kind == "unmatched":
                other = self.children[self._build_i].schema
                nulls = null_columns_like(other, b.capacity, b.device)
                yield self._pairs(out.side_cols, nulls, n_side, b.capacity)
            else:
                yield Batch(self.schema, list(out.side_cols), n_side,
                            b.capacity)

    def _emit_build_unmatched(self, table: BuildTable, build_matched
                              ) -> Iterator[Batch]:
        b = table.batch
        idx, cnt = compact_padded(~build_matched & table.live, b.capacity)
        n = int(cnt)
        if n == 0:
            return
        probe = self.children[1 - self._build_i].schema
        yield self._pairs(null_columns_like(probe, b.capacity, b.device),
                          b.gather(idx, n).columns, n, b.capacity)


class HashJoinExec(_HashJoinBase):
    """Shuffled hash join: both sides already partitioned by the key."""

    def __init__(self, left, right, on, join_type, build_side="right",
                 existence_name="exists"):
        super().__init__(left, right, on, join_type, build_side,
                         existence_name)


class BroadcastJoinExec(_HashJoinBase):
    """Build side broadcast to every task of the stage.  Its table is
    built once and cached under `bhm:<cached_build_hash_map_id>` in the
    task's resources, which the stage's tasks share on the device.  On a
    miss a `BroadcastJoinBuildHashMapExec` build child builds and caches
    it; the JAX package then builds a second table from that child's
    output, which the port does not."""

    def __init__(self, left, right, on, join_type, broadcast_side="right",
                 cached_build_hash_map_id: str = "",
                 existence_name="exists"):
        super().__init__(left, right, on, join_type,
                         build_side=broadcast_side,
                         existence_name=existence_name)
        self.cache_id = cached_build_hash_map_id

    def _get_build_table(self, ctx: TaskContext) -> BuildTable:
        if not self.cache_id:
            return self._collect_build(ctx)
        key = f"bhm:{self.cache_id}"
        if ctx.resources.contains(key):
            return ctx.resources.get(key)
        build = self.children[self._build_i]
        table = build.build_table(ctx) \
            if isinstance(build, BroadcastJoinBuildHashMapExec) \
            else self._collect_build(ctx)
        ctx.resources.put(key, table)
        return table


class BroadcastJoinBuildHashMapExec(Operator):
    """The build-map stage: builds the table over the broadcast rows and
    caches it under `bhm:<cache_id>`; streams the rows it built over."""

    def __init__(self, child: Operator, keys, cache_id: str):
        super().__init__(child.schema, [child])
        self.keys = tuple(keys)
        self.cache_id = cache_id
        self._key_eval = build_evaluator(self.keys, child.schema)

    def build_table(self, ctx: TaskContext) -> BuildTable:
        batches = [b for b in self.child_stream(ctx) if b.num_rows]
        merged = concat_batches(self.schema, batches) if batches else \
            empty_batch(self.schema, bucket_capacity(0), ctx.device)
        self.count("build_hash_maps")
        table = BuildTable.build(merged, self._key_eval(merged))
        ctx.resources.put(f"bhm:{self.cache_id}", table)
        return table

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        table = self.build_table(ctx)
        if table.batch.num_rows:
            yield table.batch


class SortMergeJoinExec(_HashJoinBase, MemConsumer):
    """Sort-merge join of two key-sorted inputs.  Streaming (the default,
    `auron.smj.streaming.enable`): a frontier, the smaller of the two
    sides' last buffered keys, bounds each window, and the complete key
    groups below it are joined window by window with the hash kernel, so
    resident rows are about one batch per side plus the largest key
    group (ops/joins/smj.py), and the buffers spill under pressure.
    Otherwise the build side is materialized whole and the other side
    probes it."""

    def __init__(self, left, right, on, join_type, sort_options=(),
                 existence_name="exists"):
        build_side = "left" if join_type in ("right_semi", "right_anti") \
            else "right"
        super().__init__(left, right, on, join_type, build_side,
                         existence_name)
        MemConsumer.__init__(self, "SortMergeJoinExec")
        self.sort_options = tuple(tuple(o) for o in sort_options) or \
            tuple((True, True) for _ in on.left_keys)
        self._spills = SpillManager("smj")
        self._cursors: list = []

    # -- MemConsumer ----------------------------------------------------

    def spill(self) -> int:
        cursors = sorted((c for c in self._cursors if c.mem_bytes > 0),
                         key=lambda c: c.mem_bytes, reverse=True)
        for cur in cursors:     # a cursor mid-iteration refuses; try next
            freed = cur.spill_mem()
            if freed:
                self.update_mem_used(
                    sum(c.mem_bytes for c in self._cursors))
                return freed
        return 0

    # -- execution ------------------------------------------------------

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        if bool(conf.get("auron.smj.streaming.enable")):
            yield from self._execute_streaming(ctx)
        else:
            yield from super().execute(ctx)

    def _execute_streaming(self, ctx: TaskContext) -> Iterator[Batch]:
        from auron_tpu_torch.ops.joins.smj import SideCursor
        key_evals = (self._left_keys, self._right_keys)
        cursors = [SideCursor(self.child_stream(ctx, i), key_evals[i],
                              self.sort_options, self._spills, self)
                   for i in (0, 1)]
        self._cursors = cursors
        build_cur = cursors[self._build_i]
        probe_cur = cursors[1 - self._build_i]
        try:
            with self.mem_scope(ctx):
                for c in cursors:
                    c.advance()
                self.update_mem_used(sum(c.mem_bytes for c in cursors))
                while True:
                    if all(c.exhausted for c in cursors):
                        if any(not c.empty for c in cursors):
                            yield from self._join_window(
                                build_cur, probe_cur, None, ctx)
                        return
                    frontier = min(c.boundary for c in cursors
                                   if not c.exhausted)
                    self.count("smj_windows")
                    yield from self._join_window(build_cur, probe_cur,
                                                 frontier, ctx)
                    for c in cursors:
                        if not c.exhausted and c.boundary == frontier:
                            c.advance()
                    self.update_mem_used(sum(c.mem_bytes for c in cursors))
        finally:
            self._cursors = []
            self._spills.release_all()

    def _join_window(self, build_cur, probe_cur, frontier,
                     ctx: TaskContext) -> Iterator[Batch]:
        """Join the buffered rows strictly below the frontier: complete
        key groups, so every join type's emissions are window-local.  A
        build window past `auron.smj.window.max.rows` that holds one key
        escapes to `_join_giant_group`; a window of several keys keeps
        this path."""
        from auron_tpu_torch.ops.joins.smj import host_keys_of_rows
        cap_rows = int(conf.get("auron.smj.window.max.rows"))
        build_iter = build_cur.iter_ready(frontier)
        build_batches: List[Batch] = []
        got = 0
        kf = None           # the window's first key, read once past the cap
        multi_key = False   # latched: a window of several keys stays one
        for b in build_iter:
            build_batches.append(b)
            got += b.num_rows
            if cap_rows and got > cap_rows and not multi_key:
                if kf is None:
                    [kf] = host_keys_of_rows(
                        build_cur.keys_of(build_batches[0]), [0],
                        self.sort_options)
                [kl] = host_keys_of_rows(build_cur.keys_of(b),
                                         [b.num_rows - 1],
                                         self.sort_options)
                if kf == kl:
                    self.count("giant_group_escapes")
                    yield from self._join_giant_group(
                        ctx, build_batches, build_iter, probe_cur,
                        frontier, kf)
                    return
                multi_key = True
        yield from self._join_materialized(
            ctx, build_batches, probe_cur.iter_ready(frontier))

    def _join_materialized(self, ctx: TaskContext, build_batches,
                           probe_batches) -> Iterator[Batch]:
        """A window's join: a table over `build_batches`, every batch of
        `probe_batches` probing it."""
        if not build_batches and self.join_type in (
                "inner", "left_semi", "right_semi"):
            for _ in probe_batches:     # drain: no row can come out
                pass
            return
        table = self._build_from_batches(list(build_batches), ctx)
        yield from self._probe_all(ctx, table, probe_batches)

    def _join_giant_group(self, ctx: TaskContext, head_batches,
                          build_iter, probe_cur, frontier,
                          key) -> Iterator[Batch]:
        """The bounded join of a single-key window that outgrew
        `auron.smj.window.max.rows` (the all-ties shape).  Every row of
        the group has one key, so matching is set logic: with a non-null
        key and both sides' groups non-empty, every build row matches
        every probe row.  The group's build rows spill in chunks of
        about a quarter of the cap, its probe rows once; the pair join
        types emit each chunk's cross product with each probe batch,
        and the semi, anti, existence and outer emissions follow from
        the two groups' sizes.  The window's rows of other keys join
        normally at the end.  Resident memory is one chunk and one
        batch, whatever the group's size."""
        from auron_tpu_torch.ops.joins.smj import rows_equal_key
        orders = self.sort_options
        jt = self.join_type
        bs = int(conf.get("auron.batch.size"))

        def take(b: Batch, mask: torch.Tensor):
            idx, n = compact_indices(mask[:b.num_rows])
            cap = bucket_capacity(n)
            return b.gather(torch.nn.functional.pad(idx, (0, cap - n)),
                            n) if n else None

        def split_eq(b: Batch, key_eval):
            eq = rows_equal_key(key_eval(b), key, orders)
            return take(b, eq), take(b, ~eq)

        # 1. the build window: the key's rows spill in chunks, other keys
        # stay for the residual window
        cap_rows = int(conf.get("auron.smj.window.max.rows"))
        chunk_target = max(cap_rows // 4, bs)
        build_spills = []
        chunk: List[Batch] = []
        residual_build: List[Batch] = []
        b_k = 0
        key_is_null = None

        def flush_chunk():
            if chunk:
                sp = self._spills.new_spill()
                self.count_spill(sp, sp.write_batches(chunk))
                build_spills.append(sp)
                chunk.clear()

        for b in itertools.chain(head_batches, build_iter):
            gk, rest = split_eq(b, self._build_keys)
            if gk is not None:
                if key_is_null is None:
                    key_is_null = not all(
                        bool(c.validity[0]) for c in self._build_keys(gk))
                b_k += gk.num_rows
                chunk.append(gk)
                if sum(x.num_rows for x in chunk) >= chunk_target:
                    flush_chunk()
            if rest is not None:
                residual_build.append(rest)
        flush_chunk()

        # 2. the probe window's rows of the key spill once
        probe_spill = self._spills.new_spill()
        residual_probe: List[Batch] = []
        p_k = 0

        def probe_rows():
            nonlocal p_k
            for b in probe_cur.iter_ready(frontier):
                gk, rest = split_eq(b, self._probe_keys)
                if gk is not None:
                    p_k += gk.num_rows
                    yield gk
                if rest is not None:
                    residual_probe.append(rest)
        self.count_spill(probe_spill, probe_spill.write_batches(
            probe_rows()))

        matched_probe = not key_is_null and b_k > 0
        matched_build = not key_is_null and p_k > 0
        side_kind = self._side_kind()
        build_schema = self.children[self._build_i].schema
        probe_schema = self.children[1 - self._build_i].schema

        # 3. the pair join types: each chunk x each probe batch
        if jt in _PAIR_SIDES and matched_probe and p_k > 0:
            for sp in build_spills:
                parts = list(sp.read_batches())
                cb = parts[0] if len(parts) == 1 else \
                    concat_batches(build_schema, parts)
                c = cb.num_rows
                for pb in probe_spill.read_batches():
                    p = pb.num_rows
                    step = max(1, bs // p)
                    for off in range(0, c, step):
                        m = min(step, c - off)
                        n = p * m
                        cap = bucket_capacity(n)
                        pad = (0, cap - n)
                        pi = torch.arange(p, device=pb.device).repeat(m)
                        bi = torch.arange(off, off + m, device=cb.device) \
                            .repeat_interleave(p)
                        yield self._pairs(
                            pb.gather(torch.nn.functional.pad(pi, pad),
                                      n).columns,
                            cb.gather(torch.nn.functional.pad(bi, pad),
                                      n).columns, n, cap)

        # the probe side's emissions over its rows of the key
        if p_k > 0:
            for pb in probe_spill.read_batches():
                live = torch.arange(pb.capacity, device=pb.device) < \
                    pb.num_rows
                if side_kind == "unmatched" and not matched_probe:
                    yield self._pairs(
                        pb.columns, null_columns_like(
                            build_schema, pb.capacity, pb.device),
                        pb.num_rows, pb.capacity)
                elif (side_kind == "semi" and matched_probe) or \
                        (side_kind == "anti" and not matched_probe):
                    yield Batch(self.schema, list(pb.columns), pb.num_rows,
                                pb.capacity)
                elif side_kind == "existence":
                    ex = DeviceColumn(DataType.bool_(),
                                      live & matched_probe, live)
                    yield Batch(self.schema, list(pb.columns) + [ex],
                                pb.num_rows, pb.capacity)

        # the build side's null extension when no probe row matched
        if self._track_build() and not matched_build and b_k > 0:
            for sp in build_spills:
                for cb in sp.read_batches():
                    yield self._pairs(null_columns_like(
                        probe_schema, cb.capacity, cb.device), cb.columns,
                        cb.num_rows, cb.capacity)
        for sp in build_spills:
            sp.release()
        probe_spill.release()

        # 4. the residual window: every other key below the frontier
        if residual_build or residual_probe:
            yield from self._join_materialized(ctx, residual_build,
                                               iter(residual_probe))
