"""The analyzer's pass battery and PassManager (counterpart of
auron_tpu/analysis/passes.py).

Each pass walks the plan tree through the shared SchemaContext and emits
structured diagnostics; none raises on a malformed plan.

- schema-check        bottom-up schema inference against declared schemas
- column-resolution   every column reference resolves in its scope
- partitioning        exchange and partitioning contracts (union
                      mappings, sort-merge join options, partial/final
                      aggregate pairing, ...)
- fusion              FusedFragment legality (analysis/fusion.py)
- adaptive            broadcast-join contracts (analysis/adaptive.py)
- tpu-lint            advisories (warnings, never errors): a key of a
                      host-resident type
- serde-roundtrip     to_dict/from_dict fixpoint of the whole tree

The pass ids are the JAX package's, so both verifiers report one plan's
findings under the same (pass, severity, node path).  The JAX package's
tpu-lint also warns of a `coalesce_batches` target off the TPU's
(8, 128) tile and tells of the TPU's float64 demotion of a hash key;
those describe a TPU, and this battery states no such rule.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Sequence, Tuple

from auron_tpu_torch.analysis.diagnostics import (
    AnalysisResult, DiagnosticSink, PlanVerificationError,
)
from auron_tpu_torch.analysis.schema_infer import (
    SchemaContext, agg_state_arity,
)
from auron_tpu_torch.exprs.typing import promote
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.node import Node
from auron_tpu_torch.ir.schema import DataType, Schema, TypeId


class Pass:
    """One analysis over the plan tree."""

    id: str = "pass"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        raise NotImplementedError


class SchemaCheckPass(Pass):
    """Publishes the inference diagnostics (the inference runs in
    SchemaContext, so that every pass shares its schemas)."""

    id = "schema-check"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        sink.diagnostics.extend(ctx.sink.diagnostics)


def _collect_refs(expr, out: List) -> None:
    """The column references of an expression."""
    if getattr(expr, "kind", None) == "column":
        out.append(expr)
        return
    for c in expr.children_nodes():
        if isinstance(c, Node):
            _collect_refs(c, out)


class ColumnResolutionPass(Pass):
    id = "column-resolution"

    def _check(self, exprs: Iterable, schema: Optional[Schema], node,
               path: str, what: str, sink: DiagnosticSink) -> None:
        if schema is None:
            return   # inference already failed upstream of here
        for e in exprs:
            if e is None:
                continue
            refs: List = []
            _collect_refs(e, refs)
            for r in refs:
                try:
                    schema.index_of(r.name)
                except KeyError:
                    names = ", ".join(schema.names()[:12])
                    sink.error(
                        self.id, path, node,
                        f"{what}: column {r.name!r} not found in input "
                        f"schema",
                        hint=f"available: {names}"
                             + (", ..." if len(schema) > 12 else ""))

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        for node, path in ctx.nodes():
            k = node.kind
            child = ctx.schema_of(node.child) \
                if getattr(node, "child", None) is not None else None
            if k == "projection":
                self._check(node.exprs, child, node, path, "exprs", sink)
            elif k == "filter":
                self._check(node.predicates, child, node, path,
                            "predicates", sink)
            elif k == "sort":
                self._check((s.child for s in node.sort_exprs), child,
                            node, path, "sort_exprs", sink)
            elif k == "agg":
                self._check(node.grouping, child, node, path,
                            "grouping", sink)
                if node.exec_mode != "final":
                    # a final aggregate's AggExpr children name the
                    # partial stage's inputs, which its state schema
                    # does not hold
                    for a in node.aggs:
                        self._check(a.children, child, node, path,
                                    f"agg {a.fn!r} args", sink)
                for a in node.aggs:
                    if a.fn == "wire_udaf" and a.wire is None:
                        sink.error(self.id, path, node,
                                   "agg fn 'wire_udaf' without a wire "
                                   "definition")
            elif k == "expand":
                for i, proj in enumerate(node.projections):
                    self._check(proj, child, node, path,
                                f"projections[{i}]", sink)
            elif k == "window":
                self._check(node.partition_by, child, node, path,
                            "partition_by", sink)
                self._check((s.child for s in node.order_by), child,
                            node, path, "order_by", sink)
                for wf in node.window_funcs:
                    self._check(wf.args, child, node, path,
                                f"window fn {wf.fn!r} args", sink)
                    if wf.agg is not None:
                        self._check(wf.agg.children, child, node, path,
                                    f"window agg {wf.agg.fn!r} args", sink)
            elif k in ("sort_merge_join", "hash_join", "broadcast_join"):
                if node.on is not None:
                    self._check(node.on.left_keys, ctx.schema_of(node.left),
                                node, path, "on.left_keys", sink)
                    self._check(node.on.right_keys,
                                ctx.schema_of(node.right), node, path,
                                "on.right_keys", sink)
            elif k == "broadcast_join_build_hash_map":
                self._check(node.keys, child, node, path, "keys", sink)
            elif k == "rss_shuffle_writer":
                if node.partitioning is not None:
                    self._check(node.partitioning.expressions, child,
                                node, path, "partitioning.expressions",
                                sink)
                    self._check(
                        (s.child for s in node.partitioning.sort_orders),
                        child, node, path, "partitioning.sort_orders",
                        sink)
            elif k in ("parquet_scan", "orc_scan"):
                base = getattr(node, "schema", None)
                if isinstance(base, Schema):
                    for i in node.projection:
                        if not (0 <= i < len(base)):
                            sink.error(
                                self.id, path, node,
                                f"projection index {i} out of range for "
                                f"file schema arity {len(base)}")
                    self._check((node.predicate,), base, node, path,
                                "predicate", sink)


_PARTITIONING_MODES = ("hash", "round_robin", "single", "range")

# nodes a partial->final aggregate pairing stays visible through; an
# exchange reader ends it.  A fused_fragment is transparent through its
# `child`: its body holds only row-local operators, never an agg.
_AGG_TRANSPARENT = ("coalesce_batches", "debug", "sort", "limit",
                    "fused_fragment")


class PartitioningContractsPass(Pass):
    id = "partitioning"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        if isinstance(ctx.root, P.TaskDefinition):
            self._task_definition(ctx.root, sink)
        for node, path in ctx.nodes():
            k = node.kind
            if k == "rss_shuffle_writer":
                self._partitioning(node, node.partitioning, path, sink)
            elif k == "union":
                self._union(node, path, sink)
            elif k == "sort_merge_join":
                self._join_keys(node, path, sink, ctx)
                n_keys = len(node.on.left_keys) if node.on else 0
                if node.sort_options and \
                        len(node.sort_options) != n_keys:
                    sink.error(
                        self.id, path, node,
                        f"{len(node.sort_options)} sort_options for "
                        f"{n_keys} join keys",
                        hint="one (asc, nulls_first) pair per JoinOn key")
            elif k in ("hash_join", "broadcast_join"):
                self._join_keys(node, path, sink, ctx)
                side = getattr(node, "build_side",
                               getattr(node, "broadcast_side", None))
                if side not in ("left", "right"):
                    sink.error(self.id, path, node,
                               f"invalid build/broadcast side {side!r}")
            elif k == "agg":
                self._agg_pairing(node, path, sink, ctx)
            elif k == "empty_partitions":
                if node.num_partitions < 1:
                    sink.error(self.id, path, node,
                               f"num_partitions={node.num_partitions} "
                               f"must be >= 1")

    def _task_definition(self, td: P.TaskDefinition,
                         sink: DiagnosticSink) -> None:
        if td.num_partitions < 1:
            sink.error(self.id, "", td,
                       f"num_partitions={td.num_partitions} must be >= 1")
        elif not (0 <= td.partition_id < td.num_partitions):
            sink.error(
                self.id, "", td,
                f"partition_id {td.partition_id} out of range for "
                f"num_partitions {td.num_partitions}")

    def _partitioning(self, node, part: Optional[P.Partitioning],
                      path: str, sink: DiagnosticSink) -> None:
        if part is None:
            sink.error(self.id, path, node,
                       "shuffle writer without a partitioning")
            return
        if part.mode not in _PARTITIONING_MODES:
            sink.error(self.id, path, node,
                       f"unknown partitioning mode {part.mode!r}",
                       hint=f"one of {_PARTITIONING_MODES}")
            return
        if part.num_partitions < 1:
            sink.error(self.id, path, node,
                       f"partitioning.num_partitions="
                       f"{part.num_partitions} must be >= 1")
        if part.mode == "hash" and not part.expressions:
            sink.error(self.id, path, node,
                       "hash partitioning without key expressions",
                       hint="use mode='round_robin' for keyless "
                            "redistribution")
        if part.mode == "range" and not part.sort_orders:
            sink.error(self.id, path, node,
                       "range partitioning without sort_orders")
        if part.mode == "single" and part.num_partitions != 1:
            sink.error(
                self.id, path, node,
                f"single partitioning with num_partitions="
                f"{part.num_partitions}",
                hint="single-mode exchanges collapse to exactly one "
                     "output partition")

    def _union(self, node: P.Union, path: str,
               sink: DiagnosticSink) -> None:
        if node.num_partitions < 1:
            sink.error(self.id, path, node,
                       f"num_partitions={node.num_partitions} must be "
                       f">= 1")
            return
        if not (0 <= node.cur_partition < node.num_partitions):
            sink.error(
                self.id, path, node,
                f"cur_partition {node.cur_partition} out of range for "
                f"num_partitions {node.num_partitions}")
        for i, inp in enumerate(node.inputs):
            where = f"{path}.inputs[{i}]" if path else f"inputs[{i}]"
            if not (0 <= inp.out_partition < node.num_partitions):
                sink.error(
                    self.id, where, inp,
                    f"out_partition {inp.out_partition} out of range for "
                    f"union num_partitions {node.num_partitions}")
            if inp.partition < 0:
                sink.error(self.id, where, inp,
                           f"negative child partition {inp.partition}")

    def _join_keys(self, node, path: str, sink: DiagnosticSink,
                   ctx: SchemaContext) -> None:
        """Co-partitioning: both sides keyed by the same number of
        comparably typed expressions."""
        on = node.on
        if on is None:
            sink.error(self.id, path, node, "join without JoinOn keys")
            return
        if len(on.left_keys) != len(on.right_keys):
            sink.error(
                self.id, path, node,
                f"{len(on.left_keys)} left keys vs "
                f"{len(on.right_keys)} right keys",
                hint="both sides must be partitioned by the same key "
                     "tuple")
            return
        left = ctx.schema_of(node.left)
        right = ctx.schema_of(node.right)
        if left is None or right is None:
            return
        for i, (lk, rk) in enumerate(zip(on.left_keys, on.right_keys)):
            lt = ctx._etype(lk, left, path, node, f"left key {i}")
            rt = ctx._etype(rk, right, path, node, f"right key {i}")
            if lt.id == TypeId.NULL or rt.id == TypeId.NULL or lt == rt:
                continue
            try:
                promote(lt, rt)
            except Exception:  # noqa: BLE001 - the finding itself
                sink.error(
                    self.id, path, node,
                    f"join key {i} types are incomparable: "
                    f"{lt!r} vs {rt!r}",
                    hint="insert a cast on one side so both keys "
                         "hash/compare identically")

    def _agg_pairing(self, node: P.Agg, path: str, sink: DiagnosticSink,
                     ctx: SchemaContext) -> None:
        if node.exec_mode == "final":
            # (a) with the partial visible in the same tree (the exchange
            # elided), the pair must agree on shape
            partner = self._visible_descendant_agg(node)
            if partner is not None:
                if partner.exec_mode != "partial":
                    sink.error(
                        self.id, path, node,
                        f"final agg feeds from a {partner.exec_mode!r} "
                        f"agg; expected 'partial'",
                        hint="two-phase aggregation pairs exec_mode="
                             "'partial' below the exchange with 'final' "
                             "above it")
                else:
                    if len(partner.grouping) != len(node.grouping):
                        sink.error(
                            self.id, path, node,
                            f"final agg groups by {len(node.grouping)} "
                            f"keys, partial by {len(partner.grouping)}")
                    if [a.fn for a in partner.aggs] != \
                            [a.fn for a in node.aggs]:
                        sink.error(
                            self.id, path, node,
                            f"final agg fns "
                            f"{[a.fn for a in node.aggs]} != partial "
                            f"{[a.fn for a in partner.aggs]}")
            # (b) always: the input arity is the partial state layout,
            # keys + state slots (across exchange readers too, whose
            # declared schema is the partial output)
            child = ctx.schema_of(node.child)
            if child is not None:
                want = len(node.grouping) + \
                    sum(agg_state_arity(a) for a in node.aggs)
                if len(child) != want:
                    sink.error(
                        self.id, path, node,
                        f"final agg input has {len(child)} columns; the "
                        f"partial state layout needs {want} "
                        f"({len(node.grouping)} keys + "
                        f"{want - len(node.grouping)} state slots)",
                        hint="the exchange below a final agg must carry "
                             "the partial agg's key+state columns "
                             "unchanged")
        elif node.exec_mode == "partial":
            partner = self._visible_descendant_agg(node)
            if partner is not None and partner.exec_mode == "partial":
                sink.error(
                    self.id, path, node,
                    "partial agg stacked directly on another partial agg",
                    hint="a partial stage must be finalized (or merged) "
                         "before re-aggregating")

    @staticmethod
    def _visible_descendant_agg(node: P.Agg) -> Optional[P.Agg]:
        cur = node.child
        while cur is not None:
            if isinstance(cur, P.Agg):
                return cur
            if cur.kind not in _AGG_TRANSPARENT:
                return None
            cur = cur.child
        return None


def _host_resident(dt: DataType) -> bool:
    return dt.is_nested or dt.is_wide_decimal


class TpuLintPass(Pass):
    """Advisories under the JAX package's pass id: a sort, window,
    aggregation or sort-merge join key, or a hash exchange key, of a
    host-resident type (nested, decimal(p > 18)).  The hash shape that
    takes the single-key kernel (one int64, timestamp or decimal(p <=
    18) key in the port, ops/shuffle/partitioner.py; one int64 or
    timestamp key in the JAX package) draws no diagnostic in either
    engine: in the JAX package it only stops the float64 info, a TPU
    rule the port does not state."""

    id = "tpu-lint"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        for node, path in ctx.nodes():
            k = node.kind
            if k == "rss_shuffle_writer":
                self._shuffle_keys(node, path, sink, ctx)
            elif k in ("sort", "sort_merge_join", "window", "agg"):
                self._key_dtypes(node, path, sink, ctx)

    @staticmethod
    def _key_exprs(node) -> Sequence:
        if node.kind == "sort":
            return tuple(s.child for s in node.sort_exprs)
        if node.kind == "sort_merge_join":
            return tuple(node.on.left_keys) if node.on else ()
        if node.kind == "window":
            return tuple(node.partition_by) + \
                tuple(s.child for s in node.order_by)
        return tuple(node.grouping)

    def _key_dtypes(self, node, path: str, sink: DiagnosticSink,
                    ctx: SchemaContext) -> None:
        src = getattr(node, "child", None) or getattr(node, "left", None)
        schema = ctx.schema_of(src) if src is not None else None
        if schema is None:
            return
        for i, e in enumerate(self._key_exprs(node)):
            dt = ctx._etype(e, schema, path, node, f"key {i}")
            if _host_resident(dt):
                sink.warning(
                    self.id, path, node,
                    f"key {i} has host-resident dtype {dt!r}; this "
                    f"{node.kind} keeps the host path instead of the "
                    f"device kernels",
                    hint="nested and decimal(p>18) keys have no device "
                         "layout")

    def _shuffle_keys(self, node, path: str, sink: DiagnosticSink,
                      ctx: SchemaContext) -> None:
        part = node.partitioning
        child = ctx.schema_of(node.child)
        if part is None or part.mode != "hash" or child is None:
            return
        dts = [ctx._etype(e, child, path, node, f"hash key {i}")
               for i, e in enumerate(part.expressions)]
        for i, dt in enumerate(dts):
            if _host_resident(dt):
                sink.warning(
                    self.id, path, node,
                    f"hash key {i} has host-resident dtype {dt!r}; "
                    f"partition ids fall back to host hashing",
                    hint="hash on a flat key (or a precomputed hash "
                         "column) to keep the exchange on device")


class FusionContractPass(Pass):
    """Verifies plans that hold FusedFragment nodes: bodies are pure
    row-local chains over one FragmentInput, and schemas agree across
    the fused boundary (analysis/fusion.py).  A plan without fragments
    pays one kind check a node."""

    id = "fusion"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        from auron_tpu_torch.analysis import fusion as F
        inside: set = set()
        for node, path in ctx.nodes():
            if node.kind != "fused_fragment" or id(node) in inside:
                continue
            # a fragment's body is checked as a unit; a nested fragment
            # (an error on the outer node) is not reported twice
            if node.body is not None:
                for sub in P.walk(node.body):
                    inside.add(id(sub))
            F.check_fragment(ctx, node, path, sink)


def _canonical_json(node: Node) -> str:
    return json.dumps(node.to_dict(), sort_keys=True,
                      separators=(",", ":"))


class SerdeRoundTripPass(Pass):
    id = "serde-roundtrip"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        if self._roundtrips(ctx.root):
            return
        # the deepest plan node whose subtree fails to round-trip
        offender, opath = ctx.root, ""
        for node, path in ctx.nodes():
            if not self._roundtrips(node) and len(path) >= len(opath):
                offender, opath = node, path
        try:
            s = _canonical_json(offender)
            back = Node.from_dict(json.loads(s))
            msg = "to_dict/from_dict is not a fixpoint" \
                if s != _canonical_json(back) else \
                "round-trip produced an unequal tree"
        except Exception as e:  # noqa: BLE001 - the finding itself
            msg = f"serde round-trip raised {type(e).__name__}: {e}"
        sink.error(
            self.id, opath, offender, msg,
            hint="check @register kinds and field encodings in "
                 "ir/node.py for every type this node carries")

    @staticmethod
    def _roundtrips(node: Node) -> bool:
        try:
            s = _canonical_json(node)
            return _canonical_json(Node.from_dict(json.loads(s))) == s
        except Exception:  # noqa: BLE001 - reported by the caller
            return False


def default_passes() -> List[Pass]:
    # local import: the adaptive pass's module imports Pass from here
    from auron_tpu_torch.analysis.adaptive import AdaptiveContractPass
    return [SchemaCheckPass(), ColumnResolutionPass(),
            PartitioningContractsPass(), FusionContractPass(),
            AdaptiveContractPass(), TpuLintPass(), SerdeRoundTripPass()]


class PassManager:
    """Runs a pass pipeline over one plan tree and orders the
    diagnostics: errors first, then warnings, then infos, each in pass
    order."""

    def __init__(self, passes: Optional[Sequence[Pass]] = None):
        self.passes: Tuple[Pass, ...] = tuple(
            passes if passes is not None else default_passes())

    def run(self, root: Node) -> AnalysisResult:
        ctx = SchemaContext(root)
        sink = DiagnosticSink()
        for p in self.passes:
            try:
                p.run(ctx, sink)
            except Exception as e:  # noqa: BLE001 - a crashing pass is
                # itself a finding, not a verifier crash
                sink.error(p.id, "", root,
                           f"analysis pass crashed: "
                           f"{type(e).__name__}: {e}")
        order = {"error": 0, "warning": 1, "info": 2}
        sink.diagnostics.sort(key=lambda d: order.get(d.severity, 3))
        return AnalysisResult(sink.diagnostics)


def analyze(plan: Node, passes: Optional[Sequence[Pass]] = None
            ) -> AnalysisResult:
    """Run the (default) pass battery over a plan or TaskDefinition."""
    return PassManager(passes).run(plan)


def verify(plan: Node, passes: Optional[Sequence[Pass]] = None
           ) -> AnalysisResult:
    """analyze(), raising PlanVerificationError on an error diagnostic."""
    res = analyze(plan, passes)
    if not res.ok:
        raise PlanVerificationError(res.diagnostics)
    return res
