"""Foreign physical plan -> the port's IR plan (counterpart of
auron_tpu/frontend/converters.py).

`convert_node` is the per-op dispatch (the Spark exec-class names of
the JAX package's converter, which follows Auron's AuronConverters);
`convert_recursively` converts the nodes the strategy tagged
(frontend/strategy.py), inserts a C2N reader (`FFIReader` over a
`ForeignSource`) under a native parent of a foreign child, and leaves
foreign sections as `ForeignWrap`s for the session's foreign engine.

Exchanges do not nest in the converted tree: a converted
ShuffleExchangeExec / BroadcastExchangeExec becomes an `IpcReader` leaf
plus a `ShuffleJob` / `BroadcastJob` in the `ConvertContext`, which the
session materializes (or, on the stage path, evaluates as an identity
on one device).  Resource ids, part counts and plans equal the JAX
package's for the same foreign plan and configuration.

What the port lacks raises: `GenerateExec` and the two write commands
`NotConvertible` (the strategy leaves them foreign), a file scan
converts to the data-only `ParquetScan` / `OrcScan` that the session
refuses to run (a convert provider may claim the scan instead:
`ScanSourceProvider` hands every file scan to the session's foreign
engine), and the adjacency branch of `auron.adaptive.fuse.adjacency.enable`
`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import itertools
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import expr_convert as EC
from auron_tpu_torch.frontend.expr_convert import (
    WIDE_DECIMAL, NotConvertible,
)
from auron_tpu_torch.frontend.foreign import ForeignExpr, ForeignNode
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import DataType, Schema


@dataclass
class ShuffleJob:
    """An exchange: the session runs `child` as a map stage partitioned
    by `partitioning`, then serves reduce-side blocks under `rid`."""
    rid: str
    child: P.PlanNode = None  # type: ignore[assignment]
    partitioning: P.Partitioning = None  # type: ignore[assignment]
    schema: Optional[Schema] = None


@dataclass
class BroadcastJob:
    """A broadcast: the session collects `child` once (all partitions)
    and serves its rows under `rid` to every task that reads it."""
    rid: str
    child: P.PlanNode = None  # type: ignore[assignment]
    schema: Optional[Schema] = None


@dataclass
class ForeignWrap:
    """A plan section left to the foreign engine; its children may be
    native sections, whose results reach the engine as `SourceTable`s."""
    node: ForeignNode = None  # type: ignore[assignment]
    children: List["ConvertedT"] = field(default_factory=list)


@dataclass
class ForeignSource:
    """A C2N transition: the table behind the `FFIReader`s of resource
    `rid`.  `node` is the foreign subtree that computes it (a
    `LocalTableScanExec`'s rows, a scan a convert provider claimed, or a
    section the strategy left foreign), which the session runs through
    its foreign engine; None when the caller passes the table with the
    query (`AuronSession.execute_converted`)."""
    rid: str
    node: Optional[ForeignWrap] = None


ConvertedT = Union[P.PlanNode, ForeignWrap]


class ConvertContext:
    def __init__(self) -> None:
        self._ids = itertools.count()
        # resource ids are unique across queries, as the JAX package's
        self._uid = uuid.uuid4().hex[:8]
        self.exchanges: Dict[str, ShuffleJob] = {}
        self.broadcasts: Dict[str, BroadcastJob] = {}
        self.sources: Dict[str, ForeignSource] = {}
        # partition count of each converted native node, keyed by identity
        self.n_parts: Dict[int, int] = {}

    def fresh(self, prefix: str) -> str:
        return f"{prefix}:{self._uid}:{next(self._ids)}"

    def parts(self, plan: P.PlanNode) -> int:
        return self.n_parts.get(id(plan), 1)

    def set_parts(self, plan: P.PlanNode, n: int) -> P.PlanNode:
        self.n_parts[id(plan)] = max(1, n)
        return plan


def stage_nodes(plan: P.PlanNode) -> Iterator[P.PlanNode]:
    """Every plan node of one stage, pre-order (a union's inputs in
    order); the readers are its leaves."""
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, P.PlanNode):
            yield n
        kids = [c for c in n.children_nodes()
                if isinstance(c, (P.PlanNode, P.UnionInput))]
        stack.extend(reversed(kids))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _schema(node: ForeignNode) -> Schema:
    if node.output is None:
        raise NotConvertible(f"{node.op} carries no output schema")
    return node.output


def _split_conjunction(fe: ForeignExpr) -> List[ForeignExpr]:
    if fe.name == "And":
        return _split_conjunction(fe.children[0]) + \
            _split_conjunction(fe.children[1])
    return [fe]


def _named_exprs(fexprs) -> Tuple[Tuple[E.Expr, ...], Tuple[str, ...]]:
    """projectList conversion: Alias carries the name; a bare attribute
    keeps its own name."""
    exprs, names = [], []
    for fe in fexprs:
        if fe.name == "Alias":
            names.append(fe.value)
        elif fe.name == "AttributeReference":
            names.append(fe.value)
        else:
            raise NotConvertible(
                f"top-level project expression {fe.name} lacks a name")
        exprs.append(EC.convert_expr_with_fallback(fe))
    return tuple(exprs), tuple(names)


def _scans_as_readers(node):
    """The plan with each file scan an FFIReader of the scan's output
    schema: the port's planner builds no scan operator."""
    if isinstance(node, tuple):
        return tuple(_scans_as_readers(x) for x in node)
    if not isinstance(node, (P.PlanNode, P.UnionInput)):
        return node
    if node.kind in ("parquet_scan", "orc_scan"):
        return P.FFIReader(schema=P.scan_output_schema(node),
                           resource_id="__scan__")
    kids = {f.name: _scans_as_readers(getattr(node, f.name))
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name),
                          (P.PlanNode, P.UnionInput, tuple))}
    return dataclasses.replace(node, **kids) if kids else node


def _native_schema_of(plan: P.PlanNode) -> Optional[Schema]:
    """Exact runtime output schema of a converted subtree (e.g. the state
    layout a partial agg emits), derived by instantiating the operator
    tree: keeps exchange wire schemas honest regardless of what the
    foreign plan declared."""
    try:
        from auron_tpu_torch.runtime.planner import PhysicalPlanner
        return PhysicalPlanner().create_plan(_scans_as_readers(plan)).schema
    except Exception:
        return None


def convert_partitioning(spec: Dict[str, Any]) -> P.Partitioning:
    mode = spec.get("mode", "single")
    if mode not in ("hash", "round_robin", "single", "range"):
        raise NotConvertible(f"partitioning mode {mode}")
    exprs = tuple(EC.convert_expr_with_fallback(e)
                  for e in spec.get("expressions", ()))
    orders = tuple(EC.convert_sort_order(s)
                   for s in spec.get("sort_orders", ()))
    return P.Partitioning(
        mode=mode, num_partitions=int(spec.get("num_partitions", 1)),
        expressions=exprs, sort_orders=orders,
        range_bounds=tuple(tuple(b) for b in spec.get("range_bounds", ())))


def _op_enabled(flag: str) -> None:
    if not conf.get(f"auron.enable.{flag}"):
        raise NotConvertible(f"native {flag} disabled by conf")


# ---------------------------------------------------------------------------
# per-op converters.  Each takes (node, native_children, ctx) where
# native_children are already-converted native child plans (C2N inserted).
# ---------------------------------------------------------------------------

_PLAN_CONVERTERS: Dict[str, Callable[..., P.PlanNode]] = {}


def _plan(name: str):
    def deco(fn):
        _PLAN_CONVERTERS[name] = fn
        return fn
    return deco


@_plan("FileSourceScanExec")
def _scan(node: ForeignNode, children, ctx: ConvertContext) -> P.PlanNode:
    fmt = node.attrs.get("format", "parquet")
    groups = tuple(
        P.FileGroup(paths=tuple(g)) for g in node.attrs.get("file_groups", ()))
    if not groups:
        raise NotConvertible("scan without file groups")
    schema = _schema(node)
    predicate = None
    pushed = node.attrs.get("pushed_filters", ())
    if pushed:
        conv = [EC.convert_expr(p) for p in pushed]
        predicate = conv[0]
        for p in conv[1:]:
            predicate = E.ScAnd(left=predicate, right=p)
    part_schema = node.attrs.get("partition_schema")
    part_values = tuple(tuple(v) for v in node.attrs.get(
        "partition_values", ()))
    if fmt == "parquet":
        _op_enabled("parquet.scan")
        plan = P.ParquetScan(schema=schema, file_groups=groups,
                             predicate=predicate,
                             partition_schema=part_schema,
                             partition_values=part_values)
    elif fmt == "orc":
        _op_enabled("orc.scan")
        plan = P.OrcScan(schema=schema, file_groups=groups,
                         predicate=predicate)
    else:
        raise NotConvertible(f"scan format {fmt}")
    ctx.set_parts(plan, len(groups))
    if predicate is not None and \
            conf.get("auron.adaptive.fuse.adjacency.enable"):
        # the JAX package asks its adaptive cost model whether to keep
        # the pushed filter also as a Filter above the scan
        raise NotImplementedError(
            "auron.adaptive.fuse.adjacency.enable needs the adaptive cost "
            "model (runtime/adaptive.py), which is not in auron_tpu_torch "
            "yet (ROADMAP Queue 1 item 23)")
    return plan


@_plan("LocalTableScanExec")
def _local_table_scan(node, children, ctx) -> P.PlanNode:
    rid = ctx.fresh("local_table")
    schema = _schema(node)
    src = ForeignSource(rid=rid, node=ForeignWrap(node=node))
    ctx.sources[rid] = src
    return ctx.set_parts(P.FFIReader(schema=schema, resource_id=rid), 1)


@_plan("ProjectExec")
def _project(node, children, ctx) -> P.PlanNode:
    _op_enabled("project")
    exprs, names = _named_exprs(node.attrs["project_list"])
    return ctx.set_parts(
        P.Projection(child=children[0], exprs=exprs, names=names),
        ctx.parts(children[0]))


@_plan("FilterExec")
def _filter(node, children, ctx) -> P.PlanNode:
    _op_enabled("filter")
    preds = tuple(EC.convert_expr_with_fallback(p)
                  for p in _split_conjunction(node.attrs["condition"]))
    return ctx.set_parts(P.Filter(child=children[0], predicates=preds),
                         ctx.parts(children[0]))


@_plan("SortExec")
def _sort(node, children, ctx) -> P.PlanNode:
    _op_enabled("sort")
    orders = tuple(EC.convert_sort_order(s)
                   for s in node.attrs["sort_order"])
    return ctx.set_parts(P.Sort(child=children[0], sort_exprs=orders),
                         ctx.parts(children[0]))


@_plan("LocalLimitExec")
def _local_limit(node, children, ctx) -> P.PlanNode:
    _op_enabled("limit")
    return ctx.set_parts(
        P.Limit(child=children[0], limit=int(node.attrs["limit"]),
                offset=int(node.attrs.get("offset", 0))),
        ctx.parts(children[0]))


@_plan("GlobalLimitExec")
@_plan("CollectLimitExec")
def _global_limit(node, children, ctx) -> P.PlanNode:
    """Global limit over a multi-partition child: per-partition pre-limit,
    single-partition exchange, then the real limit+offset (CollectLimit's
    gather-to-one shape)."""
    _op_enabled("limit")
    limit = int(node.attrs["limit"])
    offset = int(node.attrs.get("offset", 0))
    child = children[0]
    if ctx.parts(child) > 1:
        local = ctx.set_parts(
            P.Limit(child=child, limit=limit + offset, offset=0),
            ctx.parts(child))
        rid = ctx.fresh("shuffle")
        schema = _native_schema_of(local) or _schema(node)
        ctx.exchanges[rid] = ShuffleJob(
            rid=rid, child=local,
            partitioning=P.Partitioning(mode="single", num_partitions=1),
            schema=schema)
        child = ctx.set_parts(P.IpcReader(schema=schema, resource_id=rid),
                              1)
    return ctx.set_parts(P.Limit(child=child, limit=limit, offset=offset),
                         1)


@_plan("TakeOrderedAndProjectExec")
def _take_ordered(node, children, ctx) -> P.PlanNode:
    """Global top-K: per-partition sort+limit, single-partition exchange,
    final merge sort+limit (NativeTakeOrderedBase's two-stage shape)."""
    _op_enabled("sort")
    orders = tuple(EC.convert_sort_order(s)
                   for s in node.attrs["sort_order"])
    limit = int(node.attrs["limit"])
    offset = int(node.attrs.get("offset", 0))
    merged_child = children[0]
    if ctx.parts(children[0]) > 1:
        local = ctx.set_parts(
            P.Sort(child=children[0], sort_exprs=orders,
                   fetch_limit=limit + offset),
            ctx.parts(children[0]))
        rid = ctx.fresh("shuffle")
        schema = _native_schema_of(local) or _schema(node)
        ctx.exchanges[rid] = ShuffleJob(
            rid=rid, child=local,
            partitioning=P.Partitioning(mode="single", num_partitions=1),
            schema=schema)
        merged_child = ctx.set_parts(
            P.IpcReader(schema=schema, resource_id=rid), 1)
    sort = P.Sort(child=merged_child, sort_exprs=orders,
                  fetch_limit=limit, fetch_offset=offset)
    exprs, names = _named_exprs(node.attrs["project_list"])
    return ctx.set_parts(P.Projection(child=sort, exprs=exprs, names=names),
                         1)


@_plan("HashAggregateExec")
@_plan("ObjectHashAggregateExec")
@_plan("SortAggregateExec")
def _agg(node, children, ctx) -> P.PlanNode:
    _op_enabled("agg")
    grouping, grouping_names = _named_exprs(node.attrs.get("grouping", ()))
    aggs = tuple(EC.convert_agg_expr(a) for a in node.attrs.get("aggs", ()))
    return ctx.set_parts(
        P.Agg(child=children[0],
              exec_mode=node.attrs.get("mode", "single"),
              grouping=grouping, grouping_names=grouping_names,
              aggs=aggs, agg_names=tuple(node.attrs.get("agg_names", ())),
              supports_partial_skipping=bool(
                  node.attrs.get("supports_partial_skipping", False))),
        ctx.parts(children[0]))


@_plan("ExpandExec")
def _expand(node, children, ctx) -> P.PlanNode:
    _op_enabled("expand")
    schema = _schema(node)
    child_schema = _native_schema_of(children[0])

    def conv(e: ForeignExpr, declared: DataType) -> E.Expr:
        x = EC.convert_expr_with_fallback(e)
        # grouping-set projections must hit the declared output types
        # exactly (e.g. int32 literal 0 under a bigint grouping-id column)
        if child_schema is not None:
            from auron_tpu_torch.exprs.typing import infer_type
            try:
                if infer_type(x, child_schema) != declared:
                    return E.Cast(child=x, dtype=declared)
            except Exception:
                pass
        return x

    projections = tuple(
        tuple(conv(e, f.dtype) for e, f in zip(proj, schema.fields))
        for proj in node.attrs["projections"])
    return ctx.set_parts(
        P.Expand(child=children[0], projections=projections,
                 names=schema.names(),
                 types=tuple(f.dtype for f in schema.fields)),
        ctx.parts(children[0]))


@_plan("WindowExec")
def _window(node, children, ctx) -> P.PlanNode:
    _op_enabled("window")
    funcs = []
    for w in node.attrs.get("window_exprs", ()):
        # shape: {"name": out_name, "fn": fn_name, "args": [fexpr...],
        #         "agg": AggregateExpression fexpr (fn == "agg")}
        agg = None
        if w.get("agg") is not None:
            agg = EC.convert_agg_expr(w["agg"])
            rt = agg.return_type
        else:
            # per-function defaults (Spark: rank family is IntegerType,
            # percent_rank/cume_dist are DoubleType); value functions
            # (lead/lag/nth_value/...) have data-dependent types and must
            # declare one
            rt = w.get("dtype")
            if rt is None:
                if w["fn"] in ("percent_rank", "cume_dist"):
                    rt = DataType.float64()
                elif w["fn"] in ("row_number", "rank", "dense_rank"):
                    rt = DataType.int32()
                else:
                    raise NotConvertible(
                        f"window function {w['fn']} requires a dtype")
        funcs.append(P.WindowFuncCall(
            fn=w["fn"],
            args=tuple(EC.convert_expr_with_fallback(a)
                       for a in w.get("args", ())),
            agg=agg, return_type=rt, name=w["name"]))
    part_by = tuple(EC.convert_expr_with_fallback(e)
                    for e in node.attrs.get("partition_spec", ()))
    order_by = tuple(EC.convert_sort_order(s)
                     for s in node.attrs.get("order_spec", ()))
    return ctx.set_parts(
        P.Window(child=children[0], window_funcs=tuple(funcs),
                 partition_by=part_by, order_by=order_by),
        ctx.parts(children[0]))


@_plan("WindowGroupLimitExec")
def _window_group_limit(node, children, ctx) -> P.PlanNode:
    _op_enabled("window")
    part_by = tuple(EC.convert_expr_with_fallback(e)
                    for e in node.attrs.get("partition_spec", ()))
    order_by = tuple(EC.convert_sort_order(s)
                     for s in node.attrs.get("order_spec", ()))
    limit = P.WindowGroupLimit(
        k=int(node.attrs["limit"]),
        rank_fn=node.attrs.get("rank_like_function", "row_number"))
    return ctx.set_parts(
        P.Window(child=children[0], window_funcs=(), partition_by=part_by,
                 order_by=order_by, group_limit=limit,
                 output_window_cols=False),
        ctx.parts(children[0]))


@_plan("GenerateExec")
def _generate(node, children, ctx) -> P.PlanNode:
    _op_enabled("generate")
    raise NotConvertible("GenerateExec is not in auron_tpu_torch yet "
                         "(ROADMAP Queue 1 item 4)")


@_plan("UnionExec")
def _union(node, children, ctx) -> P.PlanNode:
    _op_enabled("union")
    schema = _schema(node)
    # flattened partition mapping (proto:542-552): output partitions are
    # the concatenation of every child's partitions, so each child
    # partition is read exactly once
    inputs = []
    out_pid = 0
    for c in children:
        for q in range(ctx.parts(c)):
            inputs.append(P.UnionInput(child=c, partition=q,
                                       out_partition=out_pid))
            out_pid += 1
    return ctx.set_parts(
        P.Union(inputs=tuple(inputs), schema=schema,
                num_partitions=out_pid, cur_partition=0),
        out_pid)


def _join_on(node) -> P.JoinOn:
    return P.JoinOn(
        left_keys=tuple(EC.convert_expr_with_fallback(k)
                        for k in node.attrs["left_keys"]),
        right_keys=tuple(EC.convert_expr_with_fallback(k)
                         for k in node.attrs["right_keys"]))


def _check_no_condition(node) -> None:
    if node.attrs.get("condition") is not None:
        raise NotConvertible(
            f"{node.op} with post-join condition is not supported yet")


@_plan("SortMergeJoinExec")
def _smj(node, children, ctx) -> P.PlanNode:
    if conf.get("auron.force.shuffled.hash.join"):
        # rewrite the planned SMJ into a shuffled hash join — what the
        # reference achieves by patching Spark's planner bytecode
        # (ForceApplyShuffledHashJoinInjector.java).  "Prefer when both
        # are legal": if SHJ conversion is not possible (disabled,
        # unsupported shape) fall through to the normal SMJ path.
        try:
            return _shj(node, children, ctx)
        except NotConvertible:
            pass
    _op_enabled("smj")
    _check_no_condition(node)
    jt = EC.convert_join_type(node.attrs.get("join_type", "Inner"))
    nkeys = len(node.attrs["left_keys"])
    on = _join_on(node)

    def ensure_sorted(child: P.PlanNode, keys) -> P.PlanNode:
        # EnsureRequirements analogue: the streaming SMJ consumes
        # key-sorted inputs (childOrderingRequired tag,
        # AuronConvertStrategy.scala:41-47); a real engine plan carries
        # explicit SortExec children, a synthetic plan may not
        want = tuple(E.SortExpr(child=k, asc=True, nulls_first=True)
                     for k in keys)
        if isinstance(child, P.Sort) and child.sort_exprs[:nkeys] == want:
            return child
        return ctx.set_parts(P.Sort(child=child, sort_exprs=want),
                             ctx.parts(child))

    return ctx.set_parts(
        P.SortMergeJoin(
            left=ensure_sorted(children[0], on.left_keys),
            right=ensure_sorted(children[1], on.right_keys),
            on=on, join_type=jt,
            sort_options=tuple((True, True) for _ in range(nkeys)),
            existence_output_name=node.attrs.get("existence_name",
                                                 "exists")),
        max(ctx.parts(children[0]), ctx.parts(children[1])))


@_plan("ShuffledHashJoinExec")
def _shj(node, children, ctx) -> P.PlanNode:
    _op_enabled("shj")
    _check_no_condition(node)
    jt = EC.convert_join_type(node.attrs.get("join_type", "Inner"))
    return ctx.set_parts(
        P.HashJoin(left=children[0], right=children[1], on=_join_on(node),
                   join_type=jt,
                   build_side=node.attrs.get("build_side", "right"),
                   existence_output_name=node.attrs.get("existence_name",
                                                        "exists")),
        max(ctx.parts(children[0]), ctx.parts(children[1])))


@_plan("BroadcastHashJoinExec")
def _bhj(node, children, ctx) -> P.PlanNode:
    _op_enabled("bhj")
    _check_no_condition(node)
    jt = EC.convert_join_type(node.attrs.get("join_type", "Inner"))
    side = node.attrs.get("build_side", "right")
    on = _join_on(node)
    build_idx = 1 if side == "right" else 0
    build_keys = on.right_keys if side == "right" else on.left_keys
    cache_id = ctx.fresh("bhm")
    built = P.BroadcastJoinBuildHashMap(
        child=children[build_idx], keys=build_keys, cache_id=cache_id)
    ctx.set_parts(built, ctx.parts(children[build_idx]))
    pair = [children[0], children[1]]
    pair[build_idx] = built
    probe_parts = ctx.parts(children[1 - build_idx])
    return ctx.set_parts(
        P.BroadcastJoin(left=pair[0], right=pair[1], on=on, join_type=jt,
                        broadcast_side=side,
                        cached_build_hash_map_id=cache_id,
                        existence_output_name=node.attrs.get(
                            "existence_name", "exists")),
        probe_parts)


@_plan("ShuffleExchangeExec")
def _shuffle_exchange(node, children, ctx) -> P.PlanNode:
    _op_enabled("shuffle")
    part = convert_partitioning(node.attrs["partitioning"])
    rid = ctx.fresh("shuffle")
    schema = _native_schema_of(children[0]) or _schema(node)
    ctx.exchanges[rid] = ShuffleJob(rid=rid, child=children[0],
                                    partitioning=part, schema=schema)
    return ctx.set_parts(P.IpcReader(schema=schema, resource_id=rid),
                         part.num_partitions)


@_plan("BroadcastExchangeExec")
def _broadcast_exchange(node, children, ctx) -> P.PlanNode:
    rid = ctx.fresh("broadcast")
    schema = _native_schema_of(children[0]) or _schema(node)
    ctx.broadcasts[rid] = BroadcastJob(rid=rid, child=children[0],
                                       schema=schema)
    return ctx.set_parts(P.IpcReader(schema=schema, resource_id=rid), 1)


_SINKS_NOT_PORTED = ("the parquet and ORC sinks are not in auron_tpu_torch "
                     "yet (ROADMAP Queue 1 item 13)")


@_plan("DataWritingCommandExec")
def _data_writing(node, children, ctx) -> P.PlanNode:
    fmt = node.attrs.get("format", "parquet")
    if fmt not in ("parquet", "orc"):
        raise NotConvertible(f"sink format {fmt}")
    _op_enabled(f"{fmt}.sink")
    raise NotConvertible(_SINKS_NOT_PORTED)


@_plan("InsertIntoHiveTableExec")
def _insert_into_hive(node, children, ctx) -> P.PlanNode:
    storage = node.attrs.get("storage", {})
    fmt = str(storage.get("format", node.attrs.get("format",
                                                   "parquet"))).lower()
    if "orc" in fmt:
        fmt = "orc"
    elif "parquet" in fmt or fmt in ("hive", ""):
        fmt = "parquet"
    else:
        raise NotConvertible(f"hive serde format {fmt!r}")
    _op_enabled(f"{fmt}.sink")
    raise NotConvertible(_SINKS_NOT_PORTED)


# ---------------------------------------------------------------------------
# external convert providers (thirdparty SPI; AuronConvertProvider.scala:27
# + ServiceLoader discovery at AuronConverters.scala:108-112)
# ---------------------------------------------------------------------------

class ConvertProvider:
    """Extension hook: table formats (Iceberg/Paimon/Hudi) register one of
    these to claim foreign scan nodes."""

    def is_supported(self, node: ForeignNode) -> bool:
        raise NotImplementedError

    def convert(self, node: ForeignNode, children, ctx: ConvertContext
                ) -> P.PlanNode:
        raise NotImplementedError


_EXT_PROVIDERS: List[ConvertProvider] = []


def register_provider(p: ConvertProvider) -> None:
    _EXT_PROVIDERS.append(p)


def unregister_provider(p: ConvertProvider) -> None:
    try:
        _EXT_PROVIDERS.remove(p)
    except ValueError:
        pass


def ext_convert_supported(node: ForeignNode) -> bool:
    return any(p.is_supported(node) for p in _EXT_PROVIDERS)


class ScanSourceProvider(ConvertProvider):
    """Claims every FileSourceScanExec for a port that reads no file: an
    FFIReader of the scan's output, one partition a file group, over a
    ForeignSource wrapping the scan, which the session's foreign engine
    reads (`register_provider(ScanSourceProvider())`)."""

    def is_supported(self, node: ForeignNode) -> bool:
        return node.op == "FileSourceScanExec"

    def convert(self, node: ForeignNode, children, ctx: ConvertContext
                ) -> P.PlanNode:
        rid = ctx.fresh("scan")
        ctx.sources[rid] = ForeignSource(rid=rid,
                                         node=ForeignWrap(node=node))
        return ctx.set_parts(P.FFIReader(schema=node.output,
                                         resource_id=rid),
                             len(node.attrs["file_groups"]))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def convert_node(node: ForeignNode, native_children: List[P.PlanNode],
                 ctx: ConvertContext) -> P.PlanNode:
    """Strict single-node conversion given native children.  A node
    whose output or input holds a decimal of more than 18 digits stays
    foreign: the JAX package keeps such a column on the host, which the
    port has not yet."""
    for schema in [node.output] + [c.output for c in node.children]:
        for f in (schema or ()):
            if f.dtype.is_wide_decimal:
                raise NotConvertible(WIDE_DECIMAL.format(f.dtype))
    for p in _EXT_PROVIDERS:
        if p.is_supported(node):
            return p.convert(node, native_children, ctx)
    fn = _PLAN_CONVERTERS.get(node.op)
    if fn is None:
        raise NotConvertible(f"{node.op} is not supported yet")
    return fn(node, native_children, ctx)


def dry_run_convertible(node: ForeignNode) -> Optional[str]:
    """Convertibility probe for the strategy pass: children are assumed
    native.  Returns None if convertible, else the reason."""
    ctx = ConvertContext()
    placeholders = []
    for c in node.children:
        schema = c.output if c.output is not None else Schema(())
        ph = P.FFIReader(schema=schema, resource_id="__dryrun__")
        placeholders.append(ctx.set_parts(ph, 1))
    try:
        convert_node(node, placeholders, ctx)
        return None
    except NotConvertible as e:
        return str(e)
    except Exception as e:  # converter bug surfaces as non-convertible
        return f"{type(e).__name__}: {e}"


def convert_to_native(converted: ConvertedT, ctx: ConvertContext
                      ) -> P.PlanNode:
    """C2N insertion (AuronConverters.convertToNative:1132): a foreign
    subtree under a native parent enters through an FFIReader."""
    if not isinstance(converted, ForeignWrap):
        return converted
    node = converted.node
    schema = node.output if node.output is not None else Schema(())
    rid = ctx.fresh("c2n")
    ctx.sources[rid] = ForeignSource(rid=rid, node=converted)
    reader = P.FFIReader(schema=schema, resource_id=rid)
    return ctx.set_parts(reader, 1)


def convert_recursively(node: ForeignNode, tags, ctx: ConvertContext
                        ) -> ConvertedT:
    """convertSparkPlanRecursively:186-209 analogue, driven by the
    strategy's tags (frontend.strategy.Tags)."""
    converted_children = [convert_recursively(c, tags, ctx)
                          for c in node.children]
    if tags.is_always_convert(node):
        native_children = [convert_to_native(c, ctx)
                           for c in converted_children]
        return convert_node(node, native_children, ctx)
    return ForeignWrap(node=node, children=converted_children)
