"""Bottom-up output-schema inference over the plan IR (counterpart of
auron_tpu/analysis/schema_infer.py).

Recomputes what each node will produce, by the schema rules the
operator constructors apply (ops/basic.py, ops/agg/exec.py,
ops/joins/exec.py, ops/window/exec.py, ops/shuffle/writer.py), without
building an operator, so a plan is checked before any batch moves.
Leaves and `Union` carry a declared schema in the IR; every other node
derives its schema from its children and expressions, and the
derivation reports structural errors (arity mismatches, untypeable
expressions) as diagnostics.  There is a rule for each kind of the
port's IR, with the JAX package's node paths.

Resolution failures (an unknown column name, a bound index out of
range) are the column-resolution pass's findings, not this one's: the
affected field degrades to a NULL-typed placeholder so that the arity
checks downstream still run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from auron_tpu_torch.analysis.diagnostics import DiagnosticSink
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.expr import AggExpr, Expr
from auron_tpu_torch.ir.node import Node
from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId

PASS_ID = "schema-check"

# a column reference that did not resolve (a name lookup, a bound
# ordinal): deferred to the column-resolution pass
_RESOLUTION_ERRORS = (KeyError, IndexError)


def labeled_plan_children(node: Node) -> List[Tuple[str, P.PlanNode]]:
    """Direct child plans with their field paths, descending through
    wrapper Nodes (UnionInput, JoinOn, ...) but not expressions: the
    labeled twin of ir.plan.plan_children."""
    out: List[Tuple[str, P.PlanNode]] = []

    def collect(label: str, v) -> None:
        if isinstance(v, P.PlanNode):
            out.append((label, v))
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                collect(f"{label}[{i}]", x)
        elif isinstance(v, Node) and not isinstance(v, Expr):
            for f in dataclasses.fields(v):
                collect(f"{label}.{f.name}", getattr(v, f.name))

    for f in dataclasses.fields(node):
        collect(f.name, getattr(node, f.name))
    return out


def walk_with_paths(root: Node):
    """Pre-order (node, path) traversal over plan nodes, on an explicit
    stack (ir/plan.py:walk is the unlabeled twin)."""
    stack: List[Tuple[Node, str]] = [(root, "")]
    while stack:
        node, path = stack.pop()
        yield node, path
        kids = labeled_plan_children(node)
        for label, child in reversed(kids):
            stack.append((child, f"{path}.{label}" if path else label))


class SchemaContext:
    """Inferred output schemas per node identity, shared by every pass of
    one analyzer run."""

    def __init__(self, root: Node, sink: Optional[DiagnosticSink] = None):
        self.root = root
        # inference diagnostics collect here; the schema-check pass
        # copies them into the run's sink
        self.sink = sink if sink is not None else DiagnosticSink()
        self._schemas: Dict[int, Optional[Schema]] = {}
        self._paths: Dict[int, str] = {}
        self._infer_all(root)

    def schema_of(self, node: Node) -> Optional[Schema]:
        """The inferred output schema; None when inference could not
        give one (the diagnostics say why)."""
        return self._schemas.get(id(node))

    def path_of(self, node: Node) -> str:
        return self._paths.get(id(node), "")

    def nodes(self) -> List[Tuple[Node, str]]:
        """Pre-order (node, path) pairs of every plan node in the tree."""
        return list(walk_with_paths(self.root))

    def _infer_all(self, root: Node) -> None:
        order: List[Tuple[Node, str]] = list(walk_with_paths(root))
        for node, path in order:
            self._paths.setdefault(id(node), path)
        for node, path in reversed(order):      # children first
            if id(node) not in self._schemas:
                self._schemas[id(node)] = self._infer(node, path)

    def _etype(self, expr: Expr, schema: Schema, path: str, node: Node,
               what: str) -> DataType:
        """An expression's type over a binding schema; a typing failure
        becomes a diagnostic and degrades to NULL so the arity holds."""
        from auron_tpu_torch.exprs.typing import infer_type
        try:
            return infer_type(expr, schema)
        except _RESOLUTION_ERRORS:
            return DataType.null()   # column-resolution reports it
        except Exception as e:  # noqa: BLE001 - diagnosed, not raised
            self.sink.error(PASS_ID, path, node,
                            f"cannot type {what}: {e}")
            return DataType.null()

    def _child(self, node: Node, field_name: str) -> Optional[Schema]:
        v = getattr(node, field_name, None)
        return self._schemas.get(id(v)) if v is not None else None

    def _declared(self, node: Node, path: str) -> Optional[Schema]:
        s = getattr(node, "schema", None)
        if not isinstance(s, Schema):
            self.sink.error(
                PASS_ID, path, node,
                f"leaf node carries no declared schema (got "
                f"{type(s).__name__})",
                hint="every source/exchange-reader node must declare its "
                     "output schema")
            return None
        return s

    def _infer(self, node: Node, path: str) -> Optional[Schema]:
        fn = _RULES.get(node.kind)
        if fn is None:
            s = getattr(node, "schema", None)
            return s if isinstance(s, Schema) else None
        try:
            return fn(self, node, path)
        except Exception as e:  # noqa: BLE001 - inference must not throw
            self.sink.error(PASS_ID, path, node,
                            f"schema inference failed: {e}")
            return None


# -- per-kind rules (the operator constructors' schema logic) ----------------

def _scan_schema(ctx: SchemaContext, node, path: str,
                 with_partitions: bool) -> Optional[Schema]:
    base = ctx._declared(node, path)
    if base is None:
        return None
    proj = tuple(node.projection) or tuple(range(len(base)))
    # an index out of range is the column-resolution pass's finding
    out = base.select([i for i in proj if 0 <= i < len(base)])
    if with_partitions and node.partition_schema:
        out = out.concat(node.partition_schema)
    return out


def _r_parquet_scan(ctx, node, path):
    return _scan_schema(ctx, node, path, with_partitions=True)


def _r_orc_scan(ctx, node, path):
    return _scan_schema(ctx, node, path, with_partitions=False)


def _r_declared_leaf(ctx, node, path):
    return ctx._declared(node, path)


def _r_child_passthrough(ctx, node, path):
    return ctx._child(node, "child")


def _r_projection(ctx, node: P.Projection, path):
    child = ctx._child(node, "child")
    if len(node.exprs) != len(node.names):
        ctx.sink.error(
            PASS_ID, path, node,
            f"{len(node.exprs)} exprs but {len(node.names)} names",
            hint="projection exprs and names must pair 1:1")
        return None
    if child is None:
        return None
    return Schema(tuple(
        Field(n, ctx._etype(x, child, path, node, f"exprs[{i}] ({n!r})"))
        for i, (n, x) in enumerate(zip(node.names, node.exprs))))


def _r_filter(ctx, node: P.Filter, path):
    child = ctx._child(node, "child")
    if child is not None:
        for i, pred in enumerate(node.predicates):
            dt = ctx._etype(pred, child, path, node, f"predicates[{i}]")
            if dt.id not in (TypeId.BOOL, TypeId.NULL):
                ctx.sink.error(
                    PASS_ID, path, node,
                    f"predicates[{i}] types to {dt!r}, not boolean",
                    hint="filter predicates must be boolean expressions")
    return child


def _r_rename(ctx, node: P.RenameColumns, path):
    child = ctx._child(node, "child")
    if child is None:
        return None
    if len(node.names) != len(child):
        ctx.sink.error(
            PASS_ID, path, node,
            f"{len(node.names)} names for {len(child)} input columns",
            hint="rename_columns must cover every child column")
        return None
    return child.rename(node.names)


def agg_state_arity(a: AggExpr) -> int:
    """Partial-state slot count of an aggregate function (the arities of
    the specs' state_fields, ops/agg/functions.py)."""
    return {"count": 1, "avg": 2,
            "stddev_samp": 3, "var_samp": 3}.get(a.fn, 1)


def _agg_state_fields(ctx: SchemaContext, a: AggExpr, name: str,
                      in_schema: Schema, path: str, node) -> List[Field]:
    """Partial-mode state fields of one aggregate: the specs'
    state_fields without building a spec."""
    def device(dt: DataType) -> bool:
        return not dt.is_nested and not dt.is_wide_decimal

    def flat_numeric(dt: DataType) -> bool:
        return device(dt) and not dt.is_stringlike

    in_dt = None
    if a.children:
        in_dt = ctx._etype(a.children[0], in_schema, path, node,
                           f"agg {name!r} input")
    out_dt = a.return_type
    if a.fn == "sum" and flat_numeric(out_dt):
        return [Field(f"{name}#sum", out_dt)]
    if a.fn == "count":
        return [Field(f"{name}#count", DataType.int64(), nullable=False)]
    if a.fn in ("min", "max") and in_dt is not None \
            and flat_numeric(in_dt) and flat_numeric(out_dt):
        return [Field(f"{name}#{a.fn}", out_dt)]
    if a.fn == "avg" and in_dt is not None and flat_numeric(in_dt):
        sum_dt = in_dt if in_dt.is_decimal else DataType.float64()
        return [Field(f"{name}#sum", sum_dt),
                Field(f"{name}#count", DataType.int64(), nullable=False)]
    if a.fn in ("stddev_samp", "var_samp") and in_dt is not None \
            and flat_numeric(in_dt):
        return [Field(f"{name}#sum", DataType.float64()),
                Field(f"{name}#sumsq", DataType.float64()),
                Field(f"{name}#count", DataType.int64(), nullable=False)]
    if a.fn in ("first", "first_ignores_null") and in_dt is not None \
            and device(in_dt):
        return [Field(f"{name}#first", out_dt)]
    return [Field(f"{name}#state", DataType.binary())]


_AGG_MODES = ("partial", "final", "single")


def _r_agg(ctx, node: P.Agg, path):
    child = ctx._child(node, "child")
    if node.exec_mode not in _AGG_MODES:
        ctx.sink.error(PASS_ID, path, node,
                       f"unknown exec_mode {node.exec_mode!r}",
                       hint=f"one of {_AGG_MODES}")
    if len(node.grouping) != len(node.grouping_names):
        ctx.sink.error(
            PASS_ID, path, node,
            f"{len(node.grouping)} grouping exprs but "
            f"{len(node.grouping_names)} grouping names")
        return None
    if len(node.aggs) != len(node.agg_names):
        ctx.sink.error(
            PASS_ID, path, node,
            f"{len(node.aggs)} aggs but {len(node.agg_names)} agg names")
        return None
    if child is None:
        return None
    key_fields = tuple(
        Field(n, ctx._etype(g, child, path, node, f"grouping ({n!r})"))
        for n, g in zip(node.grouping_names, node.grouping))
    if node.exec_mode == "partial":
        out: List[Field] = list(key_fields)
        for a, name in zip(node.aggs, node.agg_names):
            out.extend(_agg_state_fields(ctx, a, name, child, path, node))
        return Schema(tuple(out))
    return Schema(key_fields + tuple(
        Field(n, a.return_type) for n, a in zip(node.agg_names, node.aggs)))


def _r_expand(ctx, node: P.Expand, path):
    child = ctx._child(node, "child")
    for i, proj in enumerate(node.projections):
        if len(proj) != len(node.names):
            ctx.sink.error(
                PASS_ID, path, node,
                f"projections[{i}] has {len(proj)} exprs for "
                f"{len(node.names)} output names",
                hint="every expand projection must produce the full "
                     "output row")
    if node.types:
        if len(node.types) != len(node.names):
            ctx.sink.error(
                PASS_ID, path, node,
                f"{len(node.types)} types for {len(node.names)} names")
            return None
        return Schema(tuple(Field(n, t)
                            for n, t in zip(node.names, node.types)))
    if child is None or not node.projections:
        return None
    return Schema(tuple(
        Field(n, ctx._etype(x, child, path, node, f"projections[0] ({n!r})"))
        for n, x in zip(node.names, node.projections[0])))


def _default_window_type(wf: P.WindowFuncCall) -> DataType:
    if wf.fn in ("row_number", "rank", "dense_rank"):
        return DataType.int64()
    return DataType.float64()


def _r_window(ctx, node: P.Window, path):
    child = ctx._child(node, "child")
    if child is None:
        return None
    fields = list(child.fields)
    if node.output_window_cols:
        for wf in node.window_funcs:
            dt = wf.return_type or _default_window_type(wf)
            fields.append(Field(wf.name or wf.fn, dt))
    return Schema(tuple(fields))


_JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
               "right_semi", "right_anti", "existence")


def join_output_schema(left: Schema, right: Schema, join_type: str,
                       existence_name: str = "exists") -> Schema:
    """The joins' output schema (ops/joins/exec.py), without building
    the join."""
    def nullable(fields):
        return tuple(Field(f.name, f.dtype, True) for f in fields)

    if join_type == "inner":
        return left.concat(right)
    if join_type == "left":
        return Schema(left.fields + nullable(right.fields))
    if join_type == "right":
        return Schema(nullable(left.fields) + right.fields)
    if join_type == "full":
        return Schema(nullable(left.fields) + nullable(right.fields))
    if join_type in ("left_semi", "left_anti"):
        return left
    if join_type in ("right_semi", "right_anti"):
        return right
    if join_type == "existence":
        return Schema(left.fields +
                      (Field(existence_name, DataType.bool_(), False),))
    raise ValueError(f"unknown join type {join_type!r}")


def _r_join(ctx, node, path):
    left = ctx._child(node, "left")
    right = ctx._child(node, "right")
    if node.join_type not in _JOIN_TYPES:
        ctx.sink.error(PASS_ID, path, node,
                       f"unknown join type {node.join_type!r}",
                       hint=f"one of {_JOIN_TYPES}")
        return None
    if left is None or right is None:
        return None
    return join_output_schema(left, right, node.join_type,
                              node.existence_output_name)


def _r_union(ctx, node: P.Union, path):
    declared = ctx._declared(node, path)
    if declared is None:
        return None
    for i, inp in enumerate(node.inputs):
        cs = ctx._schemas.get(id(inp.child))
        if cs is None:
            continue
        where = f"{path}.inputs[{i}].child" if path else f"inputs[{i}].child"
        if len(cs) != len(declared):
            ctx.sink.error(
                PASS_ID, where, node,
                f"union input {i} has {len(cs)} columns, declared schema "
                f"has {len(declared)}")
            continue
        for j, (cf, df) in enumerate(zip(cs.fields, declared.fields)):
            if cf.dtype != df.dtype and cf.dtype.id != TypeId.NULL and \
                    df.dtype.id != TypeId.NULL:
                ctx.sink.error(
                    PASS_ID, where, node,
                    f"union input {i} column {j} ({cf.name!r}) is "
                    f"{cf.dtype!r}, declared {df.dtype!r}")
            elif cf.nullable and not df.nullable:
                ctx.sink.warning(
                    PASS_ID, where, node,
                    f"union input {i} column {j} ({cf.name!r}) is "
                    f"nullable but the declared field is not",
                    hint="nulls from this input would violate the "
                         "declared contract")
    return declared


def _r_shuffle_writer(ctx, node, path):
    # the writer's partition statistics (ops/shuffle/writer.py)
    return Schema((Field("partition", DataType.int32()),
                   Field("bytes", DataType.int64()),
                   Field("rows", DataType.int64())))


def _r_task_definition(ctx, node: P.TaskDefinition, path):
    return ctx._child(node, "plan")


def _r_fused_fragment(ctx, node: P.FusedFragment, path):
    # the fragment produces what its fused chain produces; agreement
    # with the declared schema is the fusion pass's finding
    body = ctx._child(node, "body")
    if body is not None:
        return body
    s = getattr(node, "schema", None)
    return s if isinstance(s, Schema) else None


_RULES: Dict[str, Callable[[SchemaContext, Node, str], Optional[Schema]]] = {
    "parquet_scan": _r_parquet_scan,
    "orc_scan": _r_orc_scan,
    "ipc_reader": _r_declared_leaf,
    "ffi_reader": _r_declared_leaf,
    "empty_partitions": _r_declared_leaf,
    "projection": _r_projection,
    "filter": _r_filter,
    "sort": _r_child_passthrough,
    "limit": _r_child_passthrough,
    "coalesce_batches": _r_child_passthrough,
    "debug": _r_child_passthrough,
    "broadcast_join_build_hash_map": _r_child_passthrough,
    "rename_columns": _r_rename,
    "agg": _r_agg,
    "expand": _r_expand,
    "window": _r_window,
    "sort_merge_join": _r_join,
    "hash_join": _r_join,
    "broadcast_join": _r_join,
    "union": _r_union,
    "rss_shuffle_writer": _r_shuffle_writer,
    "task_definition": _r_task_definition,
    "fragment_input": _r_declared_leaf,
    "fused_fragment": _r_fused_fragment,
}
