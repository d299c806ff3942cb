"""Pipeline-fragment fusion (counterpart of auron_tpu/runtime/fusion.py):
rewrite maximal chains of row-local operators into FusedFragment nodes.

The planner applies `fuse_plan` behind `auron.fuse.enable` (default on)
before it builds the operator tree: a chain like

    limit <- projection <- filter <- coalesce_batches <- scan

lowers to one FusedFragment, which ops/fused.py runs as one operator: a
batch crosses the operator boundary once a fragment instead of once an
operator, and no intermediate Batch is made.

The rules are the JAX package's, so a plan fuses alike in both engines:
a chain needs two operators at least; an expression that reads the
running row position, a host-resident column or a part that cannot run
on the device declines its operator; a limit above an expand declines.
Every chain the rewriter declines is recorded as an analysis Diagnostic
(severity info, pass id "fusion") on the FusionReport, with the JAX
package's reasons, and `explain(plan)` renders the fragment boundaries.
The port has no host-resident columns yet (ROADMAP Queue 1 item 11), so
`_static_host_cols` finds none in its plans; the rule stays for when
they come.

`unfuse_plan` restores the exact original tree (a body keeps the
original operator nodes), which is also what `auron.fuse.enable=false`
gives by never fusing.
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from auron_tpu_torch.analysis.diagnostics import Diagnostic
from auron_tpu_torch.analysis.fusion import FUSABLE_KINDS, body_chain
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.node import Node
from auron_tpu_torch.ir.schema import DataType, Schema, TypeId

PASS_ID = "fusion"


@dataclass
class FusionReport:
    """What one fuse_plan run did: the fragments it made and the chains
    it declined, with reasons, as analysis diagnostics."""
    fragments: List[P.FusedFragment] = field(default_factory=list)
    declined: List[Diagnostic] = field(default_factory=list)

    @property
    def n_fragments(self) -> int:
        return len(self.fragments)

    @property
    def ops_fused(self) -> int:
        return sum(len(body_chain(f.body)[0]) for f in self.fragments)

    def render(self) -> str:
        lines = [f"{self.n_fragments} fragment(s), "
                 f"{self.ops_fused} operator(s) fused"]
        lines += [str(d) for d in self.declined]
        return "\n".join(lines)


# -- per-operator legality (the expressions' side; the structural side is
# analysis/fusion.py) ---------------------------------------------------------

# expression kinds that run on the host in the JAX package, and kinds that
# read the running row offset; the port deserializes none of them, and the
# rules stand for the plans that would hold them
_HOST_KINDS = frozenset({"py_udf_wrapper", "get_indexed_field",
                         "get_map_value", "named_struct"})
_ROW_BASE_KINDS = frozenset({"row_num", "monotonically_increasing_id"})

# the scalar functions with a device form in the JAX package: fusion
# decides alike in both engines (a function the port lacks raises where
# its operator is built, fused or not)
_DEVICE_FUNCS = frozenset({
    "abs", "acos", "asin", "atan", "atan2", "ceil", "cos", "cosh", "exp",
    "expm1", "floor", "ln", "log", "log10", "log2", "power", "round",
    "bround", "signum", "sin", "sinh", "sqrt", "tan", "tanh", "trunc",
    "is_nan", "null_if", "null_if_zero", "nvl", "nvl2", "coalesce", "least",
    "greatest", "year", "quarter", "month", "day", "day_of_week",
    "week_of_year", "hour", "minute", "second", "last_day", "make_date",
    "date_add", "date_sub", "datediff", "date_trunc", "months_between",
    "to_timestamp_seconds", "to_timestamp_millis", "to_timestamp_micros",
    "unix_timestamp", "murmur3_hash", "xxhash64", "character_length",
    "bit_length", "octet_length", "ascii", "substr", "left", "right",
    "trim", "ltrim", "rtrim", "btrim", "starts_with", "ends_with",
    "contains", "strpos", "reverse", "concat", "repeat", "check_overflow",
    "make_decimal", "unscaled_value", "normalize_nan_and_zero", "acosh",
})
# control arguments that must be literals for the device form
_LITERAL_ARGS = {"repeat": 1, "starts_with": 1, "ends_with": 1,
                 "contains": 1, "strpos": 1}


def is_device_type(dt: DataType) -> bool:
    return not dt.is_nested and not dt.is_wide_decimal


def _has_kind(e: Node, kinds) -> bool:
    stack = [e]
    while stack:
        n = stack.pop()
        if getattr(n, "kind", None) in kinds:
            return True
        stack.extend(c for c in n.children_nodes() if isinstance(c, Node))
    return False


def tree_has_row_base(e: Node) -> bool:
    """Does this expression tree read the running row offset?"""
    return _has_kind(e, _ROW_BASE_KINDS)


def _device_cast_ok(src: DataType, dst: DataType) -> bool:
    # parsing text runs on the host; formatting a float or a decimal too
    if src.is_stringlike and not dst.is_stringlike:
        return False
    if dst.is_stringlike and not src.is_stringlike:
        return src.is_integral or src.id == TypeId.BOOL
    return not (src.is_nested or dst.is_nested)


def device_capable(expr: E.Expr, schema: Schema,
                   host_cols: frozenset) -> bool:
    """Can this whole expression tree run over device columns (the JAX
    package's `exprs/compiler.py::device_capable`, over the kinds the
    port's IR has)?"""
    from auron_tpu_torch.exprs.typing import infer_type
    k = expr.kind
    if k in _HOST_KINDS:
        return False
    if k == "column":
        try:
            i = schema.index_of(expr.name)
        except KeyError:
            return False
        return expr.name not in host_cols and is_device_type(schema[i].dtype)
    if k == "literal":
        return is_device_type(expr.dtype) or expr.dtype.id == TypeId.NULL
    if k == "scalar_function":
        if expr.name not in _DEVICE_FUNCS:
            return False
        lit_from = _LITERAL_ARGS.get(expr.name)
        if lit_from is not None and any(a.kind != "literal"
                                        for a in expr.args[lit_from:]):
            return False
        if expr.name in ("trim", "btrim", "ltrim", "rtrim") \
                and len(expr.args) > 1:
            return False
        if expr.name == "date_trunc" and expr.args[0].kind != "literal":
            return False
    if k in ("cast", "try_cast"):
        try:
            src = infer_type(expr.child, schema)
        except (TypeError, KeyError, NotImplementedError):
            return False
        if not _device_cast_ok(src, expr.dtype):
            return False
    try:
        dt = infer_type(expr, schema)
    except (TypeError, KeyError, NotImplementedError):
        return False
    if not (is_device_type(dt) or dt.id == TypeId.NULL):
        return False
    return all(device_capable(c, schema, host_cols)
               for c in _expr_children(expr))


def _expr_children(expr: Node) -> List[E.Expr]:
    out = []
    for c in expr.children_nodes():
        if isinstance(c, E.Expr):
            out.append(c)
        elif isinstance(c, Node):
            out.extend(_expr_children(c))
    return out


def _static_host_cols(schema: Schema) -> frozenset:
    """Columns whose static type keeps them on the host; an expression
    over one cannot enter the fragment."""
    return frozenset(f.name for f in schema.fields
                     if not is_device_type(f.dtype))


def exprs_fusable(exprs, schema: Schema) -> Optional[str]:
    """None when every expression can run inside a fragment; otherwise
    the decline reason."""
    host = _static_host_cols(schema)
    for x in exprs:
        if x is None:
            continue
        if tree_has_row_base(x):
            # the running row offset depends on the upstream batches; a
            # fused filter would renumber rows mid-fragment
            return "row-position expression (row_num / " \
                   "monotonically_increasing_id)"
        if x.kind == "column" and x.name in host:
            return f"host-resident column {x.name!r} crosses the fragment"
        if not device_capable(x, schema, host):
            return "expression is not device-capable (host island)"
    return None


def _op_fusable(node: P.PlanNode, in_schema: Optional[Schema],
                chain_so_far: List[P.PlanNode]) -> Optional[str]:
    """None when `node` may extend a fragment whose chain (input first)
    is `chain_so_far`; otherwise the decline reason."""
    if in_schema is None:
        return "input schema could not be inferred"
    k = node.kind
    if k == "projection":
        return exprs_fusable(node.exprs, in_schema)
    if k == "filter":
        return exprs_fusable(node.predicates, in_schema)
    if k == "expand":
        for proj in node.projections:
            r = exprs_fusable(proj, in_schema)
            if r is not None:
                return r
        return None
    if k == "limit":
        if any(c.kind == "expand" for c in chain_so_far):
            # a limit above an expand counts rows across the lanes of
            # every batch
            return "limit above an expand fan-out"
        return None
    if k in ("rename_columns", "coalesce_batches"):
        return None
    return f"operator {k!r} is not row-local"


# -- the rewrite ----------------------------------------------------------------

def _replace_plan_children(node: Node, mapping: Dict[int, Node]) -> Node:
    """`node` rebuilt with its direct plan children swapped per `mapping`
    (id -> replacement), through wrapper nodes."""

    def sub(v):
        if isinstance(v, P.PlanNode):
            return mapping.get(id(v), v)
        if isinstance(v, tuple):
            return tuple(sub(x) for x in v)
        if isinstance(v, Node) and not isinstance(v, E.Expr):
            return _replace_plan_children(v, mapping)
        return v

    kw = {}
    for f in dataclasses.fields(node):
        old = getattr(node, f.name)
        new = sub(old)
        if new is not old:
            kw[f.name] = new
    return dataclasses.replace(node, **kw) if kw else node


def fuse_plan(plan: P.PlanNode,
              report: Optional[FusionReport] = None) -> P.PlanNode:
    """`plan` with its maximal row-local chains (two operators or more)
    lowered into FusedFragment nodes.  Idempotent: existing fragments
    pass through untouched and never nest."""
    from auron_tpu_torch.analysis.schema_infer import SchemaContext
    ctx = SchemaContext(plan)
    rep = report if report is not None else FusionReport()

    order = [n for n in P.walk(plan) if isinstance(n, P.PlanNode)]
    new: Dict[int, P.PlanNode] = {}
    # the bodies of existing fragments pass through verbatim: their
    # operators seed no fragment of their own
    inside_body: set = set()
    for node in order:
        if node.kind == "fused_fragment" and node.body is not None:
            inside_body.update(id(sub) for sub in P.walk(node.body))

    for node in reversed(order):          # children before parents
        if id(node) in inside_body:
            new[id(node)] = node
            continue
        rebuilt = _replace_plan_children(node, new)
        if node.kind in FUSABLE_KINDS:
            kids = P.plan_children(node)
            child = kids[0] if len(kids) == 1 else None
            in_schema = ctx.schema_of(child) if child is not None else None
            new_child = new.get(id(child), child) if child is not None \
                else None
            if isinstance(new_child, P.FusedFragment):
                chain, _ = body_chain(new_child.body)
                reason = _op_fusable(node, in_schema, chain)
                if reason is None:
                    body = _replace_plan_children(
                        node, {id(child): new_child.body})
                    new[id(node)] = P.FusedFragment(
                        child=new_child.child, body=body,
                        schema=ctx.schema_of(node))
                    continue
                rep.declined.append(_decline(node, reason, ctx))
            elif child is not None:
                reason = _op_fusable(node, in_schema, [])
                if reason is None:
                    body = _replace_plan_children(
                        node, {id(child): P.FragmentInput(
                            schema=in_schema)})
                    new[id(node)] = P.FusedFragment(
                        child=new_child, body=body,
                        schema=ctx.schema_of(node))
                    continue
                rep.declined.append(_decline(node, reason, ctx))
        new[id(node)] = rebuilt

    # a fragment of one operator fuses nothing: unwrap it back to the
    # plain operator, so that only real fragments show
    root = _unwrap_singletons(new[id(plan)])
    rep.fragments.extend(n for n in P.walk(root)
                         if isinstance(n, P.FusedFragment))
    return root


def _decline(node: P.PlanNode, reason: str, ctx) -> Diagnostic:
    return Diagnostic(
        severity="info", pass_id=PASS_ID, path=ctx.path_of(node),
        node_kind=node.kind, message=f"fusion declined: {reason}",
        hint="the operator executes unfused; see runtime/fusion.py "
             "legality rules")


def _unwrap_singletons(plan: P.PlanNode) -> P.PlanNode:
    order = [n for n in P.walk(plan) if isinstance(n, P.PlanNode)]
    new: Dict[int, P.PlanNode] = {}
    for node in reversed(order):
        rebuilt = _replace_plan_children(node, new)
        if isinstance(rebuilt, P.FusedFragment):
            chain, err = body_chain(rebuilt.body)
            if err is None and len(chain) < 2:
                rebuilt = _splice_body(rebuilt.body, rebuilt.child) \
                    or rebuilt
        new[id(node)] = rebuilt
    return new[id(plan)]


def _splice_body(body: P.PlanNode,
                 replacement: P.PlanNode) -> Optional[P.PlanNode]:
    """A fragment body with its FragmentInput leaf replaced by
    `replacement`, rebuilt along the chain."""
    chain, err = body_chain(body)
    if err is not None or not chain:
        return None
    cur = replacement
    for op in chain:                      # input first
        inputs = P.plan_children(op)
        cur = _replace_plan_children(op, {id(inputs[0]): cur})
    return cur


def unfuse_plan(plan: P.PlanNode) -> P.PlanNode:
    """The inverse rewrite: every fragment's body spliced back over its
    child, the exact unfused tree."""
    order = [n for n in P.walk(plan) if isinstance(n, P.PlanNode)]
    new: Dict[int, P.PlanNode] = {}
    for node in reversed(order):
        rebuilt = _replace_plan_children(node, new)
        if isinstance(rebuilt, P.FusedFragment):
            rebuilt = _splice_body(rebuilt.body, rebuilt.child) or rebuilt
        new[id(node)] = rebuilt
    return new[id(plan)]


# -- the planner's cached entry point, and explain ------------------------------

# fused plans by the original plan's identity, with a weakref guarding
# against id reuse (as analysis._VERIFIED): the tasks of one plan fuse once
_FUSED: Dict[int, Tuple["weakref.ref", P.PlanNode, FusionReport]] = {}


def fuse_plan_cached(plan: P.PlanNode
                     ) -> Tuple[P.PlanNode, FusionReport]:
    hit = _FUSED.get(id(plan))
    if hit is not None and hit[0]() is plan:
        return hit[1], hit[2]
    rep = FusionReport()
    fused = fuse_plan(plan, rep)
    _FUSED[id(plan)] = (
        weakref.ref(plan, lambda _r, _i=id(plan), _m=_FUSED:
                    _m.pop(_i, None)),
        fused, rep)
    return fused, rep


def explain(plan: P.PlanNode, indent: int = 0) -> str:
    """The plan with its fragment boundaries: a fragment prints as one
    `FusedFragment[op <- op <- ...]` line (output first) over its real
    input."""
    lines: List[str] = []
    stack = [(plan, indent)]
    while stack:
        node, depth = stack.pop()
        pad = "  " * depth
        if isinstance(node, P.FusedFragment):
            chain, err = body_chain(node.body)
            ops = " <- ".join(c.kind for c in reversed(chain)) \
                if err is None else f"<malformed: {err}>"
            lines.append(f"{pad}FusedFragment[{ops}]")
            stack.append((node.child, depth + 1))
            continue
        lines.append(f"{pad}{type(node).__name__}")
        stack.extend((c, depth + 1)
                     for c in reversed(P.plan_children(node)))
    return "\n".join(lines)
