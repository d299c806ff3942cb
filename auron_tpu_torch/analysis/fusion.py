"""Fusion legality contract for FusedFragment plan nodes (counterpart
of auron_tpu/analysis/fusion.py).

Two consumers share these rules:

- `runtime/fusion.py` (the rewriter) asks `fusable_kind` while DECIDING
  what to fuse; its expression checks (can every stage expression run
  over the fragment's columns on the device) live there;
- `FusionContractPass` (in `analysis.passes.default_passes`) verifies
  plans that already CONTAIN fused fragments (deserialized tasks,
  hand-built tests): a fused body must be a pure chain of row-local
  kinds over exactly one FragmentInput, schemas must agree across the
  fused boundary, and pipeline breakers (sort, agg, joins, window,
  exchanges) never appear inside a body.

Violations are structural corruption (a rewrite bug, a hand-edited
plan), so they are errors: the executor's verify gate refuses the plan
with a node path instead of failing inside the fused operator.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from auron_tpu_torch.analysis.diagnostics import DiagnosticSink
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import Schema, TypeId

PASS_ID = "fusion"

# Row-local operators a fused fragment body may contain: one input batch
# in, zero-or-more same-partition batches out, no cross-batch reordering.
FUSABLE_KINDS = ("projection", "filter", "coalesce_batches", "limit",
                 "expand", "rename_columns")


def fusable_kind(kind: str) -> bool:
    return kind in FUSABLE_KINDS


def body_chain(body: P.PlanNode
               ) -> Tuple[List[P.PlanNode], Optional[str]]:
    """Decompose a fragment body into its operator chain, INPUT-first
    (the FragmentInput end first, the fragment's output operator last).
    Returns (chain, error): error is a human-readable structural
    complaint when the body is not a pure fusable chain over exactly one
    FragmentInput."""
    chain: List[P.PlanNode] = []
    node = body
    seen = 0
    while True:
        if isinstance(node, P.FragmentInput):
            break
        if not isinstance(node, P.PlanNode):
            return [], f"body contains a non-plan node {type(node).__name__}"
        if node.kind == "fused_fragment":
            return [], "nested fused_fragment inside a fragment body"
        if not fusable_kind(node.kind):
            return [], (f"non-row-local operator {node.kind!r} inside a "
                        f"fragment body")
        chain.append(node)
        kids = P.plan_children(node)
        if len(kids) != 1:
            return [], (f"body operator {node.kind!r} has {len(kids)} "
                        f"plan children; fragment chains are unary")
        node = kids[0]
        seen += 1
        if seen > 10000:
            return [], "fragment body chain exceeds 10000 operators"
    chain.reverse()
    return chain, None


def _schemas_agree(a: Schema, b: Schema) -> bool:
    if len(a) != len(b):
        return False
    for fa, fb in zip(a.fields, b.fields):
        if fa.name != fb.name:
            return False
        if fa.dtype != fb.dtype and fa.dtype.id != TypeId.NULL \
                and fb.dtype.id != TypeId.NULL:
            return False
    return True


def check_fragment(ctx, node: P.FusedFragment, path: str,
                   sink: DiagnosticSink) -> None:
    """The FusionContractPass body for one fused_fragment node; `ctx` is
    the analyzer's SchemaContext."""
    if node.body is None or node.child is None:
        sink.error(PASS_ID, path, node,
                   "fused_fragment without a body/child")
        return
    chain, err = body_chain(node.body)
    if err is not None:
        sink.error(PASS_ID, path, node, err,
                   hint="fragment bodies may only chain "
                        + ", ".join(FUSABLE_KINDS)
                        + " over one fragment_input leaf")
        return
    if not chain:
        sink.error(PASS_ID, path, node,
                   "empty fragment body (bare fragment_input)",
                   hint="a fragment must fuse at least one operator")
        return
    # input boundary: the FragmentInput's declared schema must match what
    # the fragment's real child produces (name+dtype; nullability is
    # advisory — the stages themselves are nullability-preserving)
    frag_in = chain[0]
    inputs = P.plan_children(frag_in)
    fin = inputs[0] if inputs else None
    child_schema = ctx.schema_of(node.child)
    if isinstance(fin, P.FragmentInput) and fin.schema is not None \
            and child_schema is not None:
        if not _schemas_agree(fin.schema, child_schema):
            sink.error(
                PASS_ID, path, node,
                f"fragment_input schema {fin.schema!r} disagrees with "
                f"the fused child's output schema {child_schema!r}",
                hint="regenerate the fragment with runtime/fusion.py "
                     "instead of editing the body in place")
        else:
            for fa, fb in zip(fin.schema.fields, child_schema.fields):
                if fb.nullable and not fa.nullable:
                    sink.warning(
                        PASS_ID, path, node,
                        f"fragment input column {fa.name!r} declared "
                        f"non-nullable but the child may produce nulls")
    # output boundary: declared fragment schema == inferred body schema
    body_schema = ctx.schema_of(node.body)
    if node.schema is not None and body_schema is not None \
            and not _schemas_agree(node.schema, body_schema):
        sink.error(
            PASS_ID, path, node,
            f"declared fragment schema {node.schema!r} disagrees with "
            f"the fused chain's output schema {body_schema!r}")
