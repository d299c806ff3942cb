"""Adaptive-execution contract pass (counterpart of
auron_tpu/analysis/adaptive.py).

The JAX package re-runs every plan its adaptive replanner rewrites
through the whole analyzer battery; this pass checks the shapes those
rewrites produce, and in the default battery it guards hand-built and
converted plans that use the same nodes:

- a BroadcastJoin carrying `cached_build_hash_map_id` must find a
  BroadcastJoinBuildHashMap with the SAME cache id on its broadcast
  side (a mismatched id would probe whatever table that id caches);
- a BroadcastJoinBuildHashMap's keys must be non-empty when its parent
  join has join keys;
- the broadcast side of a BroadcastJoin must be one whose build rows
  are never emitted unmatched, since the build table is shared across
  probe partitions (build-side outer rows would come out once per
  partition).
"""

from __future__ import annotations

from auron_tpu_torch.analysis.diagnostics import DiagnosticSink
from auron_tpu_torch.analysis.passes import Pass
from auron_tpu_torch.analysis.schema_infer import SchemaContext
from auron_tpu_torch.ir import plan as P

# the join types whose build side may be shared across probe partitions
# (the JAX package's runtime/adaptive._BCAST_SAFE_TYPES)
_BCAST_SAFE_TYPES = {
    "right": {"inner", "left", "left_semi", "left_anti", "existence"},
    "left": {"inner", "right", "right_semi", "right_anti"},
}


class AdaptiveContractPass(Pass):
    id = "adaptive"

    def run(self, ctx: SchemaContext, sink: DiagnosticSink) -> None:
        for node, path in ctx.nodes():
            if not isinstance(node, P.BroadcastJoin):
                continue
            side = node.broadcast_side
            build = node.right if side == "right" else node.left
            if isinstance(build, P.BroadcastJoinBuildHashMap):
                if node.cached_build_hash_map_id and \
                        build.cache_id != node.cached_build_hash_map_id:
                    sink.error(
                        self.id, path, node,
                        "BroadcastJoin cache id "
                        f"{node.cached_build_hash_map_id!r} does not "
                        f"match its build node's {build.cache_id!r}",
                        hint="the probe would read a stale or empty "
                             "cached build table; rewrites must mint "
                             "one id for both nodes")
                keys = node.on.right_keys if side == "right" \
                    else node.on.left_keys
                if keys and not build.keys:
                    sink.error(
                        self.id, path, node,
                        "broadcast build node carries no build keys "
                        "while the join has join keys",
                        hint="a conversion must copy the build side's "
                             "join keys onto the "
                             "BroadcastJoinBuildHashMap")
            if node.join_type not in _BCAST_SAFE_TYPES.get(side, ()):
                sink.error(
                    self.id, path, node,
                    f"join type {node.join_type!r} cannot broadcast "
                    f"its {side} side: the shared build table would "
                    "emit build-side unmatched rows once per probe "
                    "partition",
                    hint="keep the shuffled form")
