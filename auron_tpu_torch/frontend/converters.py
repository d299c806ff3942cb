"""A converted query's data holders (counterpart of the data classes of
auron_tpu/frontend/converters.py).

A converted query is a root plan plus the stages it reads: each
exchange (`ShuffleJob`: its map side's plan and partitioning) and each
broadcast (`BroadcastJob`: the plan whose rows it collects) sits behind
an `IpcReader` of its resource id, and each front-end table behind an
`FFIReader` (`ForeignSource`).  `ConvertContext` holds them with each
stage's partition count.  The JAX package's converter from a foreign
plan (`convert_recursively` and the strategy) is not in the port:
`from_stage_plans` builds a converted query from its stage plans, in
the form the converter's golden plans and `chip_smoke.py` hold them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Tuple

from auron_tpu_torch.ir import plan as P


@dataclass
class ShuffleJob:
    """An exchange: the session runs `child` as a map stage partitioned
    by `partitioning`, then serves reduce-side blocks under `rid`."""
    rid: str
    child: P.PlanNode = None  # type: ignore[assignment]
    partitioning: P.Partitioning = None  # type: ignore[assignment]


@dataclass
class BroadcastJob:
    """A broadcast: the session collects `child` once (all partitions)
    and serves its rows under `rid` to every task that reads it."""
    rid: str
    child: P.PlanNode = None  # type: ignore[assignment]


@dataclass
class ForeignSource:
    """A front-end table fed to the `FFIReader`s of resource `rid`; the
    caller passes its rows with the query (`AuronSession`'s `sources`).
    The JAX package's foreign subtree, run by its host engine, has no
    counterpart here."""
    rid: str


class ConvertContext:
    def __init__(self) -> None:
        self.exchanges: Dict[str, ShuffleJob] = {}
        self.broadcasts: Dict[str, BroadcastJob] = {}
        self.sources: Dict[str, ForeignSource] = {}
        # partition count of each stage plan, keyed by identity
        self.n_parts: Dict[int, int] = {}

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


def _readers(plan: P.PlanNode, kind: str) -> list:
    return list(dict.fromkeys(n.resource_id for n in stage_nodes(plan)
                              if n.kind == kind))


def _stage_parts(plan: P.PlanNode, exchanges: Mapping[str, ShuffleJob],
                 parts: Mapping[str, int]) -> int:
    """A stage's task count: a union's partitions, else the split count
    of the first table it scans, else the partition count of the first
    exchange it reads, else 1."""
    for n in stage_nodes(plan):
        if n.kind == "union":
            return n.num_partitions
    scans = _readers(plan, "ffi_reader")
    if scans:
        return int(parts.get(scans[0], 1))
    for rid in _readers(plan, "ipc_reader"):
        if rid in exchanges:
            return exchanges[rid].partitioning.num_partitions
    return 1


def from_stage_plans(plans: Mapping[str, P.PlanNode],
                     parts: Optional[Mapping[str, int]] = None
                     ) -> Tuple[P.PlanNode, ConvertContext]:
    """(root, ConvertContext) of a query given as its stage plans:
    {resource id: plan} and "root", an exchange's plan its
    `RssShuffleWriter`, a broadcast's the plan whose rows it collects.
    `parts` holds each scanned table's split count (one map task a
    split); a table it does not name is one split."""
    parts = dict(parts or {})
    ctx = ConvertContext()
    for rid, plan in plans.items():
        if rid == "root":
            continue
        if isinstance(plan, P.RssShuffleWriter):
            ctx.exchanges[rid] = ShuffleJob(rid, plan.child,
                                            plan.partitioning)
        else:
            ctx.broadcasts[rid] = BroadcastJob(rid, plan)
    root = plans["root"]
    stages = [root] + [j.child for j in ctx.exchanges.values()] + \
        [j.child for j in ctx.broadcasts.values()]
    for plan in stages:
        ctx.set_parts(plan, _stage_parts(plan, ctx.exchanges, parts))
        for rid in _readers(plan, "ffi_reader"):
            ctx.sources.setdefault(rid, ForeignSource(rid))
    return root, ctx
