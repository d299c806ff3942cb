"""Convertibility tagging over a foreign plan (counterpart of
auron_tpu/frontend/strategy.py, after Auron's AuronConvertStrategy).

Every node gets a convert strategy in {DEFAULT, ALWAYS_CONVERT,
NEVER_CONVERT}; the pass runs (1) a bottom-up dry-run conversion filling
the convertible tag, (2) childOrderingRequired propagation, (3) the
anti-thrash `_remove_inefficient_converts` fixpoint, then (4) the
per-op AlwaysConvert rules.  For the same plan and configuration it
tags every node as the JAX package does, with the same reasons, as far
as the port's converter converts what the JAX package's does
(frontend/expr_convert.py names the expression kinds it lacks).
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

from auron_tpu_torch.frontend import converters
from auron_tpu_torch.frontend.foreign import ForeignNode


class ConvertStrategy(enum.Enum):
    DEFAULT = "default"
    ALWAYS_CONVERT = "always_convert"
    NEVER_CONVERT = "never_convert"


_AGG_OPS = {"HashAggregateExec", "ObjectHashAggregateExec",
            "SortAggregateExec"}


class Tags:
    """Per-node tag store keyed by node identity (the TreeNodeTag
    analogue)."""

    def __init__(self) -> None:
        self.strategy: Dict[int, ConvertStrategy] = {}
        self.convertible: Dict[int, bool] = {}
        self.never_reason: Dict[int, str] = {}
        self.child_ordering_required: Dict[int, bool] = {}

    def is_never_convert(self, n: ForeignNode) -> bool:
        return self.strategy.get(id(n)) is ConvertStrategy.NEVER_CONVERT

    def is_always_convert(self, n: ForeignNode) -> bool:
        return self.strategy.get(id(n)) is ConvertStrategy.ALWAYS_CONVERT

    def set_never(self, n: ForeignNode, reason: str) -> None:
        self.strategy[id(n)] = ConvertStrategy.NEVER_CONVERT
        self.never_reason[id(n)] = reason

    def reason(self, n: ForeignNode) -> Optional[str]:
        return self.never_reason.get(id(n))


def apply(plan: ForeignNode) -> Tags:
    tags = Tags()
    plan.foreach(lambda n: (
        tags.strategy.__setitem__(id(n), ConvertStrategy.DEFAULT),
        tags.convertible.__setitem__(id(n), True)))

    # (1) bottom-up convertibility dry-run (:55-76)
    def probe(n: ForeignNode) -> None:
        reason = converters.dry_run_convertible(n)
        if reason is None:
            tags.convertible[id(n)] = True
        else:
            tags.convertible[id(n)] = False
            tags.set_never(n, reason)
    plan.foreach_up(probe)

    # (2) childOrderingRequired propagation (:86-115): foreign nodes
    # declare per-child ordering requirements; SortExec resets it.
    def fill_ordering(n: ForeignNode) -> None:
        required = n.attrs.get("required_child_ordering")
        if required:
            for child, req in zip(n.children, required):
                if req:
                    tags.child_ordering_required[id(child)] = True
    plan.foreach(fill_ordering)

    def propagate_ordering(n: ForeignNode) -> None:
        if n.op == "SortExec":
            tags.child_ordering_required[id(n)] = False
        elif tags.child_ordering_required.get(id(n)):
            for child in n.children:
                tags.child_ordering_required[id(child)] = True
    plan.foreach(propagate_ordering)

    # (3) anti-thrash fixpoint (:201-283)
    _remove_inefficient_converts(plan, tags)

    # (4) per-op AlwaysConvert decisions (:122-190)
    def is_native(n: ForeignNode) -> bool:
        return tags.is_always_convert(n)

    def decide(n: ForeignNode) -> None:
        if tags.is_never_convert(n) or tags.is_always_convert(n):
            return
        op, ch = n.op, n.children
        always = False
        if op == "ShuffleExchangeExec":
            always = not ch or is_native(ch[0]) or ch[0].op not in _AGG_OPS
        elif op in ("BroadcastExchangeExec", "FileSourceScanExec",
                    "LocalTableScanExec", "SortExec"):
            always = True
        elif op in ("ProjectExec", "FilterExec", "LocalLimitExec",
                    "GlobalLimitExec", "TakeOrderedAndProjectExec",
                    "CollectLimitExec", "ExpandExec", "WindowExec",
                    "WindowGroupLimitExec", "GenerateExec",
                    *_AGG_OPS):
            always = bool(ch) and is_native(ch[0])
        elif op == "UnionExec":
            n_native = sum(1 for c in ch if is_native(c))
            n_never = sum(1 for c in ch if tags.is_never_convert(c))
            always = n_native >= n_never
        elif op in ("SortMergeJoinExec", "ShuffledHashJoinExec"):
            always = any(is_native(c) for c in ch)
        elif op == "BroadcastHashJoinExec":
            always = all(is_native(c) for c in ch)
        elif op in ("DataWritingCommandExec", "InsertIntoHiveTableExec"):
            always = bool(ch) and is_native(ch[0])
        elif converters.ext_convert_supported(n):
            always = True
        if always:
            tags.strategy[id(n)] = ConvertStrategy.ALWAYS_CONVERT
        else:
            tags.set_never(n, f"{op} not marked, default to NeverConvert.")
    plan.foreach_up(decide)
    return tags


def _remove_inefficient_converts(plan: ForeignNode, tags: Tags) -> None:
    """The four anti-thrash rules, iterated to fixpoint: converts that
    would introduce a C2N/N2C transition moving many rows get demoted."""
    finished = False
    while not finished:
        finished = True

        def dont_convert_if(n: ForeignNode, cond: bool, reason: str) -> None:
            nonlocal finished
            if cond and not tags.is_never_convert(n):
                tags.set_never(n, reason)
                finished = False

        def visit(n: ForeignNode) -> None:
            # NonNative -> NativeFilter / NativeAgg: needs a bulk C2N
            if not tags.is_never_convert(n) and \
                    n.op in ("FilterExec", *_AGG_OPS) and n.children:
                dont_convert_if(n, tags.is_never_convert(n.children[0]),
                                f"{n.op}, children is not native.")
            # Agg -> NativeShuffle: next stage likely reads non-natively
            if not tags.is_never_convert(n) and \
                    n.op == "ShuffleExchangeExec" and n.children:
                c = n.children[0]
                dont_convert_if(
                    n, c.op in _AGG_OPS and tags.is_never_convert(c),
                    f"{n.op}, children is not native and children is agg.")
            if tags.is_never_convert(n):
                # NativeExpand/NativeScan -> NonNative: needs a bulk N2C
                for c in n.children:
                    if c.op == "ExpandExec":
                        dont_convert_if(c, not tags.is_never_convert(c),
                                        f"{n.op}, children is nativeExpand.")
                    if c.op == "FileSourceScanExec":
                        dont_convert_if(
                            c, not tags.is_never_convert(c),
                            f"{n.op}, children is nativeParquetScan.")
                    # NonNative -> NativeSort -> NonNative sandwich
                    if c.op == "SortExec" and c.children:
                        dont_convert_if(
                            c,
                            not tags.is_never_convert(c) and
                            tags.is_never_convert(c.children[0]),
                            f"{n.op}, children and parent both are "
                            "not native.")
        plan.foreach(visit)
