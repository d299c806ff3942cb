"""auron_tpu_torch.analysis: the pass-based static verifier of the plan
IR (counterpart of auron_tpu/analysis).

Schema inference and checking, column resolution, partitioning
contracts, fusion legality, the broadcast-join contracts, the lints and
the serde round trip run as ordered passes under a PassManager and give
structured Diagnostics in place of whatever would have failed first at
execution time.

Entry points:
- analyze(plan)      -> AnalysisResult (diagnostics, never raises)
- verify(plan)       -> raises PlanVerificationError on errors
- verify_task(task)  -> the executor's verify-before-execute gate
                        (`auron.plan.verify`), cached per plan identity,
                        its diagnostics logged through the
                        `auron_tpu_torch.analysis` logger, which the
                        task scope prefixes with [stage N part M]
                        (runtime/task_logging.py)
"""

from __future__ import annotations

import logging
import weakref
from typing import Dict, Optional

from auron_tpu_torch.analysis.adaptive import (  # noqa: F401 - public API
    AdaptiveContractPass,
)
from auron_tpu_torch.analysis.diagnostics import (  # noqa: F401
    AnalysisResult, Diagnostic, DiagnosticSink, PlanVerificationError,
)
from auron_tpu_torch.analysis.passes import (  # noqa: F401 - public API
    ColumnResolutionPass, FusionContractPass, PartitioningContractsPass,
    Pass, PassManager, SchemaCheckPass, SerdeRoundTripPass, TpuLintPass,
    analyze, default_passes, verify,
)
from auron_tpu_torch.analysis.schema_infer import SchemaContext  # noqa: F401

log = logging.getLogger("auron_tpu_torch.analysis")

# plans verified in this process, by object identity, with a weakref
# guarding against id reuse: the tasks of one plan (its partitions) pay
# the analyzer once
_VERIFIED: Dict[int, "weakref.ref"] = {}


def _already_verified(node) -> bool:
    r = _VERIFIED.get(id(node))
    return r is not None and r() is node


def _mark_verified(node) -> None:
    _VERIFIED[id(node)] = weakref.ref(
        node, lambda _r, _i=id(node), _m=_VERIFIED: _m.pop(_i, None))


def verify_task(task, emit_log: bool = True) -> Optional[AnalysisResult]:
    """Verify a TaskDefinition (or a bare plan) before execution: each
    diagnostic is logged (an error at ERROR, a warning at WARNING, an
    info at DEBUG), and PlanVerificationError raised when any is an
    error.  Returns None for a plan already verified."""
    plan = getattr(task, "plan", task)
    if plan is None or _already_verified(plan):
        return None
    res = analyze(task)
    if emit_log:
        level = {"error": logging.ERROR, "warning": logging.WARNING,
                 "info": logging.DEBUG}
        for d in res.diagnostics:
            log.log(level.get(d.severity, logging.DEBUG),
                    "plan verifier: %s", d)
    if not res.ok:
        raise PlanVerificationError(res.diagnostics)
    _mark_verified(plan)
    return res
