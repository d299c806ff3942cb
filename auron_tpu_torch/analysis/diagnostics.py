"""Structured diagnostics for the plan verifier (counterpart of
auron_tpu/analysis/diagnostics.py).

The analogue of a compiler's diagnostic engine: every finding carries a
severity, the id of the pass that produced it, the dotted field-path of
the node inside the analyzed tree (``plan.child.left`` — the projection
a front-end author can map straight back to their emitter), the node
kind, a message, and an optional fix-hint.  Passes never raise on bad
plans — they emit diagnostics and keep walking, so one verifier run
reports every problem in the tree at once (the batch-reporting shape
Flare-style staged compilation relies on; PAPERS.md 1703.08219).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Diagnostic:
    severity: str            # error | warning | info
    pass_id: str             # e.g. "schema-check"
    path: str                # dotted field path from the analyzed root
    node_kind: str           # IR kind tag of the offending node
    message: str
    hint: Optional[str] = None   # how to fix, when the pass knows

    def __post_init__(self) -> None:
        assert self.severity in _SEVERITIES, self.severity

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self) -> str:
        loc = self.path or "<root>"
        s = f"{self.severity}[{self.pass_id}] {loc} ({self.node_kind}): " \
            f"{self.message}"
        if self.hint:
            s += f"  (hint: {self.hint})"
        return s


class DiagnosticSink:
    """Collector the passes write into; one per analyzer run."""

    def __init__(self) -> None:
        self.diagnostics: List[Diagnostic] = []

    def emit(self, severity: str, pass_id: str, path: str, node,
             message: str, hint: Optional[str] = None) -> None:
        kind = getattr(node, "kind", type(node).__name__) \
            if node is not None else "?"
        self.diagnostics.append(
            Diagnostic(severity, pass_id, path, kind, message, hint))

    def error(self, pass_id: str, path: str, node, message: str,
              hint: Optional[str] = None) -> None:
        self.emit(ERROR, pass_id, path, node, message, hint)

    def warning(self, pass_id: str, path: str, node, message: str,
                hint: Optional[str] = None) -> None:
        self.emit(WARNING, pass_id, path, node, message, hint)

    def info(self, pass_id: str, path: str, node, message: str,
             hint: Optional[str] = None) -> None:
        self.emit(INFO, pass_id, path, node, message, hint)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]


@dataclass
class AnalysisResult:
    """Outcome of one PassManager run over one plan tree."""
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def render(self) -> str:
        if not self.diagnostics:
            return "clean"
        return "\n".join(str(d) for d in self.diagnostics)


class PlanVerificationError(RuntimeError):
    """Raised by `verify`-mode entry points when a plan has error-severity
    diagnostics.  Carries the structured diagnostics so callers (and the
    task-log ferry) can report node paths, not just a stack trace."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = tuple(diagnostics)
        errs = [d for d in diagnostics if d.is_error]
        head = "; ".join(str(d) for d in errs[:3])
        more = f" (+{len(errs) - 3} more)" if len(errs) > 3 else ""
        super().__init__(
            f"plan verification failed with {len(errs)} error(s): "
            f"{head}{more}")

    def paths(self) -> Tuple[str, ...]:
        return tuple(d.path for d in self.diagnostics if d.is_error)
