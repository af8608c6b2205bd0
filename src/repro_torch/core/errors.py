"""Typed compile-failure taxonomy (DESIGN.md §9).

Every failure the compiler can surface to a caller is a :class:`CompileError`
subclass, so `hls.compile` users can distinguish "your spec is unsatisfiable"
from "the environment misbehaved" without string-matching.  Transient faults
(worker crashes, torn cache blobs) are normally *recovered* — retried,
quarantined, or repaired — and reported through ``CompileResult.diagnostics``
rather than raised; these types cover the cases where recovery is impossible
or the caller asked for strictness.
"""
from __future__ import annotations

from dataclasses import dataclass


class CompileError(Exception):
    """Base class for all structured compilation failures."""


class ScheduleInfeasible(CompileError):
    """No feasible static schedule exists for the requested configuration.

    Also raised when conservative solver degradation leaves the II search
    without a provably feasible point — an honest failure, never a silently
    wrong schedule.
    """


class SolverTruncated(CompileError):
    """An ILP search was cut off (deadline/node cap) with no usable bound."""


class WorkerFault(CompileError):
    """A DSE pool worker failed permanently (quarantined after retries)."""


class CacheFault(CompileError):
    """The persistent cache is unusable beyond per-entry repair."""


class NestContractViolation(CompileError):
    """A layer was handed a nest shape outside what it supports.

    The shape vocabulary is `ir.nest_shape` (DESIGN.md §11): every rejection
    names a machine-readable ``code`` (e.g. ``"multi-chain"``,
    ``"imperfect-nest"``, ``"reduction"``, ``"top-level-ops"``), the layer
    that refused (``where``), and the offending task/array in ``detail`` —
    replacing the old reject-by-diagnostic-string sites in ``dataflow.py``
    and ``codegen.py`` so ``CompileResult.diagnostics`` is uniform.
    """

    def __init__(self, code: str, where: str, detail: str):
        self.code = str(code)
        self.where = str(where)
        self.detail = str(detail)
        super().__init__(f"{where}: [{code}] {detail}")

    def as_diagnostic(self) -> dict:
        return {"kind": f"{self.where}-rejection", "code": self.code,
                "detail": self.detail}


@dataclass(frozen=True)
class Diagnostic:
    """One structured static-analysis finding (DESIGN.md §12).

    The same shape as :meth:`NestContractViolation.as_diagnostic` — a
    machine-readable ``code`` (the vocabulary is ``analysis.LINT_CODES`` /
    ``analysis.VALIDATE_CODES``), the program location that triggered it
    (``where``, e.g. ``"harris/Ix[load uid=12]"``), a ``severity`` of
    ``"error"`` (the program or schedule is wrong) or ``"warning"``
    (suspicious but executable), and a human-readable ``detail``.

    Unlike :class:`NestContractViolation` a Diagnostic is a *value*, not an
    exception: linting never aborts compilation, it reports through
    ``CompileResult.diagnostics``.
    """

    code: str
    where: str
    severity: str  # "error" | "warning"
    detail: str

    def sort_key(self) -> tuple:
        """Stable severity-first ordering (errors before warnings)."""
        return (0 if self.severity == "error" else 1,
                self.code, self.where, self.detail)

    def as_dict(self, kind: str = "lint") -> dict:
        return {"kind": kind, "code": self.code, "severity": self.severity,
                "where": self.where, "detail": self.detail}

    def __str__(self) -> str:
        return f"{self.severity}[{self.code}] {self.where}: {self.detail}"


class StaticValidationError(CompileError):
    """The independent static validator (``repro_torch.core.analysis``) proved a
    schedule violates the dependence/port/occupancy contract.

    This means a *miscompile*: the (II, theta) assignment the scheduler
    produced lets a conflicting dynamic-instance pair execute closer than
    its required delay.  Carries the full :class:`~repro_torch.core.analysis.
    Verdict` so callers can inspect every violation witness.
    """

    def __init__(self, program_name: str, verdict):
        self.program_name = str(program_name)
        self.verdict = verdict
        probs = [d for d in verdict.diagnostics if d.severity == "error"]
        head = "; ".join(str(d) for d in probs[:3])
        more = f" (+{len(probs) - 3} more)" if len(probs) > 3 else ""
        super().__init__(
            f"schedule for '{self.program_name}' fails static validation: "
            f"{head}{more}")


class UntraceableFunction(CompileError):
    """The JAX tracing frontend met a function it cannot lower to Program IR.

    Carries the unsupported jaxpr primitive (or structural feature) so
    callers can widen the traced function rather than string-match."""

    def __init__(self, fn_name: str, primitive: str, detail: str = ""):
        self.fn_name = str(fn_name)
        self.primitive = str(primitive)
        self.detail = str(detail)
        super().__init__(
            f"cannot trace '{self.fn_name}': unsupported {self.primitive}"
            + (f" ({self.detail})" if detail else ""))


class UnlowerableProgram(CompileError):
    """The program has no CUDA lowering (``codegen.emit_cuda``).

    Raised with the full list of structural ``reasons`` — each a
    :class:`NestContractViolation` (legacy callers may still pass strings;
    they are wrapped with code ``"legacy"``) — instead of an opaque
    downstream failure.  ``emit_cuda`` additionally records the rejection
    in ``CompileResult.diagnostics`` (kind ``codegen-unlowerable``) so the
    DSE trace shows which design points cannot become kernels.
    """

    def __init__(self, program_name: str, reasons):
        self.program_name = str(program_name)
        self.violations = [
            r if isinstance(r, NestContractViolation)
            else NestContractViolation("legacy", "codegen", str(r))
            for r in reasons]
        self.reasons = [str(r) for r in reasons]
        super().__init__(
            f"program '{self.program_name}' has no CUDA lowering: "
            + "; ".join(self.reasons))
