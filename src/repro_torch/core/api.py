"""Declarative HLS compilation front end (exported as ``repro_torch.core.hls``).

The public surface is one call::

    from repro_torch.core import hls

    result = hls.compile(program, hls.CompileSpec(
        target=hls.Target(capacities={"dsp": 48}),
        objectives=(hls.minimize("latency"), hls.minimize("bram")),
        constraints=("bram <= 1.0x baseline",),
    ))
    result.best          # the design point the objectives select
    result.frontier      # every non-dominated design (pipelines + schedules
                         # + resource vectors) — the Fig. 9 trade-off curve
    result.explain()     # per-candidate accept/reject reasons

``CompileSpec`` carries *what the caller wants* — a ``Target`` (resource
model mode + per-resource capacities), one or more ``Objective``s
(lexicographic by default, ``combine="weighted"`` for scalarization),
``Constraint``s (absolute like ``dsp <= 48`` or relative to the baseline
design like ``bram <= 1.0x baseline``), and optionally a fixed
``pipeline`` — either ``Pass`` objects or the MLIR-style textual syntax
(``"normalize,fuse{shift=true},tile{sizes=8,8},unroll{factor=2}"``,
``pipeline_parse``).  With a pipeline the front end compiles exactly that
program; without one it runs the Pareto-frontier DSE
(``autotune.pareto_explore``) over the move families in ``SearchConfig``.

"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field, replace as dc_replace
from typing import Optional, Sequence, Union

from . import faults
from .autotune import (DSECandidate, MOVE_FAMILIES,
                       PARETO_METRICS, ParetoResult, _degrading,
                       dedupe_diagnostics, measure_candidate,
                       pareto_explore, validate_candidate)
from .errors import StaticValidationError
from .ir import Program
from .pipeline_parse import parse_pipeline, print_pipeline
from .transforms import Pass

# A design point of the frontier (pipeline + schedule + resource vector).
DesignPoint = DSECandidate

# Short metric aliases accepted anywhere a metric/resource is named.
METRIC_ALIASES = {
    "latency": "latency",
    "bram": "bram_bytes", "bram_bytes": "bram_bytes",
    "dsp": "dsp",
    "ff": "ff_bits", "ff_bits": "ff_bits",
    "lut": "lut",
}


def _canon_metric(name: str, *, what: str = "metric",
                  allow_latency: bool = True) -> str:
    key = METRIC_ALIASES.get(str(name).strip().lower())
    if key is None or (key == "latency" and not allow_latency):
        valid = sorted(k for k, v in METRIC_ALIASES.items()
                       if allow_latency or v != "latency")
        raise ValueError(f"unknown {what} {name!r}; valid: {', '.join(valid)}")
    return key


# ---------------------------------------------------------------------------
# Spec vocabulary: Objective / Constraint / Target / SearchConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Objective:
    """Minimize one metric.  ``weight`` only matters under
    ``combine="weighted"`` (each metric is normalized by the baseline's
    value before weighting, so weights compare like-with-like)."""

    metric: str
    weight: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "metric", _canon_metric(self.metric,
                                                         what="objective"))
        if self.weight <= 0:
            raise ValueError(f"objective weight must be > 0, got {self.weight}")


def minimize(metric: str, weight: float = 1.0) -> Objective:
    """``minimize("latency")`` / ``minimize("bram", weight=2.0)``."""
    return Objective(metric, weight)


_CONSTRAINT_RE = re.compile(
    r"^\s*(?P<res>[A-Za-z_]+)\s*<=\s*(?P<num>[0-9]*\.?[0-9]+)\s*"
    r"(?P<rel>x\s*baseline)?\s*$")


@dataclass(frozen=True)
class Constraint:
    """An upper bound on one resource: absolute (``limit``) or relative to
    the baseline design's own usage (``scale`` — ``1.0`` = iso-resource)."""

    resource: str
    limit: Optional[float] = None
    scale: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(
            self, "resource",
            _canon_metric(self.resource, what="constraint resource",
                          allow_latency=False))
        if (self.limit is None) == (self.scale is None):
            raise ValueError(
                "a Constraint needs exactly one of limit= (absolute) or "
                "scale= (x baseline)")

    @classmethod
    def parse(cls, text: str) -> "Constraint":
        """``"dsp <= 48"`` (absolute) or ``"bram <= 1.0x baseline"``
        (relative).  Only upper bounds exist — resources are costs."""
        m = _CONSTRAINT_RE.match(text)
        if not m:
            raise ValueError(
                f"malformed constraint {text!r}: expected "
                "'<resource> <= <number>' or "
                "'<resource> <= <number>x baseline' "
                "(resources: bram, dsp, ff, lut)")
        num = float(m.group("num"))
        if m.group("rel"):
            return cls(m.group("res"), scale=num)
        return cls(m.group("res"), limit=num)


def constraint(text: str) -> Constraint:
    """Alias of ``Constraint.parse`` for spec literals."""
    return Constraint.parse(text)


@dataclass(frozen=True)
class Target:
    """Where the design must fit: resource-model mode + hard capacities.

    ``mode`` selects the costing model (``dataflow.resources``): "ours"
    (default), "vitis_seq", or "vitis_dataflow".  ``capacities`` are
    absolute per-resource ceilings of the device (merged with the spec's
    ``Constraint``s; the tighter bound wins)."""

    name: str = "generic"
    mode: str = "ours"
    capacities: tuple[tuple[str, float], ...] = ()

    def __init__(self, name: str = "generic", mode: str = "ours",
                 capacities: Union[dict, Sequence, None] = None):
        if mode not in ("ours", "vitis_seq", "vitis_dataflow"):
            raise ValueError(
                f"unknown target mode {mode!r}; valid: ours, vitis_seq, "
                "vitis_dataflow")
        caps = dict(capacities or {})
        norm = tuple(sorted(
            (_canon_metric(k, what="capacity resource", allow_latency=False),
             float(v)) for k, v in caps.items()))
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "mode", mode)
        object.__setattr__(self, "capacities", norm)


@dataclass(frozen=True)
class SearchConfig:
    """Knobs of the Pareto search (ignored when the spec fixes a
    pipeline).  ``moves`` selects move families out of
    ``autotune.MOVE_FAMILIES``; ``validate`` additionally runs the
    brute-force schedule/execution oracles on the selected best point.

    ``selector`` picks the expansion-base policy ("latency" = classic
    lowest-latency-first, "hv" = hypervolume-contribution over
    archive-normalized objectives); ``macro_moves`` adds composite
    fuse>tile / fuse>unroll single-step moves; ``jobs`` fans candidate
    compiles within one expansion wave across a process pool (results are
    bit-identical to serial); ``cache`` enables the persistent compile
    cache (also gated globally by ``REPRO_HLS_CACHE``).

    ``worker_deadline_s`` bounds each parallel worker's wall-clock per
    candidate — a hung worker past the deadline is retried then
    quarantined instead of stalling the wave (DESIGN.md §9).  Like
    ``jobs`` it does not change results, only how faults are survived,
    so it is excluded from the frontier cache key.

    ``lint`` runs the whole-program IR linter (``analysis.lint``) as a
    pre-pass, feeding findings into ``CompileResult.diagnostics`` (kind
    ``"lint"``); ``static_check`` runs the independent schedule
    translation validator (``analysis.validate_static``, DESIGN.md §12)
    on the frontier winner — a proven violation raises
    :class:`~repro_torch.core.errors.StaticValidationError`.  Both default on;
    degraded-provenance schedules are validated even when
    ``static_check`` is opted out (their conservative edge bounds are
    exactly where an unnoticed miscompile would hide)."""

    moves: tuple[str, ...] = MOVE_FAMILIES
    unroll_factors: tuple[int, ...] = (2, 4)
    tile_sizes: tuple[int, ...] = (4,)
    max_candidates: int = 24
    verify: bool = True
    validate: bool = False
    seeds: tuple[int, ...] = (0,)
    selector: str = "latency"
    macro_moves: bool = False
    jobs: int = 1
    cache: bool = True
    worker_deadline_s: Optional[float] = 60.0
    lint: bool = True
    static_check: bool = True


@dataclass(frozen=True)
class CompileSpec:
    """The declarative compilation request ``hls.compile`` consumes."""

    target: Target = field(default_factory=Target)
    objectives: tuple[Objective, ...] = (Objective("latency"),)
    constraints: tuple[Union[Constraint, str], ...] = ()
    pipeline: Union[str, Sequence[Pass], None] = None
    combine: str = "lex"            # "lex" | "weighted"
    search: SearchConfig = field(default_factory=SearchConfig)

    def __post_init__(self):
        if self.combine not in ("lex", "weighted"):
            raise ValueError(
                f"unknown combine mode {self.combine!r}; valid: lex, weighted")
        objs = tuple(o if isinstance(o, Objective) else minimize(o)
                     for o in self.objectives)
        if not objs:
            raise ValueError("CompileSpec needs at least one objective")
        cons = tuple(Constraint.parse(c) if isinstance(c, str) else c
                     for c in self.constraints)
        for c in cons:
            if not isinstance(c, Constraint):
                raise ValueError(f"not a Constraint: {c!r}")
        object.__setattr__(self, "objectives", objs)
        object.__setattr__(self, "constraints", cons)


# ---------------------------------------------------------------------------
# CompileResult
# ---------------------------------------------------------------------------


@dataclass
class CompileResult:
    """What ``hls.compile`` returns.

    ``frontier`` holds every feasible non-dominated design point (latency ×
    BRAM × DSP × FF), sorted by objective vector; ``best`` is the frontier
    point the spec's objectives select (the baseline when everything was
    rejected — ``explain()`` says why).  ``candidates`` is the full search
    trace including dominated and over-capacity points."""

    program: Program
    spec: CompileSpec
    baseline: DesignPoint
    best: DesignPoint
    frontier: list[DesignPoint] = field(default_factory=list)
    candidates: list[DesignPoint] = field(default_factory=list)
    rejected: list[tuple[str, str]] = field(default_factory=list)
    caps: dict[str, float] = field(default_factory=dict)
    #: candidate evaluations charged against SearchConfig.max_candidates —
    #: invariant between cold and warm-cache runs (a cache hit still counts;
    #: it answers "how much search reached this frontier", not "how much CPU")
    compiles: int = 0
    #: structured failure-handling record (DESIGN.md §9): solver gaps,
    #: worker retries/quarantines, pool rebuilds, cache repairs
    diagnostics: list[dict] = field(default_factory=list)
    #: "degraded" when any diagnostic may have moved the result off the
    #: fault-free one; transparently recovered faults stay "exact"
    provenance: str = "exact"

    @property
    def degraded(self) -> bool:
        """True when a fault forced a conservative (sound but possibly
        suboptimal) answer somewhere — the frontier may differ from the
        fault-free run; ``diagnostics`` says where and why."""
        return self.provenance != "exact"

    @property
    def schedule(self):
        return self.best.schedule

    @property
    def speedup(self) -> float:
        """baseline latency / best latency (1.0 on degenerate latencies)."""
        if self.best.latency <= 0 or self.baseline.latency <= 0:
            return 1.0
        return self.baseline.latency / self.best.latency

    def pipeline_of(self, point: Optional[DesignPoint] = None) -> str:
        """The textual pipeline of a design point (round-trips through
        ``hls.compile(p, pipeline=...)``)."""
        return print_pipeline((point or self.best).passes)

    def knee(self, x: str = "latency", y: str = "bram",
             among: Optional[Sequence[DesignPoint]] = None) -> DesignPoint:
        """The knee point of the (x, y) projection of the frontier: the
        point closest (normalized Euclidean) to the ideal corner
        (min-x, min-y).  Degenerate axes (all equal) contribute zero."""
        pts = list(among if among is not None else self.frontier)
        if not pts:
            raise ValueError("knee() on an empty frontier")
        kx = _canon_metric(x, what="knee axis")
        ky = _canon_metric(y, what="knee axis")
        xs = [c.metric(kx) for c in pts]
        ys = [c.metric(ky) for c in pts]
        rx = (max(xs) - min(xs)) or 1.0
        ry = (max(ys) - min(ys)) or 1.0

        def dist(c):
            return math.hypot((c.metric(kx) - min(xs)) / rx,
                              (c.metric(ky) - min(ys)) / ry)

        return min(pts, key=lambda c: (dist(c), c.objectives()))

    def emit_cuda(self, point: Optional[DesignPoint] = None, *,
                  buffering: str = "double",
                  block_rows: Optional[int] = None,
                  dtype: str = "float32"):
        """Lower a frontier point (default: ``best``) to a generated CUDA
        kernel (DESIGN.md §10).  Returns a :class:`repro_torch.core.codegen.
        CudaKernel`; raises :class:`UnlowerableProgram` — also recorded in
        ``diagnostics`` — when the point's program has no lowering."""
        from . import codegen
        return codegen.emit_cuda(self, point=point, buffering=buffering,
                                 block_rows=block_rows, dtype=dtype)

    def explain(self) -> str:
        """Per-candidate accept/reject reasons, frontier first."""
        lines = ["objectives: " + ", ".join(
            f"minimize({o.metric})" +
            (f"*{o.weight:g}" if o.weight != 1.0 else "")
            for o in self.spec.objectives)]
        if self.caps:
            lines.append("capacities: " + ", ".join(
                f"{k} <= {v:g}" for k, v in sorted(self.caps.items())))
        order = {id(c): i for i, c in enumerate(self.frontier)}
        for c in sorted(self.candidates,
                        key=lambda c: (id(c) not in order,
                                       order.get(id(c), 0), c.desc)):
            mark = " <- best" if c is self.best else ""
            src = " {cache hit}" if c.cached else ""
            deg = " {degraded}" if getattr(c, "provenance", "exact") != "exact" \
                else ""
            lines.append(
                f"  {c.desc}: latency={c.latency} " +
                " ".join(f"{k}={c.res[k]:g}"
                         for k in ("bram_bytes", "dsp", "ff_bits")) +
                f" [{c.status or 'ok'}]{src}{deg}{mark}")
        for desc, reason in self.rejected:
            if not any(c.desc == desc for c in self.candidates):
                lines.append(f"  {desc}: [{reason}]")
        if self.diagnostics:
            counts: dict[str, int] = {}
            for d in self.diagnostics:
                k = str(d.get("kind", "unknown"))
                counts[k] = counts.get(k, 0) + 1
            lines.append(
                f"diagnostics ({'degraded' if self.degraded else 'exact'}): "
                + ", ".join(f"{k} x{n}" for k, n in sorted(counts.items())))
            degr = [d for d in self.diagnostics
                    if d.get("kind") == "solver-degraded"]
            # stable order regardless of which DSE candidate surfaced the
            # gap first: sort by the (src, snk, carry) site, not insertion
            for d in sorted(degr, key=lambda d: (d.get("src") or -1,
                                                 d.get("snk") or -1,
                                                 d.get("carry")
                                                 if d.get("carry") is not None
                                                 else -1)):
                lines.append(
                    f"  solver gap on ({d.get('src')}, {d.get('snk')}) "
                    f"carry={d.get('carry')}: bound={d.get('slack_bound')}"
                    + (f" gap={d['gap']:g}" if d.get("gap") is not None
                       else ""))
            for d in self.diagnostics:
                if d.get("kind") == "lint" and d.get("severity") == "error":
                    lines.append(f"  lint[{d.get('code')}] "
                                 f"{d.get('where')}: {d.get('detail')}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# hls.compile
# ---------------------------------------------------------------------------


def _select_best(frontier: Sequence[DesignPoint], baseline: DesignPoint,
                 spec: CompileSpec) -> DesignPoint:
    if not frontier:
        return baseline
    metrics = [o.metric for o in spec.objectives]
    if spec.combine == "weighted":
        def score(c: DesignPoint) -> float:
            total = 0.0
            for o in spec.objectives:
                base = baseline.metric(o.metric) or 1.0
                total += o.weight * c.metric(o.metric) / base
            return total
        return min(frontier, key=lambda c: (score(c), c.objectives()))
    order = metrics + [m for m in PARETO_METRICS if m not in metrics]
    return min(frontier, key=lambda c: tuple(c.metric(m) for m in order))


def _lint_diagnostics(program: Program) -> list[dict]:
    """The lint pre-pass: whole-program findings as diagnostic dicts."""
    from . import analysis
    return [d.as_dict(kind="lint") for d in analysis.lint(program)]


def _static_check(point, diagnostics: list[dict]) -> None:
    """Post-pass: independently validate the winning schedule (DESIGN.md
    §12).  A *proven* violation raises :class:`StaticValidationError` — it
    means a miscompile, never something to report-and-continue.  Truncated
    emptiness checks (e.g. under injected solver faults) cannot prove
    safety either way; they degrade the result via a
    ``"validate-unresolved"`` diagnostic instead of raising."""
    s = getattr(point, "schedule", None)
    if s is None or not getattr(s, "feasible", True):
        return
    from . import analysis
    v = analysis.validate_static(s.program, s)
    if v.violations:
        raise StaticValidationError(s.program.name, v)
    if v.unresolved:
        diagnostics.append({
            "kind": "validate-unresolved", "program": s.program.name,
            "count": v.unresolved,
            "detail": f"{v.unresolved} of {v.cases} dependence cases "
                      "truncated; schedule safety not independently proven"})


def _resolve_spec(spec: Optional[CompileSpec], overrides: dict) -> CompileSpec:
    spec = spec or CompileSpec()
    if not isinstance(spec, CompileSpec):
        raise TypeError(f"spec must be a CompileSpec, got {type(spec).__name__}")
    clean = {k: v for k, v in overrides.items() if v is not None}
    if "objectives" in clean and not isinstance(clean["objectives"],
                                                (tuple, list)):
        clean["objectives"] = (clean["objectives"],)
    if "constraints" in clean and isinstance(clean["constraints"],
                                             (str, Constraint)):
        clean["constraints"] = (clean["constraints"],)
    return dc_replace(spec, **clean) if clean else spec


def compile(program: Program, spec: Optional[CompileSpec] = None, *,
            target: Optional[Target] = None,
            objectives=None, constraints=None,
            pipeline: Union[str, Sequence[Pass], None] = None,
            combine: Optional[str] = None,
            search: Optional[SearchConfig] = None,
            verbose: bool = False) -> CompileResult:
    """Compile ``program`` per a declarative ``CompileSpec``.

    Keyword arguments override the corresponding spec fields, so quick
    calls need no spec object: ``hls.compile(p, pipeline="fuse,partition")``
    or ``hls.compile(p, constraints=("dsp <= 48",))``.

    * With ``pipeline`` (textual string or ``Pass`` list): parse, verify,
      apply, compile — exactly that design; the frontier is that single
      point (plus the baseline when distinct).
    * Without: run the Pareto-frontier DSE and return the full frontier.

    The empty pipeline ``()`` compiles the program as-is — the
    ``compile_program`` migration path.
    """
    spec = _resolve_spec(spec, dict(target=target, objectives=objectives,
                                    constraints=constraints,
                                    pipeline=pipeline, combine=combine,
                                    search=search))
    sc = spec.search
    caps: dict[str, float] = {}
    rel: dict[str, float] = {}
    for k, v in spec.target.capacities:
        caps[k] = min(caps.get(k, v), v)
    for c in spec.constraints:
        if c.limit is not None:
            caps[c.resource] = min(caps.get(c.resource, c.limit), c.limit)
        else:
            rel[c.resource] = min(rel.get(c.resource, c.scale), c.scale)

    if spec.pipeline is not None:
        passes = parse_pipeline(spec.pipeline) \
            if isinstance(spec.pipeline, str) else list(spec.pipeline)
        for ps in passes:
            if not isinstance(ps, Pass):
                raise TypeError(f"pipeline element is not a Pass: {ps!r}")
        from .cache import get_store
        store = get_store() if sc.cache else None
        repairs0 = store.repairs if store is not None else 0
        ev0 = faults.event_count()
        baseline = measure_candidate(program, "baseline", [],
                                     verify=sc.verify, seeds=sc.seeds,
                                     mode=spec.target.mode, store=store)
        baseline.status = "baseline"
        for k, scale in rel.items():
            ceil = scale * baseline.res[k]
            caps[k] = min(caps.get(k, ceil), ceil)
        if passes:
            point = measure_candidate(program, print_pipeline(passes), passes,
                                      verify=sc.verify, seeds=sc.seeds,
                                      mode=spec.target.mode,
                                      incremental=False, store=store)
            if point is None:   # the WHOLE pipeline applied nothing
                point = baseline
        else:
            point = baseline
        candidates = [baseline] + ([point] if point is not baseline else [])
        rejected: list[tuple[str, str]] = []
        viol = point.res.violations(caps)
        if viol:
            point.within_budget = False
            point.status = "over budget: " + "; ".join(viol)
            rejected.append((point.desc, point.status))
            frontier = []
        else:
            point.within_budget = True
            if point.status != "baseline":
                point.status = "frontier"
            frontier = [point]
        if sc.validate and not viol:
            validate_candidate(point, sc.seeds)
        diagnostics = [dict(d) for d in faults.events_since(ev0)
                       if d.get("kind") != "cache-repair"]
        repaired = (store.repairs - repairs0) if store is not None else 0
        if repaired:
            diagnostics.append({"kind": "cache-repair", "count": repaired})
        diagnostics = dedupe_diagnostics(diagnostics)
        if sc.lint:
            diagnostics[:0] = _lint_diagnostics(program)
        if sc.static_check or \
                getattr(point, "provenance", "exact") != "exact":
            _static_check(point, diagnostics)
        degraded = any(getattr(c, "provenance", "exact") != "exact"
                       for c in candidates) or _degrading(diagnostics)
        return CompileResult(program=program, spec=spec, baseline=baseline,
                             best=point, frontier=frontier,
                             candidates=candidates, rejected=rejected,
                             caps=caps, compiles=len(candidates),
                             diagnostics=diagnostics,
                             provenance="degraded" if degraded else "exact")

    r: ParetoResult = pareto_explore(
        program, caps=caps, rel_caps=rel, moves=sc.moves,
        unroll_factors=sc.unroll_factors, tile_sizes=sc.tile_sizes,
        max_candidates=sc.max_candidates, verify=sc.verify, seeds=sc.seeds,
        mode=spec.target.mode, selector=sc.selector,
        macro_moves=sc.macro_moves, jobs=sc.jobs,
        worker_deadline_s=sc.worker_deadline_s,
        store="auto" if sc.cache else None, verbose=verbose)
    best = _select_best(r.frontier, r.baseline, spec)
    if sc.validate:
        validate_candidate(best, sc.seeds)
    diagnostics = list(r.diagnostics)
    if sc.lint:
        diagnostics[:0] = _lint_diagnostics(program)
    if sc.static_check or \
            getattr(best, "provenance", "exact") != "exact" \
            or r.provenance != "exact":
        _static_check(best, diagnostics)
    degraded = r.provenance != "exact" or _degrading(diagnostics)
    return CompileResult(program=program, spec=spec, baseline=r.baseline,
                         best=best, frontier=r.frontier,
                         candidates=r.candidates, rejected=r.rejected,
                         caps=r.caps, compiles=r.compiles,
                         diagnostics=diagnostics,
                         provenance="degraded" if degraded else "exact")
