# The paper's primary contribution: an ILP-based HLS scheduler performing
# multi-dimensional (intra-loop + producer-consumer) pipelining, with the
# chosen design point lowered to a hand-written CUDA kernel for Hopper.
#
# The compilation entry point is the declarative front end
# ``repro_torch.core.hls`` (api.py): ``hls.compile(program, spec)``, then
# ``CompileResult.emit_cuda()`` to lower a frontier point.
from .ir import (AffExpr, ArrayDecl, ArithOp, ConstOp, LoadOp, Loop, Program,
                 ProgramBuilder, StoreOp, aff, iv, normalize)
from .ilp import solve_ilp, solve_lp, brute_force_ilp
from . import faults
from .errors import (CacheFault, CompileError, Diagnostic,
                     NestContractViolation, ScheduleInfeasible,
                     SolverTruncated, StaticValidationError,
                     UnlowerableProgram, UntraceableFunction, WorkerFault)
from .analysis import Verdict, lint, validate_static
from .codegen import CudaKernel, emit_cuda, lower_program
from .frontend import TracedProgram, scan, trace
from .deps import DepAnalysis, DepEdge
from .scheduler import Schedule, schedule, feasible, emit_hir
from .transforms import (ArrayPartition, FuseProducerConsumer, LoopTile,
                         LoopUnroll, Normalize, Pass, PassManager,
                         PassVerificationError, PASS_TAGS, ToSPSC, TRANSFORMS,
                         differential_check, to_spsc)
from .pipeline_parse import (PipelineSyntaxError, parse_pipeline,
                             print_pipeline)
from .dataflow import ResourceVector
from .cache import (SCHEDULER_SALT, CacheStore, cache_enabled, fingerprint,
                    get_store, pack_schedule, program_text, unpack_schedule)
from .autotune import (DSECandidate, MOVE_FAMILIES, PARETO_METRICS,
                       ParetoResult, autotune, compile_program, dominates,
                       pareto_explore)
from . import api as hls
from .api import (CompileResult, CompileSpec, Constraint, DesignPoint,
                  Objective, SearchConfig, Target, constraint, minimize)

__all__ = [
    "AffExpr", "ArrayDecl", "ArithOp", "ConstOp", "LoadOp", "Loop", "Program",
    "ProgramBuilder", "StoreOp", "aff", "iv", "normalize",
    "solve_ilp", "solve_lp", "brute_force_ilp",
    "DepAnalysis", "DepEdge", "Schedule", "schedule", "feasible", "emit_hir",
    "Pass", "PassManager", "PassVerificationError", "TRANSFORMS", "PASS_TAGS",
    "Normalize", "LoopUnroll", "LoopTile", "ArrayPartition",
    "FuseProducerConsumer", "ToSPSC", "to_spsc", "differential_check",
    "parse_pipeline", "print_pipeline", "PipelineSyntaxError",
    "ResourceVector", "SCHEDULER_SALT", "CacheStore", "cache_enabled",
    "fingerprint", "get_store", "pack_schedule", "program_text",
    "unpack_schedule",
    "autotune", "compile_program", "DSECandidate",
    "pareto_explore", "ParetoResult", "dominates", "PARETO_METRICS",
    "MOVE_FAMILIES",
    "hls", "CompileSpec", "CompileResult", "Target", "Objective",
    "Constraint", "constraint", "minimize", "SearchConfig", "DesignPoint",
    "faults", "CompileError", "ScheduleInfeasible", "SolverTruncated",
    "WorkerFault", "CacheFault", "UnlowerableProgram", "UntraceableFunction",
    "NestContractViolation", "Diagnostic", "StaticValidationError",
    "Verdict", "lint", "validate_static",
    "CudaKernel", "emit_cuda", "lower_program",
    "trace", "TracedProgram", "scan",
]
