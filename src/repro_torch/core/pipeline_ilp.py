"""Pipeline-parallel schedule synthesis via the paper's ILP scheduler.

The mapping (DESIGN.md §3): a pipeline-parallel training step IS a dataflow
program —

    FPGA loop nest            <->  per-stage microbatch loop
    intermediate array        <->  ACT[stage][microbatch] / GRAD[...]
    memory port conflict      <->  a device executes one stage-op per tick
    intra-loop II             <->  steady-state ticks per microbatch
    producer-consumer overlap <->  fwd/bwd interleaving + cross-stage overlap

Each stage contributes ONE loop over microbatches whose body holds both the
forward and (optionally) backward op for that (stage, microbatch); a
single-port per-device "DEV_s" array serializes same-device ops exactly like
a BRAM port.  The ILP then *derives* a 1F1B-class schedule (affine in m)
instead of hard-coding one, and handles non-SPSC stage graphs — e.g. an
encoder output consumed by every decoder stage's cross-attention — which is
precisely the pattern Vitis-style FIFO dataflow cannot express (§2).

The executor in repro/parallel/pipeline.py realizes the derived schedule with
shard_map + lax.ppermute.
"""
from __future__ import annotations

from dataclasses import dataclass

from .autotune import compile_program
from .ir import ProgramBuilder


@dataclass
class PipelineSchedule:
    n_stages: int
    n_microbatches: int
    fwd_start: list[int]        # theta of fwd op per stage (ticks)
    bwd_start: list[int]        # theta of bwd op per stage (empty if fwd-only)
    ii: int                     # steady-state ticks per microbatch
    latency: int                # makespan in ticks
    peak_live_activations: int  # max simultaneously-live ACT[s][m]

    def fwd_tick(self, s: int, m: int) -> int:
        return self.fwd_start[s] + m * self.ii

    def bwd_tick(self, s: int, m: int) -> int:
        return self.bwd_start[s] + m * self.ii


def _peak_live(intervals) -> int:
    """Max overlap of live [born, dies] activation intervals (dies inclusive),
    by event-sweep: +1 at birth, -1 just after death."""
    events = []
    for born, dies in intervals:
        events.append((born, 1))
        events.append((dies + 1, -1))
    live = peak = 0
    for _, d in sorted(events):
        live += d
        peak = max(peak, live)
    return peak


def _build_program(S: int, M: int, t_f: int, t_b: int, backward: bool,
                   cross_from=None):
    """One loop over microbatches; the body is the topologically-ordered
    dataflow of one microbatch (full forward chain, then full backward
    chain), so the sequential semantics the scheduler must preserve are the
    true dependences.  ``cross_from``: stage index whose output every later
    stage also consumes (encoder output -> decoder cross-attention): a
    multi-consumer channel that FIFO dataflow cannot express."""
    b = ProgramBuilder("pp", op_delays={"add": 0, "mul": 1, "div": 1,
                                        "sub": 1, "const": 0})
    for s in range(S + 1):
        b.array(f"ACT{s}", (M,), kind="reg", rd_latency=0, wr_latency=1)
        if backward:
            b.array(f"GRAD{s}", (M,), kind="reg", rd_latency=0, wr_latency=1)
    for s in range(S):
        # one single-port scratchpad per device: the execution-slot resource
        b.array(f"DEV{s}", (1,), ports=("rw",), rd_latency=1, wr_latency=1)

    def occupy(s, val, ticks, fn):
        """fn-tagged chain of `ticks` unit ops, each claiming DEV_s for one
        tick (a t-tick stage op keeps its device busy t ticks)."""
        for _ in range(ticks):
            val = b.arith(fn, val, b.const(1.0))
            b.store(f"DEV{s}", val, 0)
        return val

    with b.loop("m", 0, M) as m:
        for s in range(S):
            x = b.load(f"ACT{s}", m)
            if cross_from is not None and s > cross_from:
                e = b.load(f"ACT{cross_from + 1}", m)
                x = b.add(x, e)
            y = occupy(s, x, t_f, "mul")        # fwd compute, t_f ticks
            b.store(f"ACT{s + 1}", y, m)
        if backward:
            # loss gradient ties bwd to fwd (dependency only — folded into
            # the last stage's bwd op, so it claims no device tick)
            g = b.arith("sub", b.load(f"ACT{S}", m), b.const(0.0))
            b.store(f"GRAD{S}", g, m)
            for s in range(S - 1, -1, -1):
                g = b.load(f"GRAD{s + 1}", m)
                a = b.load(f"ACT{s}", m)        # stashed activation
                gg = occupy(s, b.add(g, a), t_b, "div")  # bwd, t_b ticks
                b.store(f"GRAD{s}", gg, m)
    return b.build()


def synthesize(S: int, M: int, *, t_f: int = 1, t_b: int = 2,
               backward: bool = True, cross_from=None) -> PipelineSchedule:
    p = _build_program(S, M, t_f, t_b, backward, cross_from)
    sched = compile_program(p)
    loops = p.loops()
    ii = max(sched.iis[l.uid] for l in loops)

    # locate fwd (mul) and bwd (div) ops per stage, in emission order
    from .ir import ArithOp, Loop

    fwd_start, bwd_start = [], []
    body = [n for n in p.body if isinstance(n, Loop)][0].body
    muls = [sched.theta[op.uid] for op in body
            if isinstance(op, ArithOp) and op.fn == "mul"]
    divs = [sched.theta[op.uid] for op in body
            if isinstance(op, ArithOp) and op.fn == "div"]
    fwd_start = [muls[i * t_f] for i in range(S)]  # first unit of each chain
    if backward:
        bwd_start = [divs[i * t_b] for i in range(S)]
        bwd_start.reverse()  # emitted S-1..0, report as 0..S-1

    # peak live ACT values (activation-memory pressure, the 1F1B metric):
    # ACT[s][m] is born at stage s's fwd and dies at its own bwd (stashed
    # activation), or at the next stage's fwd when there is no backward.
    intervals = []
    for s in range(S):
        for m in range(M):
            born = fwd_start[s] + m * ii
            if backward:
                dies = bwd_start[s] + m * ii
            else:
                dies = (fwd_start[s + 1] + m * ii) if s + 1 < S else born + 1
            intervals.append((born, dies))
    peak = _peak_live(intervals)

    return PipelineSchedule(
        n_stages=S, n_microbatches=M, fwd_start=fwd_start,
        bwd_start=bwd_start, ii=ii, latency=sched.completion_time(),
        peak_live_activations=peak)


def synthesize_interleaved(S: int, V: int, M: int, *, t_f: int = 1,
                           t_b: int = 2) -> PipelineSchedule:
    """Interleaved (virtual-stage) pipeline: each device hosts V model chunks
    (chunk c runs on device c % S, megatron-style).  The SAME device-port
    machinery schedules it — the only change is the DEV index mapping — and
    the ILP discovers the shorter fill/drain that interleaving buys."""
    b = ProgramBuilder("ppi", op_delays={"add": 0, "mul": 1, "div": 1,
                                         "sub": 1, "const": 0})
    C = S * V
    for c in range(C + 1):
        b.array(f"ACT{c}", (M,), kind="reg", rd_latency=0, wr_latency=1)
        b.array(f"GRAD{c}", (M,), kind="reg", rd_latency=0, wr_latency=1)
    for s in range(S):
        b.array(f"DEV{s}", (1,), ports=("rw",), rd_latency=1, wr_latency=1)

    def occupy(dev, val, ticks, fn):
        for _ in range(ticks):
            val = b.arith(fn, val, b.const(1.0))
            b.store(f"DEV{dev}", val, 0)
        return val

    with b.loop("m", 0, M) as m:
        for c in range(C):
            x = b.load(f"ACT{c}", m)
            y = occupy(c % S, x, t_f, "mul")
            b.store(f"ACT{c + 1}", y, m)
        g = b.arith("sub", b.load(f"ACT{C}", m), b.const(0.0))
        b.store(f"GRAD{C}", g, m)
        for c in range(C - 1, -1, -1):
            g = b.load(f"GRAD{c + 1}", m)
            a = b.load(f"ACT{c}", m)
            gg = occupy(c % S, b.add(g, a), t_b, "div")
            b.store(f"GRAD{c}", gg, m)
    p = b.build()
    sched = compile_program(p)
    loop = p.loops()[0]
    ii = sched.iis[loop.uid]

    from .ir import ArithOp

    muls = [sched.theta[op.uid] for op in loop.body
            if isinstance(op, ArithOp) and op.fn == "mul"]
    divs = [sched.theta[op.uid] for op in loop.body
            if isinstance(op, ArithOp) and op.fn == "div"]
    fwd_start = [muls[c * t_f] for c in range(C)]
    bwd_start = list(reversed([divs[i * t_b] for i in range(C)]))
    peak = _peak_live((fwd_start[c] + m_ * ii, bwd_start[c] + m_ * ii)
                      for c in range(C) for m_ in range(M))
    return PipelineSchedule(
        n_stages=C, n_microbatches=M, fwd_start=fwd_start,
        bwd_start=bwd_start, ii=ii, latency=sched.completion_time(),
        peak_live_activations=peak)


def gpipe_latency(S: int, M: int, t_f: int = 1, t_b: int = 2) -> int:
    """All-forward-then-all-backward with stage pipelining (the runtime-
    synchronized baseline): fwd fill+steady + bwd fill+steady."""
    return (M + S - 1) * t_f + (M + S - 1) * t_b


def sequential_latency(S: int, M: int, t_f: int = 1, t_b: int = 2) -> int:
    return M * S * (t_f + t_b)
