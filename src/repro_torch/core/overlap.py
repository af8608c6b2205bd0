"""ILP-scheduled compute/communication overlap (DESIGN.md §3).

The ring all-gather matmul in parallel/collective_matmul.py interleaves one
ICI hop with one MXU matmul per step.  Here the interleave is *derived* with
the paper's scheduler: the ICI link and the MXU are single-port memories,
each ring step is one loop iteration whose body sends chunk k (ICI port) and
multiplies chunk k-1 (MXU port, RAW-dependent on the previous receive).  The
scheduler proves II = 1 (send and matmul overlap) — while a naive dependence
chain (gather fully, then multiply) costs II = 2.
"""
from __future__ import annotations

from dataclasses import dataclass

from .autotune import compile_program
from .ir import ProgramBuilder


@dataclass
class OverlapPlan:
    n_steps: int
    ii: int                  # ticks per ring step (1 = fully overlapped)
    latency: int
    serial_latency: int      # gather-then-compute baseline

    @property
    def overlap_speedup(self) -> float:
        return self.serial_latency / self.latency


def plan_ring_overlap(n_steps: int, *, send_ticks: int = 1,
                      mm_ticks: int = 1) -> OverlapPlan:
    b = ProgramBuilder("ring_overlap",
                       op_delays={"mul": 1, "add": 1, "const": 0})
    # single-port resources: the ICI link and the MXU.  Multi-tick sends /
    # matmuls occupy their port for every tick (unit-op chains, same trick
    # as pipeline_ilp).  The CHUNK handoff has wr_latency 0: the transfer
    # time itself is the send chain.
    b.array("CHUNK", (n_steps + 1,), kind="reg", rd_latency=0, wr_latency=0)
    b.array("OUT", (n_steps,), kind="reg", rd_latency=0, wr_latency=1)
    b.array("ICI", (1,), ports=("rw",))
    b.array("MXU", (1,), ports=("rw",))
    with b.loop("k", 0, n_steps) as k:
        c = b.load("CHUNK", k)
        sent = c
        for _ in range(send_ticks):         # ppermute hop (ICI port)
            sent = b.add(sent, b.const(0.0))
            b.store("ICI", sent, 0)
        b.store("CHUNK", sent, k + 1)
        y = c
        for _ in range(mm_ticks):           # matmul on the held chunk (MXU)
            y = b.mul(y, b.const(1.0))
            b.store("MXU", y, 0)
        b.store("OUT", y, k)
    p = b.build()
    s = compile_program(p)
    loop = p.loops()[0]
    ii = s.iis[loop.uid]
    # serial baseline: every send completes before any matmul starts
    serial = n_steps * send_ticks + n_steps * mm_ticks
    return OverlapPlan(n_steps=n_steps, ii=ii, latency=s.completion_time(),
                       serial_latency=serial)
