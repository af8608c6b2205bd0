"""Fault tolerance: checkpoint/restart loop, step watchdog, failure
injection, and straggler notes (the port's copy of
``repro.runtime.fault_tolerance``; the state is any tree of tensors that
``repro_torch.checkpoint`` saves).

At 1000+ nodes the dominant failures are (a) hard node loss -> the job
restarts from the last checkpoint on a (possibly resized) slice, (b) hangs
(network flap, ICI link down) -> a watchdog kills the step so the scheduler
can restart, (c) stragglers -> with a *statically scheduled* step (this
framework's design, mirroring the paper) there is no head-of-line queue to
re-order; mitigation is slice-level: the watchdog flags hosts whose step
time exceeds p99 * slack so orchestration can migrate them.  The ILP
schedule's slack analysis (core/pipeline_ilp.py) quantifies how much tick
skew a pipeline absorbs before stalling: slack_ticks = II - t_f.

This module is exercised by tests/test_torch_train.py with injected
failures; on a real cluster the same loop runs unchanged per host.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint


class StepWatchdog:
    """Fires ``on_timeout`` if a step takes longer than ``timeout_s``."""

    def __init__(self, timeout_s: float, on_timeout: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self.step_times: list[float] = []
        self._t0 = None

    def start_step(self):
        self.cancel()
        self._t0 = time.monotonic()
        self._timer = threading.Timer(self.timeout_s, self.on_timeout)
        self._timer.daemon = True
        self._timer.start()

    def end_step(self):
        if self._t0 is not None:
            self.step_times.append(time.monotonic() - self._t0)
        self.cancel()

    def cancel(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def straggling(self, slack: float = 2.0) -> bool:
        """Is the most recent step anomalously slow vs the trailing median?"""
        if len(self.step_times) < 5:
            return False
        hist = sorted(self.step_times[-50:-1])
        med = hist[len(hist) // 2]
        return self.step_times[-1] > slack * med


@dataclass
class FaultTolerantLoop:
    """Generic checkpoint/restart training loop.

    ``step_fn(state, step) -> state`` may raise; the loop restores the last
    checkpoint and continues.  ``make_state()`` builds the initial state.
    Failure injection for tests: ``inject = {step: Exception}``."""

    ckpt_dir: str
    make_state: Callable[[], object]
    step_fn: Callable[[object, int], object]
    ckpt_every: int = 10
    max_restarts: int = 3
    inject: dict = field(default_factory=dict)

    def run(self, n_steps: int):
        ckpt = AsyncCheckpointer(self.ckpt_dir)
        restarts = 0
        state, step = self._restore_or_init()
        log = {"restarts": 0, "resumed_at": step, "completed": 0}
        while step < n_steps:
            try:
                if step in self.inject:
                    exc = self.inject.pop(step)
                    raise exc
                state = self.step_fn(state, step)
                step += 1
                log["completed"] += 1
                if step % self.ckpt_every == 0:
                    ckpt.save(step, state)
            except Exception:
                restarts += 1
                log["restarts"] = restarts
                if restarts > self.max_restarts:
                    ckpt.wait()
                    raise
                ckpt.wait()
                state, step = self._restore_or_init()
        ckpt.wait()
        ckpt.save(step, state)
        ckpt.wait()
        return state, log

    def _restore_or_init(self):
        last = latest_step(self.ckpt_dir)
        if last is None:
            return self.make_state(), 0
        template = self.make_state()
        return restore_checkpoint(self.ckpt_dir, last, template), last
