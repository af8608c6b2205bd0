"""Continuous-batching serving scheduler.

A production serving loop cannot wait for a whole batch of requests to
finish before admitting new ones: it runs a fixed number of *slots*, each
holding one in-flight sequence, and every decode step advances all active
slots at once.  Finished sequences free their slot, which the admission
queue refills on the next step -- the KV/state cache rows are reused
in place: admission resets the slot's rows to a fresh cache's and its
position counter to 0.

The decode step is a statically scheduled circuit; admission is the only
dynamic decision, and it happens on the host between steps.  Each step
sends the slots' tokens and positions to the model's device and brings the
argmax of the logits back to the host: one round trip per step.

The logic is the JAX package's (``repro.runtime.serving``) but for the
reset of a reused slot's cache rows (every layer's: attention k and v,
MLA's compressed latents, Mamba's state and conv tail, RWKV's states).  The
JAX batcher leaves them as the previous request left them: harmless for
attention and MLA, whose masks hide rows past ``pos``, but a recurrent
layer's state (Mamba's, RWKV's WKV state and token shifts) would carry the
previous request into the next.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


def _reset_row(cache, fresh, i: int) -> None:
    """Copy the one-slot cache ``fresh`` into slot ``i`` of ``cache``."""
    if isinstance(cache, torch.Tensor):
        cache[i].copy_(fresh[0])
    elif isinstance(cache, dict):
        for k in cache:
            _reset_row(cache[k], fresh[k], i)
    else:
        for c, f in zip(cache, fresh):
            _reset_row(c, f, i)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new: int
    # filled by the batcher:
    output: list = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                 # next write position in this slot's cache
    remaining: int = 0
    pending_prompt: Optional[np.ndarray] = None
    prompt_cursor: int = 0


class ContinuousBatcher:
    """Slot-based continuous batching over a one-token decode step.

    decode_fn(cache, tokens (B,1), pos (B,)) -> (logits (B,1,V), cache),
    with tokens and pos int32 tensors on ``device`` (the model's);
    init_cache(n) -> a cache of n slots: nested dicts and lists of tensors,
    each with the slot on axis 0.
    Prompts are streamed through the same decode path one token per step
    (prefill-as-decode); production systems swap in the batched prefill
    kernel, the slot logic is identical."""

    def __init__(self, decode_fn: Callable, init_cache: Callable,
                 n_slots: int, eos: int = 1, max_len: int = 1 << 30,
                 device="cuda"):
        self.decode_fn = decode_fn
        self.cache = init_cache(n_slots)
        self._fresh = init_cache(1)  # what admission resets a slot's rows to
        self.n_slots = n_slots
        self.eos = eos
        self.max_len = max_len
        self.device = torch.device(device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.steps = 0
        self.occupancy: list[int] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s.req is None and self.queue:
                req = self.queue.pop(0)
                with torch.inference_mode():
                    _reset_row(self.cache, self._fresh, i)
                s.req = req
                s.pos = 0
                s.remaining = req.max_new
                s.pending_prompt = req.prompt.astype(np.int32)
                s.prompt_cursor = 0

    def _active(self):
        return [i for i, s in enumerate(self.slots) if s.req is not None]

    def step(self):
        """One decode step across all slots; returns #active slots."""
        self._admit()
        act = self._active()
        self.occupancy.append(len(act))
        if not act:
            return 0
        tokens = np.zeros((self.n_slots, 1), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            if s.prompt_cursor < len(s.pending_prompt):
                tokens[i, 0] = s.pending_prompt[s.prompt_cursor]
            else:
                tokens[i, 0] = s.req.output[-1] if s.req.output else self.eos
            pos[i] = s.pos
        logits, self.cache = self.decode_fn(
            self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device))
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu().numpy()
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            s.pos += 1
            if s.prompt_cursor < len(s.pending_prompt):
                s.prompt_cursor += 1
                if s.prompt_cursor < len(s.pending_prompt):
                    continue  # still prefilling
                # prompt done: the logits just produced the first new token
            s.req.output.append(int(nxt[i]))
            s.remaining -= 1
            if (s.remaining <= 0 or nxt[i] == self.eos
                    or s.pos >= self.max_len - 1):
                s.req.done = True
                self.completed.append(s.req)
                s.req = None  # slot freed; its rows reset on admission
        self.steps += 1
        return len(act)

    def run(self, max_steps: int = 100000):
        while (self.queue or self._active()) and self.steps < max_steps:
            self.step()
        return self.completed
