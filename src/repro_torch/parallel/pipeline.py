"""Statically scheduled pipeline-parallel executor over a ring of ranks (the
port of ``repro.parallel.pipeline``).

Realizes the schedule ``core/pipeline_ilp.py`` synthesizes: the forward
walks microbatches through the stage ring at the schedule's II, one ring
shift a tick, with no other synchronization.  Point-to-point messages have
no gradient in ``torch.distributed``, so the shift is an autograd Function
(``_RingShift``) whose backward is the reverse shift, the transpose JAX
gets from ``ppermute``: the backward schedule is the ILP's reversed chain.

Every rank runs the same ticks and the same shifts, forward and backward.
A rank's backward runs a shift only where it lies between the rank's loss
and the inputs asked for, so each shift's output feeds the next tick on
every rank, even where the schedule does not use it, the first carry is
tied to every input (``_After``), and the last tick's carry to the output:
no rank leaves a shift out of its backward, which would leave its
neighbours waiting.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.collective_matmul import ring_shift


def _shift(x, group, shift: int):
    """``x`` passed ``shift`` places on around the ring: a new tensor (over
    a group of one, a copy of ``x``)."""
    buf, reqs = ring_shift(x, group, shift)
    for r in reqs:
        r.wait()
    return buf.clone() if buf is x else buf


class _RingShift(torch.autograd.Function):
    """Forward: send to s + 1, receive from s - 1.  Backward: send the
    gradient to s - 1, receive s + 1's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _After(torch.autograd.Function):
    """``y`` as it is, tied to ``deps`` in the backward (they get zero
    gradients): keeps an unused ring message in the backward chain, and
    ties the chain's start to the pipeline's inputs, so a backward asked
    for any input's gradient runs every shift."""

    @staticmethod
    def forward(ctx, y, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.deps))


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank (the reference's ``psum`` of
    them masked to the last stage).  Every rank then computes the same
    loss from the same outputs, so the backward takes the last stage's own
    gradient once: an all-reduce there, as ``psum``'s transpose, would
    count it once a rank.  ``anchor`` (the last carry) gets a zero
    gradient; it keeps the last shift in the backward."""

    @staticmethod
    def forward(ctx, outs, anchor, group, last: bool):
        ctx.last = last
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        total = outs.clone() if last else torch.zeros_like(outs)
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        return (g if ctx.last else torch.zeros_like(g),
                torch.zeros(shape, dtype=dtype, device=device), None, None)


def _stage(tree, s: int):
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    return tree[s]


def pipelined_forward(stage_fn, stage_params, microbatches, mesh,
                      axis: str = "stage"):
    """stage_params: a dict (of dicts) of tensors stacked on axis 0
    (n_stages = ``mesh``'s ``axis`` size, S); rank s reads row s alone, so
    its gradient lands in row s (sum the ranks' gradients for the whole
    one, the reference's sharded gradient).  microbatches: (M, mb, ...), the
    same on every rank.  Returns (M, mb, ...) of final-stage outputs on
    every rank.

    Schedule: tick t in [0, M+S-1); rank s runs microbatch m = t - s (the
    ILP's fwd_start[s] = s * t_f affine schedule with II = t_f); stage 0
    ingests microbatch t, the others take the carry from s - 1; an
    inactive tick passes its carry through; the last stage banks its
    outputs; every rank shifts its result on around the ring."""
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    s = mesh.get_local_rank(axis)
    M = microbatches.shape[0]
    p_local = _stage(stage_params, s)
    # the inter-stage register, tied to every input: on a rank whose first
    # ticks are idle the shifts' chain then still leads to the inputs
    carry = _After.apply(torch.zeros_like(microbatches[0]), microbatches,
                         *_leaves(stage_params))
    outs = [None] * M
    for t in range(M + S - 1):
        m = t - s                                   # ILP: fwd_tick(s, m)
        if 0 <= m < M:
            if s == 0:      # stage 0 ingests; the carry it got is unused
                y = _After.apply(stage_fn(p_local, microbatches[t]), carry)
            else:
                y = stage_fn(p_local, carry)
            if s == S - 1:
                outs[m] = y
        else:
            y = carry
        carry = _RingShift.apply(y, group)
    banked = torch.stack(outs) if s == S - 1 else \
        torch.zeros_like(microbatches)
    return _FromLast.apply(banked, carry, group, s == S - 1)


def pipelined_loss(stage_fn, stage_params, microbatches, targets, mesh,
                   axis: str = "stage"):
    """MSE over the pipelined forward: its backward runs the ILP schedule
    forward and its transpose backward."""
    outs = pipelined_forward(stage_fn, stage_params, microbatches, mesh, axis)
    return torch.mean(torch.square(outs - targets))


def reference_forward(stage_fn, stage_params, microbatches):
    """Unpipelined oracle: apply stages sequentially to every
    microbatch."""
    S = next(iter(_leaves(stage_params))).shape[0]

    def apply_all(x):
        for s in range(S):
            x = stage_fn(_stage(stage_params, s), x)
        return x

    return torch.stack([apply_all(x) for x in microbatches])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
