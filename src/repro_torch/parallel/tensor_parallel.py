"""Tensor-parallel compute over a mesh's "model" axis: what GSPMD makes of
the reference's "tp" rules (``parallel.sharding``: heads, FFN columns and
the vocabulary split over "model") and of its ``constrain`` points, written
as explicit collectives.

A sharded step installs the axis (``over(mesh)``) and runs the plain layers
on the rank's model shards.  A layer asks ``split(n_local, n_global)``
whether a dim it reads is split (the weights' shapes say so) and, where it
is, marks the edges of its split region:

* ``enter``: a replicated activation enters the region: the identity
  forward, a sum over "model" backward (each rank's share of its
  gradient);
* ``reduce``: a row-split product leaves it: a sum over "model" forward,
  the identity backward;
* ``reduce_scatter``: a row-split product whose columns the region splits
  next (RWKV-6's ``wk`` and ``wv``): the sum over "model" of the rank's
  column block forward, the ranks' blocks all-gathered backward.

The vocabulary is split too: ``embed`` looks up the rank's rows of the
table (ids outside them give zeros) and sums over "model";
``log_prob`` takes ``log_softmax`` at the labels from the rank's columns of
the logits (the row max, the sum of exponentials and the label's logit
all-reduced), so the full logits are never gathered; ``gather`` gathers
them where a caller wants them whole.

The collectives are ``torch.distributed._functional_collectives``', so a
traced step (``make_fx``, the dry-run) holds them as ``_c10d_functional``
nodes.  Over an axis of one rank ``over`` installs nothing: the layers run
the one-device ops, in the same order.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.launch.mesh import mesh_shape


class Axis(NamedTuple):
    """The "model" axis as a rank sees it: its process group, its size and
    the rank's index along it."""
    group: object
    size: int
    rank: int


_AXES: list = []


@contextlib.contextmanager
def over(mesh, axis: str = "model"):
    """Layers inside split the dims their weights hold split over
    ``mesh``'s ``axis`` (nothing is installed where the axis has one rank
    or the mesh none)."""
    size = mesh_shape(mesh).get(axis, 1)
    _AXES.append(Axis(mesh.get_group(axis), size,
                      mesh.get_local_rank(axis)) if size > 1 else None)
    try:
        yield _AXES[-1]
    finally:
        _AXES.pop()


def split(n_local: int, n_global: int) -> Axis | None:
    """The installed axis where a dim of ``n_global`` entries is held as
    its ``n_local = n_global / size`` share; None where it is whole or no
    axis is installed."""
    ax = _AXES[-1] if _AXES else None
    if ax is None or n_local == n_global:
        return None
    if n_local * ax.size != n_global:
        raise ValueError(f"{n_local} of {n_global} entries: not a share of "
                         f"the model axis {ax}")
    return ax


def _all_reduce(x, op: str, ax: Axis):
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op,
                                                ax.group))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, "sum", ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_cols(x, ax: Axis):
    rows = funcol.wait_tensor(
        torch.ops._c10d_functional.all_gather_into_tensor(
            x.contiguous(), ax.size, ax.group.group_name))
    return torch.cat(rows.chunk(ax.size), dim=-1)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        n = x.shape[-1] // ax.size
        blocks = x.unflatten(-1, (ax.size, n)).movedim(-2, 0)
        out = funcol.wait_tensor(
            torch.ops._c10d_functional.reduce_scatter_tensor(
                blocks.contiguous(), "sum", ax.size, ax.group.group_name))
        return out[0]

    @staticmethod
    def backward(ctx, g):
        return _gather_cols(g, ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        return _gather_cols(x, ax)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.ax.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


def enter(x, ax: Axis):
    """``x`` (the same on every rank of ``ax``) entering a split region:
    the identity forward, its gradient summed over ``ax`` backward."""
    return _Enter.apply(x, ax)


def reduce(x, ax: Axis):
    """The sum over ``ax`` of each rank's partial ``x``; its gradient
    passes as it is."""
    return _Reduce.apply(x, ax)


def reduce_scatter(x, ax: Axis):
    """The rank's column block (the last dim cut in ``ax.size``) of the
    sum over ``ax`` of each rank's partial ``x``; backward, the ranks'
    blocks of the gradient side by side."""
    return _ReduceScatter.apply(x, ax)


def gather(x, ax: Axis):
    """The ranks' column blocks of ``x`` (the last dim) side by side; its
    gradient is cut back to the rank's block, so what follows must be the
    same on every rank of ``ax``."""
    return _Gather.apply(x, ax)


def embed(table, ids, ax: Axis):
    """``full_table[ids]`` from the rank's rows of the table: ids outside
    them give zeros, and the sum over ``ax`` holds each row once."""
    n = table.shape[0]
    local = ids - ax.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)),
                  ax)


def log_prob(logits, labels, ax: Axis):
    """``log_softmax(full_logits)`` at ``labels`` from the rank's column
    block of the logits: the row max (no gradient: the value does not
    depend on it), the sum of exponentials and the label's logit are
    all-reduced over ``ax``."""
    n = logits.shape[-1]
    top = _all_reduce(logits.detach().amax(dim=-1), "max", ax)
    z = logits - top[..., None]
    total = reduce(torch.exp(z).sum(dim=-1), ax)
    local = labels - ax.rank * n
    mine = (local >= 0) & (local < n)
    at = torch.gather(z, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    at = reduce(torch.where(mine, at, torch.zeros_like(at)), ax)
    return at - torch.log(total)
