"""Tensor-parallel compute over a mesh's "model" axis: what GSPMD makes of
the reference's "tp" rules (``parallel.sharding``: heads, FFN columns,
Mamba's inner channels and the vocabulary split over "model") and of its
``constrain`` points, written as explicit collectives.

A sharded step installs the axis (``over(mesh)``) and runs the plain layers
on the rank's model shards.  A layer asks ``split(n_local, n_global)``
whether a dim it reads is split (the weights' shapes say so) and, where it
is, marks the edges of its split region:

* ``enter``: a replicated activation enters the region: the identity
  forward, a sum over "model" backward (each rank's share of its
  gradient);
* ``reduce``: a row-split product leaves it: a sum over "model" forward,
  the identity backward (``enter(reduce(...))`` where the sum is read in
  the region again: Mamba's ``w_bc`` and ``w_dt`` products);
* ``reduce_scatter``: a row-split product whose columns the region splits
  next (RWKV-6's ``wk`` and ``wv``): the sum over "model" of the rank's
  column block forward, the ranks' blocks all-gathered backward;
* ``exchange``: a product whose columns hold two halves each split over
  "model" (Mamba's ``[x | z]`` of ``w_in``): an all-to-all that turns the
  rank's column block into its block of each half, and back backward;
* ``gather``: column blocks side by side (the vocabulary's logits,
  PaliGemma's projected patches, a decode step's query heads and new
  states).

A decode step also installs the mesh axis that holds its cache's positions
(``sequence_over``; "model" when the batch splits over the data axes,
"data" for one row): each rank attends over its block of the positions and
the softmax's row max and sums are all-reduced over that axis
(``all_reduce``).  There, products on weights whole on "model" split their
contraction over the axis (``whole_product``), as XLA partitions the
reference's decode step.

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
    """A mesh axis as a rank sees it: its process group, its size, the
    rank's index along it and its name; ``rows`` where products on weights
    whole on the axis split their contraction over it (a decode step)."""
    group: object
    size: int
    rank: int
    name: str = "model"
    rows: bool = False


_AXES: list = []
_SEQUENCE: list = []


def axis(mesh, name: str, rows: bool = False) -> Axis | None:
    """``mesh``'s axis ``name`` as this rank sees it, or None where the
    mesh has no such axis or it has one rank."""
    size = mesh_shape(mesh).get(name, 1)
    if size == 1:
        return None
    return Axis(mesh.get_group(name), size, mesh.get_local_rank(name), name,
                rows)


@contextlib.contextmanager
def over(mesh, name: str = "model", rows: bool = False):
    """Layers inside split the dims their weights hold split over
    ``mesh``'s axis ``name`` (nothing is installed where the axis has one
    rank or the mesh none); with ``rows`` (a decode step) their products on
    weights whole on the axis split their contraction (``whole_product``)."""
    _AXES.append(axis(mesh, name, rows))
    try:
        yield _AXES[-1]
    finally:
        _AXES.pop()


@contextlib.contextmanager
def sequence_over(mesh, name: str | None):
    """A decode step's cache holds its positions split over ``mesh``'s
    axis ``name`` (None: whole): the attention layers inside attend over
    the rank's block and combine the blocks over that axis."""
    _SEQUENCE.append(axis(mesh, name) if name else None)
    try:
        yield _SEQUENCE[-1]
    finally:
        _SEQUENCE.pop()


def sequence() -> Axis | None:
    """The axis the installed decode step's cache positions are split
    over, or None."""
    return _SEQUENCE[-1] if _SEQUENCE else None


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


def all_reduce(x, op: str, ax: Axis):
    """``x`` reduced by ``op`` ("sum", "max") over ``ax``, with no
    gradient rule (a decode step's softmax statistics)."""
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op,
                                                ax.group))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, "sum", ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_cols(x, ax: Axis, dim: int = -1):
    rows = funcol.wait_tensor(
        torch.ops._c10d_functional.all_gather_into_tensor(
            x.contiguous(), ax.size, ax.group.group_name))
    return torch.cat(rows.chunk(ax.size), dim=dim)


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
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.n, ctx.dim = ax, x.shape[dim], dim
        return _gather_cols(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.rank * ctx.n, ctx.n), None, None


def _halves_plan(ax: Axis, n: int):
    """The all-to-all of ``exchange`` on a rank's block of 2n columns:
    pieces 2r and 2r + 1 of the 2m pieces of n columns (pieces j < m hold
    the first half, j >= m the second) go to ranks j % m, and the rank
    takes pieces r and m + r.  Returns (whether its two pieces go out
    swapped, so that they lie in their ranks' order, the sizes it sends
    each rank, the sizes it receives from each)."""
    m, r = ax.size, ax.rank
    dest = [(2 * r) % m, (2 * r + 1) % m]
    src = [r // 2, (m + r) // 2]
    return (dest[0] > dest[1], [n * dest.count(t) for t in range(m)],
            [n * src.count(t) for t in range(m)])


def _all_to_all(x, send: list, recv: list, ax: Axis):
    """Rows of ``x`` (its first dim) sent ``send[t]`` to rank t, received
    ``recv[t]`` from rank t, in rank order."""
    return funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), recv, send, ax.group))


def _pieces(x, swap: bool):
    """The two halves of ``x``'s last dim as rows (first dim), swapped
    where ``swap``."""
    rows = x.movedim(-1, 0)
    n = rows.shape[0] // 2
    return torch.cat([rows[n:], rows[:n]]) if swap else rows


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        swap, send, recv = _halves_plan(ax, x.shape[-1] // 2)
        ctx.ax, ctx.plan = ax, (swap, send, recv)
        return _all_to_all(_pieces(x, swap), send, recv, ax).movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        swap, send, recv = ctx.plan
        back = _all_to_all(g.movedim(-1, 0), recv, send, ctx.ax)
        return _pieces(back.movedim(0, -1), swap).movedim(0, -1), None


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


def gather(x, ax: Axis, dim: int = -1):
    """The ranks' blocks of ``x`` along ``dim`` (the last: its columns)
    side by side; its gradient is cut back to the rank's block, so what
    follows must be the same on every rank of ``ax``."""
    return _Gather.apply(x, ax, dim)


def exchange(x, ax: Axis):
    """``x``'s last dim holds the rank's column block of ``[a | b]``, both
    halves split over ``ax`` (Mamba's ``h @ w_in`` with ``w_in``'s columns
    over "model"): the rank's block of ``a`` and its block of ``b``, side
    by side, by one all-to-all over ``ax``; the gradient goes back by the
    inverse all-to-all."""
    return _Exchange.apply(x, ax)


def whole_product(h, w):
    """``h @ w`` for a weight ``w`` whole on the installed axis (its rows
    the contraction), ``h`` the same on every rank of it: where the axis
    splits such products (``rows``, a decode step), each rank multiplies
    its block of the contraction and the blocks are summed over the axis;
    elsewhere the product is whole on every rank."""
    ax = _AXES[-1] if _AXES else None
    if ax is None or not ax.rows:
        return h @ w
    n = w.shape[0] // ax.size
    if n * ax.size != w.shape[0]:
        raise ValueError(f"{w.shape[0]} rows over the axis {ax}")
    rows = slice(ax.rank * n, (ax.rank + 1) * n)
    return reduce(h[..., rows] @ w[rows], ax)


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
    top = all_reduce(logits.detach().amax(dim=-1), "max", ax)
    z = logits - top[..., None]
    total = reduce(torch.exp(z).sum(dim=-1), ax)
    local = labels - ax.rank * n
    mine = (local >= 0) & (local < n)
    at = torch.gather(z, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    at = reduce(torch.where(mine, at, torch.zeros_like(at)), ax)
    return at - torch.log(total)
