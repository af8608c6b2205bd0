"""Overlap-scheduled collective matmul, ring all-gather x matmul (the port
of ``repro.parallel.collective_matmul``).

y = all_gather(x, axis) @ W  is decomposed into P steps: at step k each
rank multiplies the shard it currently holds while passing it on to the
next rank of the ring (``batch_isend_irecv``), so compute hides
communication.  The step interleave (send then matmul per tick, II=1) is
the one ``core/overlap.py``'s ILP proves feasible, with the link and the
matrix unit as two single-port resources.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def ring_shift(x: torch.Tensor, group, shift: int = 1):
    """Start passing ``x`` to the rank ``shift`` places on in ``group``'s
    ring and receiving the tensor of the rank ``shift`` places back.
    Returns (the receive buffer, the requests to wait on).  Over a group of
    one the ring is the identity, as ``ppermute`` over one device is: no
    message is sent (a rank does not send to itself) and ``x`` comes back."""
    n = dist.get_world_size(group)
    if n == 1:
        return x, []
    me = dist.get_group_rank(group, dist.get_rank())
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, buf,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    return buf, dist.batch_isend_irecv(ops)


def ag_matmul(x_local: torch.Tensor, w: torch.Tensor, mesh, axis: str):
    """x_local: this rank's (m, k) shard of a (P*m, k) matrix row-sharded
    over ``mesh``'s ``axis`` (the rank at index i holds rows i*m...);
    w: (k, n), the same on every rank.  Returns the whole (P*m, n) product
    on every rank (the reference's ``out_specs=P()``) without gathering x:
    at step k the shard held came from rank (i - k) mod P, and its rows are
    written there.  The shard is passed on while it is multiplied; the last
    step passes nothing (no rank needs it again)."""
    group = mesh.get_group(axis)
    P = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    m = x_local.shape[0]
    out = x_local.new_empty((P * m, w.shape[1]),
                            dtype=torch.result_type(x_local, w))
    shard = x_local
    for k in range(P):
        nxt, reqs = ring_shift(shard, group) if k < P - 1 else (None, [])
        src = (idx - k) % P             # whose shard we hold at step k
        torch.matmul(shard, w, out=out[src * m:(src + 1) * m])
        for r in reqs:
            r.wait()
        shard = nxt
    return out
