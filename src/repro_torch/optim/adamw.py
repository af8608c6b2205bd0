"""AdamW with global-norm clipping, as functions over a list of tensors
(the model's parameters in a fixed order, ``LM.param_list``), not a
``torch.optim`` subclass, so the rounding is the reference's
(``repro.optim.adamw``):

* moments in the parameter dtype by default (the large-model memory
  budget); ``moment_dtype="float32"`` for small-scale runs;
* the update computed in fp32 from fp32 copies of the parameter, gradient
  and moments, and cast back once;
* the bias corrections ``1 - b ** count`` on an fp32 count.

``count`` is a 0-d int32 tensor on the parameters' device and every
quantity stays there (the learning rate, the global norm), so a step needs
no host sync.  JAX returns new arrays; ``adamw_update`` writes the new
parameters and moments into the tensors it is given (in place, which saves
a second copy of parameters and moments at full width) and returns them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def adamw_init(params: Sequence[torch.Tensor],
               moment_dtype: Optional[str] = None) -> dict:
    """{"m": [zeros], "v": [zeros], "count": 0-d int32}: one moment per
    parameter, in ``moment_dtype`` or the parameter's dtype."""
    def zeros(p):
        dt = getattr(torch, moment_dtype) if moment_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    params = list(params)
    return {"m": [zeros(p) for p in params],
            "v": [zeros(p) for p in params],
            "count": torch.zeros((), dtype=torch.int32,
                                 device=params[0].device)}


def global_norm_sq(grads: Sequence[torch.Tensor]):
    """The squares of every gradient's entries in fp32, summed in the
    list's order (0 for no gradient)."""
    total = 0
    for g in grads:
        total = total + torch.sum(torch.square(g.float()))
    return total


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        total=None):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in their dtypes,
    the global norm as a 0-d fp32 tensor): the norm of every gradient in
    fp32, summed in the list's order (``global_norm_sq``), or the square
    root of ``total`` where the caller summed the squares (a sharded step,
    over its ranks)."""
    gn = torch.sqrt(global_norm_sq(grads) if total is None else total)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], gn


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: dict, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step at learning rate ``lr`` (a 0-d tensor or a float),
    written in place into ``params`` and ``state``'s moments; returns
    (params, state) with ``count`` advanced by one."""
    count = state["count"] + 1
    cf = count.float()
    bc1, bc2 = 1 - torch.pow(b1, cf), 1 - torch.pow(b2, cf)
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        gf = g.float()
        m1 = b1 * m.float() + (1 - b1) * gf
        v1 = b2 * v.float() + (1 - b2) * torch.square(gf)
        mhat = m1 / bc1
        vhat = v1 / bc2
        step = lr * (mhat / (torch.sqrt(vhat) + eps)
                     + weight_decay * p.float())
        p.copy_(p.float() - step)
        m.copy_(m1)
        v.copy_(v1)
    return params, {"m": state["m"], "v": state["v"], "count": count}
