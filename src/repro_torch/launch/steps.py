"""Step builders shared by the trainer and the server: the single-device
part of ``repro.launch.steps``.

The reference's builders also return shardings and abstract inputs for its
dry-run compiles; those wait for the multi-device slice (``parallel/``,
``launch/dryrun.py``, ``api.input_specs``).  Here a builder returns the
step function alone.  PyTorch runs eagerly, so a step is the plain Python
of the reference's jitted body.
"""
from __future__ import annotations

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import adamw_update, clip_by_global_norm, \
    cosine_schedule


def build_train_step(cfg: ArchConfig, model: lm.LM):
    """``train_step(model, opt_state, batch) -> {"loss", "grad_norm"}``:
    the loss, its gradients (``torch.autograd.grad``; ``model``'s
    parameters must require grad), global-norm clipping at 1.0, the cosine
    schedule's rate at the optimiser's ``count`` and one AdamW step, which
    writes the parameters and ``opt_state`` in place.  The metrics are 0-d
    tensors on the model's device: the step itself never syncs."""
    params = model.param_list()

    def train_step(model, opt_state, batch):
        loss = lm.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt_state["count"])
        _, new = adamw_update(params, grads, opt_state, lr)
        opt_state.update(new)
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def build_prefill_step(cfg: ArchConfig, model: lm.LM):
    """``prefill_step(model, batch) -> logits``."""
    def prefill_step(model, batch):
        return lm.forward(cfg, model, batch)

    return prefill_step


def build_decode_step(cfg: ArchConfig, model: lm.LM):
    """``serve_step(model, cache, batch) -> (logits, cache)``."""
    def serve_step(model, cache, batch):
        return lm.decode_step(cfg, model, cache, batch)

    return serve_step
