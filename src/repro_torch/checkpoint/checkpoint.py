"""Dependency-free checkpointing in the reference's layout
(``repro.checkpoint``):

    <dir>/step_<N>/
        manifest.json    -- structure, leaf shapes and dtypes, step
        arrays.npz       -- the leaves, ``leaf_<i>`` in flattening order

A tree is nested dicts (keys sorted, as ``jax.tree.flatten`` orders them),
lists and tuples whose leaves are tensors, numpy arrays or scalars.  Writes
go to ``step_<N>.tmp`` and are renamed into place, so a crash leaves no
half-written step (a ``.tmp`` left behind is ignored and replaced); the
last 3 steps are kept.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit pattern and
recorded as ``bfloat16`` in the manifest's ``dtypes``, so a restore gives
every leaf back bitwise.  ``restore_checkpoint`` returns tensors shaped as
the template's leaves, on their devices; ``AsyncCheckpointer`` copies the
tree to the host before its writer thread starts, so training may go on
changing the tensors in place.

Sharded trees (a multi-device step's DTensors): saving gathers every
DTensor leaf to its full tensor, a collective that every rank of its mesh
joins, and rank 0 of the process group alone writes.  Leaves are stored
whole, so ``restore_checkpoint(..., shardings=)`` may lay them out on
another mesh than the one that saved them (elastic restore): each rank
reads the files and keeps its own block of each leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import NamedSharding, shard


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          NamedSharding):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_host(x):
    """A leaf as (numpy array, dtype name): a host copy; bf16 as its bits.
    A DTensor is gathered first (every rank of its mesh must call)."""
    if isinstance(x, torch.Tensor):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(x)
    return a, str(a.dtype)


def _snapshot(tree) -> tuple[list, str]:
    """(every leaf copied to the host as (array, dtype name), the tree's
    structure)."""
    return [_to_host(x) for x in _flatten(tree)], _structure(tree)


def _write(ckpt_dir: str, step: int, snapshot) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, structure = snapshot
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "treedef": structure,
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a, _ in leaves],
        "dtypes": [dt for _, dt in leaves],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # prune older checkpoints, keep last 3
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-3]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    return final


def _writer() -> bool:
    """Whether this process writes: rank 0 of the process group, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step`` (rank 0 of a process group alone
    writes; every rank gathers); returns the step's directory."""
    snap = _snapshot(tree)
    if _writer():
        return _write(ckpt_dir, step, snap)
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, tree_like,
                       shardings=None):
    """Step ``step`` in the structure of ``tree_like``: each tensor leaf of
    the template is replaced by the stored one, on the template leaf's
    device (numpy and scalar leaves come back as numpy arrays).  Raises
    when the leaf count, a shape or a dtype differs from the template.

    ``shardings``: a tree of ``tree_like``'s structure whose leaves are
    ``parallel.sharding.NamedSharding``s or None; a tensor leaf with a
    sharding comes back as a DTensor laid out by its spec on its mesh
    (which may differ from the mesh that saved it), each rank holding its
    own block."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    template = _flatten(tree_like)
    n = manifest["n_leaves"]
    if n != len(template):
        raise ValueError(f"checkpoint has {n} leaves, model has "
                         f"{len(template)}")
    places = _flatten(shardings) if shardings is not None \
        else [None] * n
    if len(places) != n:
        raise ValueError(f"shardings have {len(places)} leaves, the "
                         f"template {n}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (like, dt, where) in enumerate(zip(
                template, manifest["dtypes"], places)):
            a = data[f"leaf_{i}"]
            if dt == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            if isinstance(like, torch.Tensor):
                if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
                    raise ValueError(
                        f"leaf {i}: stored {tuple(t.shape)} {t.dtype}, model "
                        f"has {tuple(like.shape)} {like.dtype}")
                out.append(t.to(like.device) if where is None else
                           shard(t, where.mesh, where.spec))
            else:
                out.append(a)
    return _unflatten(tree_like, iter(out))


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training (one in flight).
    ``wait`` re-raises a write's failure."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread = None
        self._error = None

    def save(self, step: int, tree):
        self.wait()
        snap = _snapshot(tree)     # off the device, a copy
        if not _writer():
            return
        self._thread = threading.Thread(target=self._run, args=(step, snap),
                                        daemon=True)
        self._thread.start()

    def _run(self, step: int, snap):
        try:
            _write(self.ckpt_dir, step, snap)
        except Exception as e:     # reported by wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
