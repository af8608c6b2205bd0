"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

Defined as functions, never module-level constants, so importing this
module touches no process group and no device.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes, built by
``init_device_mesh`` over the default process group.  The backend follows
the device: NCCL for "cuda", gloo for "cpu".  Nothing falls back: asking for
the card without one, for NCCL where it is missing, or for a mesh whose
device does not match the process group's backend raises.  The dry-run's
mesh is an entry point of its own, ``make_dryrun_mesh``: a fake process
group of the mesh's size, for tracing on FakeTensors.

The rule tables (``repro_torch.parallel.sharding``) read a mesh only through
``mesh_shape``, its ``{axis: size}`` view, so they also take a plain
``(shape, names)`` pair, or any object with a ``shape`` mapping and
``axis_names`` (a JAX mesh's interface), with no process group: that is how
the tests hold them at the production meshes' 256 and 512 devices.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

# the process group's backend for each device type
BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind not in BACKEND:
        raise ValueError(f"no mesh on {kind}: 'cuda' (NCCL) or 'cpu' (gloo)")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a 'cuda' mesh needs the card "
                           "(pass device='cpu' for a gloo mesh)")
    if kind == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL: a 'cuda' mesh needs it")
    return kind


def init_distributed(device="cuda", *, rank: int | None = None,
                     world_size: int | None = None,
                     store: dist.Store | None = None) -> torch.device:
    """Join the default process group with ``device``'s backend (NCCL for
    "cuda", gloo for "cpu") and return the device this process computes
    on: for "cuda" the card of ``LOCAL_RANK`` (else the rank modulo the
    cards), made current.  ``rank``, ``world_size`` and ``store`` are
    given together (a ``FileStore``, say); without them the group reads
    ``torch.distributed.run``'s environment.  A group that already exists
    must have the device's backend; otherwise this raises."""
    kind = _device_type(device)
    want = BACKEND[kind]
    if dist.is_initialized():
        if dist.get_backend() != want:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", a {kind} mesh needs {want}")
    else:
        kw = {} if store is None else dict(store=store, rank=rank,
                                           world_size=world_size)
        dist.init_process_group(want, **kw)
    if kind == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def make_mesh(shape: tuple, names: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the default
    process group (joined first through ``init_distributed`` when there is
    none), on ``device``'s type."""
    init_distributed(device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def production_mesh_spec(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of a production mesh.  Single pod: (16, 16) =
    (data, model), 256 chips.  Multi-pod: (2, 16, 16) = (pod, data,
    model), 512 chips; DP gradient reduction crosses the "pod" axis,
    everything else stays inside a pod."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """``production_mesh_spec``'s mesh over the default process group."""
    return make_mesh(*production_mesh_spec(multi_pod), device)


def make_test_mesh(n_data: int = 2, n_model: int = 2, device="cuda"):
    """Small (data, model) mesh for multi-process tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` in the mesh's axis order, of a ``DeviceMesh``, a
    ``(shape, names)`` pair or an object with ``shape`` (a mapping) and
    ``axis_names``."""
    if isinstance(mesh, tuple):
        shape, names = mesh
        return dict(zip(names, shape))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def describe(mesh) -> str:
    return f"mesh{mesh_shape(mesh)}"


def make_dryrun_mesh(shape: tuple, names: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` on ``device``'s
    type over a *fake* process group of the mesh's size, this process its
    rank 0: the dry-run's mesh, which needs neither the card nor NCCL nor
    other processes.  A fake group's collectives never communicate (they
    hand back their input), so whatever runs on this mesh must see
    FakeTensors alone.  Raises where a process group exists already; the
    caller destroys this one (``torch.distributed.destroy_process_group``)
    when done."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group exists: "
                           "the dry-run's fake group would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))
