"""Build, load and launch helpers shared by the port's CUDA kernels.

Every kernel is CUDA C++ for ``sm_90a`` with a plain C interface, compiled
by ``nvcc`` into a shared library and bound with ``ctypes``.  Builds go to
``build/`` at the repository root at first use, keyed by the sha256 of the
source text and the flags, so an unchanged kernel is never rebuilt and a
changed one never loads a stale library.  ``build_many`` starts one ``nvcc``
per source, all at once, so a caller that needs several kernels pays for
the slowest build rather than the sum.

The device rule of the port lives here too: a wrapper runs its plain
PyTorch version only for tensors that lie on the CPU (or when the caller
passes ``device="cpu"``); for the card it launches the kernel or raises.
K4 and K5 make that choice through the dispatcher: each launch is an
operator of the ``repro_torch`` namespace (``LIB``, ``torch.library``) with
a CPU implementation (the plain version), a CUDA one (the launch) and a
fake one (the outputs' shapes and dtypes), so a FakeTensor on "cuda", which
the dry-run traces with, reaches the fake implementation and nothing else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the most dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448

_LIBS: dict[tuple[str, str], ctypes.CDLL] = {}
# the kernels' operators (``torch.ops.repro_torch``), defined by their modules
LIB = torch.library.Library("repro_torch", "FRAGMENT")
# name -> (seconds, ptxas report) of the builds this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(CUDA kernels build only where the toolkit is)")


def library_path(name: str, source: str) -> Path:
    key = hashlib.sha256(
        (source + "\0" + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_many(sources: dict[str, str]) -> dict[str, Path]:
    """Compile every ``name -> CUDA source text`` not yet built, one
    ``nvcc`` per source, all started together; raises on any failure."""
    out = {name: library_path(name, src) for name, src in sources.items()}
    todo = {name: src for name, src in sources.items() if not out[name].exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, src in todo.items():
        # private file names until the rename, so concurrent builders of
        # one source never read each other's half-written files
        tmp = out[name].with_name(f"{out[name].stem}.{os.getpid()}.tmp")
        tmp.with_suffix(".cu").write_text(src)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp.with_suffix(".so")),
               str(tmp.with_suffix(".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
        so = out[name]
        so.with_suffix(".log").write_text(log)
        os.replace(tmp.with_suffix(".cu"), so.with_suffix(".cu"))
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.with_suffix(".so").unlink(missing_ok=True)
            continue
        os.replace(tmp.with_suffix(".so"), so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str, source: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (built first if needed).  Once
    loaded, a call costs one dict lookup: no hashing, no file access."""
    lib = _LIBS.get((name, source))
    if lib is None:
        lib = ctypes.CDLL(str(build_many({name: source})[name]))
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        _LIBS[(name, source)] = lib
    return lib


def entry(lib: ctypes.CDLL, fname: str, argtypes: list):
    """A C entry point of ``lib`` returning a CUDA error code."""
    fn = getattr(lib, fname)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream (the capturing stream
    under CUDA graph capture): ``torch.cuda.current_stream(device)
    .cuda_stream`` without building a ``torch.cuda.Stream`` object on every
    launch."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this kernel runs on the card; pass CPU tensors "
            "or device='cpu' to run its plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def is_fake(t) -> bool:
    """Whether ``t`` is a FakeTensor: a shape, dtype and device, no
    storage (what the dry-run traces with)."""
    return isinstance(t, FakeTensor)


def resolve_device(values: Iterable, device: Optional[str]) -> torch.device:
    """Where a wrapper runs: ``device`` when given; else the device of the
    tensors it was handed (which must agree); else (numpy input) the card.
    FakeTensors alone need no card: the operators' fake implementations
    take them."""
    if device is not None:
        return require_cuda(device)
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    if tensors and all(map(is_fake, tensors)):
        return devs.pop()
    return require_cuda(devs.pop() if devs else "cuda")


def as_input(x, dtype: torch.dtype, device: torch.device, shape: tuple,
             what: str, contiguous: bool = True) -> torch.Tensor:
    """A kernel input: numpy arrays are copied over in ``dtype``; tensors
    must already have the kernel's dtype, device, shape and (unless
    ``contiguous`` is False, for a kernel that takes strides) layout."""
    if isinstance(x, np.ndarray):
        t = torch.as_tensor(x).to(device=device, dtype=dtype)
    elif isinstance(x, torch.Tensor):
        t = x
        if t.device != device:
            raise ValueError(f"{what}: on {t.device}, kernel runs on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: not contiguous")
    else:
        raise TypeError(f"{what}: expected a numpy array or a tensor, "
                        f"got {type(x).__name__}")
    if t.shape != shape:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    return t


def unit_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its last dim is not unit-stride
    (a kernel that reads any layout whose rows are; an expanded gradient
    has stride 0 there)."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()
