"""Drive the port's main path on one NVIDIA card and hold every kernel on it
against its plain PyTorch version.

    python3 chip_smoke.py

The path is the paper's compiler end to end: ``hls.compile`` schedules each
stencil chain of ``programs.CHAIN_BENCHMARKS`` at n=8 (the repo's practice:
the ILPs are sized by the loop bounds), the design point's block size is
lowered at n=4096 to the generated streamed CUDA kernel (K2, both
bufferings) and launched; the hand-written fused stencil (K1) runs on a
4K UHD frame with the configuration the DSE sweep reads off the generated
kernel.  Every kernel is built from the sources in the checkout (one nvcc
per source, all at once, into ``build/``).

Lines it prints, in order: the card's name and power limit as nvidia-smi
gives them; the build; the main path's config; one line per check; one JSON
line ``{"kernels": [...]}`` (per kernel: launches on the main path, max abs
error against the plain version, times, bound); and last
``{"ok": true, "device": {...}}``.  Any failed build, launch or check
exits non-zero before the result lines.  Needs one card; exits non-zero
without one.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# hermetic: the compile cache would otherwise persist under $HOME
os.environ["REPRO_HLS_CACHE"] = "0"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
FRAME = (2160, 3840)             # 4K UHD: K1's image
CHAIN_N = 4096                   # K2's chains at image size
CHECK_N = 16                     # float64 check against sequential_exec
SPIN_CYCLES_PER_MS = 2_000_000   # above the H100's SM clock: spins long
K1_REPLACES = "src/repro/kernels/stencil_pipeline.py:42"
K2_REPLACES = "src/repro/core/codegen.py:475"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``.  Device time is the median
    over ``reps`` calls of a CUDA event pair around each call, after
    warm-up.  A spin kernel queued first, twice as long as it takes the host
    to enqueue every call, keeps the card busy meanwhile, so the calls run
    back to back and the events see device time, not the wrapper's host
    overhead (reported apart as host ms: the enqueue time of one call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    spin_ms = min(2 * reps * host_ms + 1, 2000)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * spin_ms))
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev), host_ms


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def stage_flops(p) -> int:
    """Arithmetic the program needs: each nest's ops over its own domain
    (what the function computes, not the halo rows a tile recomputes)."""
    from repro_torch.core.ir import ArithOp, Loop
    total = 0
    for nest in p.body:
        trips, cur = 1, nest
        while isinstance(cur, Loop):
            trips *= cur.trip
            inner = [x for x in cur.body if isinstance(x, Loop)]
            ops = cur.body
            cur = inner[0] if inner else None
        total += trips * sum(isinstance(op, ArithOp) for op in ops)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    import numpy as np

    from repro_torch import _cuda
    from repro_torch.core import codegen, hls, programs, sim
    from repro_torch.kernels import stencil_pipeline as sp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- the main path: counts from 0, compile, lower, build, launch ------
    sp.LAUNCHES.clear()
    codegen.LAUNCHES.clear()
    t0 = time.perf_counter()
    cfg = sp._stencil_codegen_config()
    src = sp.stencil_config_source()
    if (cfg, src) != ((2, 2), "dse"):
        fail(f"stencil config {cfg} from {src}, expected (2, 2) from dse")
    print(f"config: K1 (block_rows, halo) = {cfg} from {src}")
    kernels = {}   # chain -> (program, double, single, best block_rows)
    for name, mk in programs.CHAIN_BENCHMARKS.items():
        r = hls.compile(mk(8, storage="bram"))
        br = r.emit_cuda().block_rows
        big = mk(CHAIN_N, storage="bram")
        kernels[name] = (big, codegen.lower_program(big, block_rows=br),
                         codegen.lower_program(big, block_rows=br,
                                               buffering="single"), br)
        print(f"compile: {name} n=8 best '{r.best.desc}' -> block_rows {br},"
              f" halo {kernels[name][1].halo}")
    checks = {name: mk(CHECK_N, storage="bram")
              for name, mk in programs.CHAIN_BENCHMARKS.items()}
    compile_s = time.perf_counter() - t0
    sources = {sp.LIB_NAME: sp.kernel_source()}
    for name, (_, kd, _, br) in kernels.items():
        sources[kd.lib_name] = kd.source
        k = codegen.lower_program(checks[name], block_rows=br,
                                  dtype="float64")
        sources[k.lib_name] = k.source
    t0 = time.perf_counter()
    _cuda.build_many(sources)
    print(f"build: {len(sources)} sources, one nvcc each in parallel, "
          f"{time.perf_counter() - t0:.1f} s (compile {compile_s:.1f} s)")
    for name, (secs, log) in sorted(_cuda.BUILD_LOG.items()):
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print(f"  {name}: {secs:.1f} s; " + " | ".join(regs))

    rng = np.random.default_rng(0)
    frame = rng.uniform(0.0, 1.0, size=FRAME).astype(np.float32)
    img = {"float32": torch.as_tensor(frame, device=dev)}
    img["bfloat16"] = img["float32"].to(torch.bfloat16)
    wx = torch.tensor([0.25, 0.5, 0.25], device=dev)
    wy = torch.tensor([0.25, 0.5, 0.25], device=dev)
    k1_out = {dt: sp.stencil_pipeline(x, wx, wy) for dt, x in img.items()}
    inputs, k2_out = {}, {}
    for name, (p, kd, ks, _) in kernels.items():
        inputs[name] = sim.make_inputs(p, seed=0)
        k2_out[name] = (kd(inputs[name]), ks(inputs[name]))
    torch.cuda.synchronize()
    launches = {**{f"k1/{k}": v for k, v in sp.LAUNCHES.items()},
                **{f"k2/{k}": v for k, v in codegen.LAUNCHES.items()}}
    print("main path launches: " + json.dumps(launches, sort_keys=True))

    entries = []
    # ---- K1 against its plain version, timed ------------------------------
    H, W = FRAME
    for dt, x in img.items():
        n = sp.LAUNCHES[dt]
        if n < 1:
            fail(f"K1 {dt} was not launched on the main path")
        plain = sp.stencil_pipeline_plain(x, wx, wy)
        got = k1_out[dt]
        err = (got.float() - plain.float()).abs().max().item()
        if not torch.equal(got, plain):
            fail(f"K1 {dt} differs from its plain version (max {err})")
        esz = x.element_size()
        nbytes = (H * W + (H - 2) * (W - 2)) * esz + 6 * 4
        flops = 5 * H * (W - 2) + 5 * (H - 2) * (W - 2)
        b_ms, b_by = bound(nbytes, flops)
        wx2 = wx.to(x.dtype).view(1, 1, 1, 3)
        wy2 = wy.to(x.dtype).view(1, 1, 3, 1)
        x4 = x.view(1, 1, H, W)

        def library():
            return torch.nn.functional.conv2d(
                torch.nn.functional.conv2d(x4, wx2), wy2)
        lib_err = (library()[0, 0].float() - plain.float()).abs().max().item()
        ms, host_ms = time_ms(lambda: sp.stencil_pipeline(x, wx, wy), 25)
        entry = {
            "name": f"stencil_pipeline[{dt}]", "route": "cuda",
            "source": "src/repro_torch/csrc/stencil_pipeline.cu",
            "replaces": K1_REPLACES, "launches": n, "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_ms(
                lambda: sp.stencil_pipeline_plain(x, wx, wy), 25)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library, 25)[0], "host_ms": host_ms,
            "bytes": nbytes, "shape": [H, W], "config": list(cfg)}
        entries.append(entry)
        print(f"check: K1 {dt} {H}x{W} == plain bitwise; {ms:.4f} ms on the"
              f" card, {host_ms:.4f} ms host per call (bound {b_ms:.4f} ms, "
              f"conv2d pair {entry['library_ms']:.4f} ms, max |conv2d - "
              f"plain| {lib_err:.3g})")

    # ---- K2 per chain: kernel vs plain, double == single, timed -----------
    for name, (p, kd, ks, br) in kernels.items():
        xs = {a: torch.as_tensor(inputs[name][a], device=dev,
                                 dtype=torch.float32) for a in kd.inputs}
        plain = kd.plain(xs)
        od, os_ = k2_out[name]
        sink = kd.outputs[0]
        if not torch.equal(od[sink], os_[sink]):
            fail(f"K2 {name}: double and single buffering differ")
        nbytes = 4 * (sum(int(np.prod(p.arrays[a].shape))
                          for a in kd.inputs)
                      + int(np.prod(p.arrays[sink].shape)))
        b_ms, b_by = bound(nbytes, stage_flops(p))
        plain_ms = time_ms(lambda: kd.plain(xs), 3, warmup=1)[0]
        for k, out in ((kd, od), (ks, os_)):
            n = codegen.LAUNCHES[k.launch_key]
            if n < 1:
                fail(f"K2 {k.launch_key} was not launched on the main path")
            err = (out[sink] - plain[sink]).abs().max().item()
            if not torch.equal(out[sink], plain[sink]):
                fail(f"K2 {k.launch_key} differs from its plain version "
                     f"(max {err})")
            ms, host_ms = time_ms(lambda: k(xs),
                                  25 if k.buffering == "double" else 5)
            entries.append({
                "name": f"streamed[{name}/{k.buffering}]", "route": "cuda",
                "source": "src/repro_torch/core/codegen.py",
                "replaces": K2_REPLACES, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "host_ms": host_ms,
                "bytes": nbytes,
                "shape": list(p.arrays[sink].shape), "block_rows": br,
                "grid": list(k.grid), "smem_bytes": k.smem_bytes})
        print(f"check: K2 {name} n={CHAIN_N} double == single == plain "
              f"bitwise; double {entries[-2]['ms']:.4f} ms, single "
              f"{entries[-1]['ms']:.4f} ms (bound {b_ms:.4f} ms)")
        if name == "blur_chain":
            # the hand-written golden on the same image and weights
            w = torch.tensor([1 / 3, 1 / 2, 1 / 3], device=dev)
            golden = sp.stencil_pipeline(xs["img"], w, w,
                                         block_rows=cfg[0], halo=cfg[1])
            if not torch.equal(golden, od[sink]):
                err = (golden - od[sink]).abs().max().item()
                fail(f"K2 blur_chain differs from K1 (max {err})")
            print("check: K2 blur_chain == K1 bitwise on the same image")

    # ---- float64 against the sequential oracle ----------------------------
    for name, p in checks.items():
        x = sim.make_inputs(p, seed=1)
        want = sim.sequential_exec(p, x)
        for buf in ("double", "single"):
            k = codegen.lower_program(p, block_rows=kernels[name][3],
                                      buffering=buf, dtype="float64")
            sink = k.outputs[0]
            np.testing.assert_allclose(k(x)[sink].cpu().numpy(), want[sink],
                                       rtol=1e-12, atol=0,
                                       err_msg=f"{name}/{buf}")
        print(f"check: K2 {name} n={CHECK_N} float64 == sequential_exec "
              "(rtol 1e-12), both bufferings")

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
