"""Drive the port's main paths on one NVIDIA card and hold every kernel on
them against its plain PyTorch version.

    python3 chip_smoke.py

Three paths, each run with the launch counts set to 0 just before it and
read just after:

1. *chains*: ``hls.compile`` schedules each stencil chain of
   ``programs.CHAIN_BENCHMARKS`` at n=8 (the repo's practice: the ILPs are
   sized by the loop bounds); the design point's block size is lowered at
   n=4096 to the generated streamed CUDA kernel (K2, both bufferings) and
   launched; the hand-written fused stencil (K1) runs on a 4K UHD frame
   with the configuration the DSE sweep reads off the generated kernel.
2. *benchmarks*: the paper's five programs (``programs.BENCHMARKS``)
   compiled at the reference tests' sizes, the best point lowered with
   ``emit_cuda``, then the original program lowered at full width (n=4096,
   ``two_mm`` at m=4096) and launched: ``unsharp`` and ``harris`` through
   K2, ``dus``, ``optical_flow`` and ``two_mm`` through the whole-array
   kernel (K3).
3. *traced*: the tracing frontend's conv block, compiled at 8x8, then the
   same PyTorch function traced at 4098x4098 and launched through K3.

Every kernel is built from the sources in the checkout (one nvcc per
source, all at once, into ``build/``).

Lines it prints, in order: the card's name and power limit as nvidia-smi
gives them; each path's compile lines; the build; each path's launch
counts; one line per check; the total seconds; one JSON line
``{"kernels": [...]}`` (per kernel: launches on its path, max abs error
against the plain version, times, bound); and last
``{"ok": true, "device": {...}}``.  Any failed build, launch or check
exits non-zero before the result lines.  Needs one card; exits non-zero
without one.
"""
from __future__ import annotations

import json
import math
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
CHAIN_N = 4096                   # programs at image size
CHECK_N = 16                     # float64 checks against sequential_exec
CONV_HW = CHAIN_N + 2            # the traced conv block's image
SPIN_CYCLES_PER_MS = 2_000_000   # above the H100's SM clock: spins long
# compile sizes of the reference tests; harris and optical_flow take the
# stencil sweep's restricted search (the default search costs them ~2.5 min)
BENCH_COMPILE_N = {"unsharp": 8, "harris": 8, "dus": 8, "optical_flow": 6,
                   "two_mm": 6}
RESTRICTED = ("harris", "optical_flow")
CHECK_SIZE = {"two_mm": 8}
K1_REPLACES = "src/repro/kernels/stencil_pipeline.py:42"
K2_REPLACES = "src/repro/core/codegen.py:475"
K3_REPLACES = "src/repro/core/codegen.py:637"
CODEGEN_SRC = "src/repro_torch/core/codegen.py"
BLUR_W = [1 / 3, 1 / 2, 1 / 3]   # blur_chain's taps
GAUSS = [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
         [0.0625, 0.125, 0.0625]]  # conv_pool's 3x3 taps


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


def kernel_bytes(p, k) -> int:
    """Each array the kernel must read, read once, plus each output written
    once, in the kernel's dtype."""
    esz = 4 if k.dtype == "float32" else 8
    return esz * sum(math.prod(p.arrays[a].shape)
                     for a in (*k.inputs, *k.outputs))


def main() -> int:
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    import numpy as np

    from repro_torch import _cuda
    from repro_torch.core import codegen, frontend, hls, programs, sim
    from repro_torch.kernels import stencil_pipeline as sp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- compile and lower every path ---------------------------------------
    t0 = time.perf_counter()
    cfg = sp._stencil_codegen_config()
    src = sp.stencil_config_source()
    if (cfg, src) != ((2, 2), "dse"):
        fail(f"stencil config {cfg} from {src}, expected (2, 2) from dse")
    print(f"config: K1 (block_rows, halo) = {cfg} from {src}")
    streamed = {}  # name -> (program, double, single, block_rows, path)
    whole = {}     # name -> (program, kernel, path)
    for name, mk in programs.CHAIN_BENCHMARKS.items():
        r = hls.compile(mk(8, storage="bram"))
        br = r.emit_cuda().block_rows
        big = mk(CHAIN_N, storage="bram")
        streamed[name] = (big, codegen.lower_program(big, block_rows=br),
                          codegen.lower_program(big, block_rows=br,
                                                buffering="single"),
                          br, "chains")
        print(f"compile: {name} n=8 best '{r.best.desc}' -> block_rows {br},"
              f" halo {streamed[name][1].halo}")
    for name, mk in programs.BENCHMARKS.items():
        n = BENCH_COMPILE_N[name]
        spec = sp.restricted_spec(hls) if name in RESTRICTED else {}
        tc = time.perf_counter()
        r = hls.compile(mk(n, storage="bram"), **spec)
        k = r.emit_cuda()
        secs = time.perf_counter() - tc
        big = mk(CHAIN_N, storage="bram")
        how = "restricted search" if spec else "default search"
        if k.mode == "streamed":
            # the point's block size; the lowering shrinks it where the
            # windows would not fit shared memory at this width
            kd, ks = (codegen.lower_program(big, block_rows=k.block_rows,
                                            buffering=b)
                      for b in ("double", "single"))
            streamed[name] = (big, kd, ks, kd.block_rows, "benchmarks")
            print(f"compile: {name} n={n} ({how}, {secs:.1f} s) best "
                  f"'{r.best.desc}' -> streamed, block_rows {k.block_rows}; "
                  f"at n={CHAIN_N}: {kd.block_rows} "
                  f"({'; '.join(kd.soft_reasons) or 'fits'})")
        else:
            kb = codegen.lower_program(big)
            whole[name] = (big, kb, "benchmarks")
            print(f"compile: {name} n={n} ({how}, {secs:.1f} s) best "
                  f"'{r.best.desc}' -> whole, {kb.nest_launches} nest "
                  f"launches, outputs {list(kb.outputs)}")
    tc = time.perf_counter()
    r = hls.compile(frontend.conv_block_program(8, 8).program)
    k = r.emit_cuda()
    traced = frontend.conv_block_program(CONV_HW, CONV_HW)
    kb = codegen.lower_program(traced.program)
    if k.mode != "whole" or kb.mode != "whole":
        fail(f"traced conv block lowers to {k.mode}/{kb.mode}, not whole")
    whole["traced_conv"] = (traced.program, kb, "traced")
    print(f"compile: traced conv block 8x8 ({time.perf_counter() - tc:.1f} "
          f"s) best '{r.best.desc}' -> whole; traced at {CONV_HW}x{CONV_HW}: "
          f"{len(traced.program.body)} nests, {len(traced.program.arrays)} "
          "arrays")
    checks = {name: mk(CHECK_N, storage="bram")
              for name, mk in {**programs.CHAIN_BENCHMARKS,
                               **programs.BENCHMARKS}.items()}
    checks["two_mm"] = programs.two_mm(CHECK_SIZE["two_mm"])
    checks["traced_conv"] = frontend.conv_block_program(10, 10).program
    compile_s = time.perf_counter() - t0

    f64 = {}
    for name, p in checks.items():
        br = streamed[name][3] if name in streamed else None
        f64[name] = [codegen.lower_program(p, block_rows=br, buffering=b,
                                           dtype="float64")
                     for b in (("double", "single") if name in streamed
                               else ("double",))]
    sources = {sp.LIB_NAME: sp.kernel_source()}
    for k in ([s[1] for s in streamed.values()]
              + [w[1] for w in whole.values()]
              + [ks[0] for ks in f64.values()]):
        sources[k.lib_name] = k.source
    t0 = time.perf_counter()
    _cuda.build_many(sources)
    print(f"build: {len(sources)} sources, one nvcc each in parallel, "
          f"{time.perf_counter() - t0:.1f} s (compile {compile_s:.1f} s)")
    for name, (secs, log) in sorted(_cuda.BUILD_LOG.items()):
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print(f"  {name}: {secs:.1f} s; " + " | ".join(regs))

    # ---- the paths: counts from 0, launch, counts read ---------------------
    rng = np.random.default_rng(0)
    frame = rng.uniform(0.0, 1.0, size=FRAME).astype(np.float32)
    img = {"float32": torch.as_tensor(frame, device=dev)}
    img["bfloat16"] = img["float32"].to(torch.bfloat16)
    wx = torch.tensor([0.25, 0.5, 0.25], device=dev)
    wy = torch.tensor([0.25, 0.5, 0.25], device=dev)
    xs = {}        # name -> the kernel's input tensors on the card
    for name, (p, k, *_) in {**streamed, **whole}.items():
        x = sim.make_inputs(p, seed=0)
        xs[name] = {a: torch.as_tensor(x[a], dtype=torch.float32,
                                       device=dev) for a in k.inputs}
    launches, outs, k1_out = {}, {}, {}
    for path in ("chains", "benchmarks", "traced"):
        sp.LAUNCHES.clear()
        codegen.LAUNCHES.clear()
        if path == "chains":
            k1_out = {dt: sp.stencil_pipeline(x, wx, wy)
                      for dt, x in img.items()}
        for name, (p, kd, ks, br, pth) in streamed.items():
            if pth == path:
                outs[name] = (kd(xs[name]), ks(xs[name]))
        for name, (p, k, pth) in whole.items():
            if pth == path:
                outs[name] = k(xs[name])
        torch.cuda.synchronize()
        launches[path] = {
            **{f"k1/{k}": v for k, v in sp.LAUNCHES.items()},
            **{f"{'k3' if k.split('/')[1] == 'whole' else 'k2'}/{k}": v
               for k, v in codegen.LAUNCHES.items()}}
        print(f"{path} path launches: "
              + json.dumps(launches[path], sort_keys=True))

    entries = []
    # ---- K1 against its plain version, timed ------------------------------
    H, W = FRAME
    for dt, x in img.items():
        n = launches["chains"].get(f"k1/{dt}", 0)
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

    # ---- K2 per program: kernel vs plain, double == single, timed ---------
    def k2_library(name, x):
        """One PyTorch call per stage computing the chain, where there is
        one (timed only; cuDNN sums in another order)."""
        F = torch.nn.functional
        if name == "blur_chain":
            w = torch.tensor(BLUR_W, device=dev)
            x4 = x["img"][None, None]
            return lambda: F.conv2d(F.conv2d(x4, w.view(1, 1, 1, 3)),
                                    w.view(1, 1, 3, 1))[0, 0]
        if name == "conv_pool":
            g = torch.tensor(GAUSS, device=dev).view(1, 1, 3, 3)
            x4 = x["img"][None, None]
            return lambda: F.max_pool2d(F.conv2d(x4, g), 2)[0, 0]
        return None

    for name, (p, kd, ks, br, path) in streamed.items():
        x = xs[name]
        plain = kd.plain(x)
        od, os_ = outs[name]
        sink = kd.outputs[0]
        if not torch.equal(od[sink], os_[sink]):
            fail(f"K2 {name}: double and single buffering differ")
        nbytes = kernel_bytes(p, kd)
        b_ms, b_by = bound(nbytes, stage_flops(p))
        plain_ms = time_ms(lambda: kd.plain(x), 3, warmup=1)[0]
        lib = k2_library(name, x)
        lib_ms, lib_note = None, "no PyTorch call computes it"
        if lib is not None:
            lib_ms = time_ms(lib, 25)[0]
            lib_note = (f"max |library - plain| "
                        f"{(lib() - plain[sink]).abs().max().item():.3g}")
        for k, out in ((kd, od), (ks, os_)):
            n = launches[path].get(f"k2/{k.launch_key}", 0)
            if n < 1:
                fail(f"K2 {k.launch_key} was not launched on its path")
            err = (out[sink] - plain[sink]).abs().max().item()
            if not torch.equal(out[sink], plain[sink]):
                fail(f"K2 {k.launch_key} differs from its plain version "
                     f"(max {err})")
            ms, host_ms = time_ms(lambda: k(x),
                                  25 if k.buffering == "double" else 5)
            entries.append({
                "name": f"streamed[{name}/{k.buffering}]", "route": "cuda",
                "source": CODEGEN_SRC, "replaces": K2_REPLACES,
                "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "library": lib_note,
                "host_ms": host_ms, "bytes": nbytes,
                "shape": list(p.arrays[sink].shape), "block_rows": br,
                "grid": list(k.grid), "smem_bytes": k.smem_bytes})
        print(f"check: K2 {name} n={CHAIN_N} double == single == plain "
              f"bitwise; double {entries[-2]['ms']:.4f} ms, single "
              f"{entries[-1]['ms']:.4f} ms (bound {b_ms:.4f} ms; library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"{lib_note})")
        if name == "blur_chain":
            # the hand-written golden on the same image and weights
            w = torch.tensor(BLUR_W, device=dev)
            golden = sp.stencil_pipeline(x["img"], w, w,
                                         block_rows=cfg[0], halo=cfg[1])
            if not torch.equal(golden, od[sink]):
                err = (golden - od[sink]).abs().max().item()
                fail(f"K2 blur_chain differs from K1 (max {err})")
            print("check: K2 blur_chain == K1 bitwise on the same image")

    # ---- K3 per program: kernel vs plain (NaN-aware), timed ---------------
    for name, (p, k, path) in whole.items():
        x = xs[name]
        n = launches[path].get(f"k3/{k.launch_key}", 0)
        if n < 1:
            fail(f"K3 {k.launch_key} was not launched on its path")
        got = outs[name]
        plain = k.plain(x)
        err, nans = 0.0, 0
        for a in k.outputs:
            try:
                torch.testing.assert_close(got[a], plain[a], rtol=0, atol=0,
                                           equal_nan=True)
            except AssertionError as e:
                fail(f"K3 {name}: '{a}' differs from its plain version: {e}")
            d = (got[a] - plain[a]).abs().nan_to_num(0.0)
            err = max(err, d.max().item())
            nans += int(got[a].isnan().sum().item())
        nbytes = kernel_bytes(p, k)
        b_ms, b_by = bound(nbytes, stage_flops(p))
        slow = name == "two_mm"
        ms, host_ms = time_ms(lambda: k(x), 3 if slow else 10, warmup=1)
        plain_ms = time_ms(lambda: k.plain(x), 1 if slow else 3,
                           warmup=0 if slow else 1)[0]
        lib_ms, lib_note = None, "no PyTorch call computes it"
        if name == "two_mm":
            def library():
                tmp = torch.addmm(x["tmp"], x["A"], x["B"])
                return tmp, torch.addmm(x["D"], tmp, x["C"])
            lib_ms = time_ms(library, 10)[0]
            rel = ((library()[1] - got["D"]).abs().max()
                   / got["D"].abs().max()).item()
            lib_note = ("torch.addmm pair, TF32 off; max |addmm - kernel| / "
                        f"max |kernel| {rel:.3g} on D (cuBLAS sums in "
                        "another order)")
        elif name == "traced_conv":
            x4 = x["img"][None, None]

            def library():
                return torch.nn.functional.conv2d(
                    torch.nn.functional.conv2d(x4, x["wx"].view(1, 1, 1, 3)),
                    x["wy"].view(1, 1, 3, 1))
            lib_ms = time_ms(library, 25)[0]
            diff = (library()[0, 0] - got["out"]).abs().max().item()
            lib_note = ("conv2d pair, TF32 off; max |conv2d - kernel| "
                        f"{diff:.3g}")
        entries.append({
            "name": f"whole[{name}]", "route": "cuda", "source": CODEGEN_SRC,
            "replaces": K3_REPLACES, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "library": lib_note,
            "host_ms": host_ms, "bytes": nbytes, "nests": k.nest_launches,
            "nans": nans, "outputs": list(k.outputs),
            "shape": list(p.arrays[k.outputs[-1]].shape)})
        print(f"check: K3 {name} == plain bitwise (NaN-aware, {nans} NaN) "
              f"on {len(k.outputs)} outputs; {ms:.4f} ms on the card in "
              f"{k.nest_launches} nest launches (bound {b_ms:.4f} ms by "
              f"{b_by}; plain {plain_ms:.4f} ms; library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"{lib_note})")
    # the traced conv block is K1's function: same image, same weights
    x = xs["traced_conv"]
    golden = sp.stencil_pipeline(x["img"], x["wx"], x["wy"],
                                 block_rows=cfg[0], halo=cfg[1])
    if not torch.equal(golden, outs["traced_conv"]["out"]):
        err = (golden - outs["traced_conv"]["out"]).abs().max().item()
        fail(f"K3 traced conv block differs from K1 (max {err})")
    k1_ms = time_ms(lambda: sp.stencil_pipeline(
        x["img"], x["wx"], x["wy"], block_rows=cfg[0], halo=cfg[1]), 25)[0]
    entry = next(e for e in entries if e["name"] == "whole[traced_conv]")
    entry["k1_ms"] = k1_ms
    print(f"check: K3 traced conv block {CONV_HW}x{CONV_HW} == K1 bitwise on "
          f"the same image and weights; K1 takes {k1_ms:.4f} ms there, K3 "
          f"{entry['ms']:.4f} ms")

    # ---- float64 against the sequential oracle ----------------------------
    for name, ks in f64.items():
        p = checks[name]
        x = sim.make_inputs(p, seed=1)
        want = sim.sequential_exec(p, x)
        for k in ks:
            got = k(x)
            for a in k.outputs:
                np.testing.assert_allclose(
                    got[a].cpu().numpy(), want[a], rtol=1e-12, atol=0,
                    err_msg=f"{name}/{k.buffering}/{a}")
        shape = "x".join(map(str, p.arrays[ks[0].outputs[-1]].shape))
        print(f"check: {'K2' if ks[0].mode == 'streamed' else 'K3'} {name} "
              f"({shape} output) float64 == sequential_exec (rtol 1e-12), "
              + ("both bufferings" if len(ks) == 2 else
                 f"all {len(ks[0].outputs)} outputs"))

    print(f"total: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
