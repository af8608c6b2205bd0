"""Time K5's backward walk at hd 64 across its tile, on one NVIDIA card.

    PYTHONPATH=src python3 tools/k5_bwd_tiles.py

Each variant is ``csrc/wkv6_bwd.cu`` with its ``Tile<64>`` line replaced
(CT columns a thread of the walk, W states a window in registers, K
tokens between checkpoints; chunks of 64), built as a library of its own.
Each is held against ``wkv6_bwd_chunked_plain`` (f32 within 2e-4 of each
gradient's largest entry, bf16 dr, dk, dv within 1e-2, bitwise the same
twice) on four shapes, then timed at the train_rwkv path's (2, 40, 2048,
64) bf16 views with the model's decays, in turns (every variant, then
again in reverse order), with the walk kernel's own time off the
profiler.  The last line is one JSON object: the card and every
measurement.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# (CT, W, K) at hd 64; the first is the source's own
VARIANTS = ((8, 4, 8), (16, 4, 8), (16, 2, 8), (8, 2, 8), (4, 4, 8),
            (8, 4, 16))
CHECKS = ((2, 200, "float32", "model", True), (1, 63, "bfloat16", 1e-3, False),
          (2, 1, "float32", 1.0, True), (2, 2048, "bfloat16", "model", False))


def tile_line(ct: int, w: int, k: int) -> str:
    return (f"template <> struct Tile<64> {{ static constexpr int CT = {ct}, "
            f"W = {w}, K = {k}, C = 64; }};")


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch import _cuda
    from repro_torch.kernels import wkv6 as wk

    if not torch.cuda.is_available():
        print("k5_bwd_tiles: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    base = wk.bwd_kernel_source()
    own = tile_line(*VARIANTS[0])
    if own not in base:
        print(f"k5_bwd_tiles: the source's Tile<64> is not {own}",
              file=sys.stderr)
        return 1
    names = {v: "wkv6_bwd_tile_{}_{}_{}".format(*v) for v in VARIANTS}
    srcs = {names[v]: base.replace(own, tile_line(*v)) for v in VARIANTS}
    _cuda.build_many(srcs)
    dev = torch.device("cuda")
    launchers = {}
    for v in VARIANTS:
        lib = _cuda.load(names[v], srcs[names[v]])
        launchers[v] = {dt: (lib, _cuda.entry(lib, wk._BWD_ENTRY[dt],
                                               [ctypes.c_void_p] * 19
                                               + [ctypes.c_int] * 5
                                               + [ctypes.c_void_p]))
                        for dt in (torch.float32, torch.bfloat16)}
    own_launcher = wk._bwd_launcher
    res = {}
    try:
        for v in VARIANTS:
            wk._bwd_launcher = launchers[v].__getitem__
            ptxas = [p for p in cs.ptxas_kernels(
                _cuda.BUILD_LOG[names[v]][1], r"wkv6_bwd_walk_kernel")
                if ",64>" in p]
            ok = True
            try:
                for B, S, dt, w, st in CHECKS:
                    dtype = getattr(torch, dt)
                    xs, u, s0, dout, ds = cs.k5_bwd_inputs(dev, B, S, dtype,
                                                           w, st, seed=5)
                    got = wk.wkv6_bwd(*xs, u, s0, dout, ds)
                    again = wk.wkv6_bwd(*xs, u, s0, dout, ds)
                    want = wk.wkv6_bwd_chunked_plain(*xs, u, s0, dout, ds, 64)
                    for name, a, b, c in zip(("dr", "dk", "dv", "dw", "du",
                                              "ds0"), got, again, want):
                        lim = cs.K5_BWD_TOL[dt][name]
                        err = (a.float() - c).abs().max().item()
                        ok = ok and torch.equal(a, b) and \
                            err <= lim * c.abs().max().item()
            except RuntimeError as e:   # a launch the card refuses
                print(f"tile {v}: {e}")
                ok = False
            res[v] = {"ok": ok, "ptxas": ptxas, "ms": []}
            print(f"tile (CT, W, K) = {v}: {'==' if ok else '!='} plain; "
                  f"ptxas " + " | ".join(ptxas), flush=True)
        xs, u, _, dout, _ = cs.k5_bwd_inputs(dev, 2, 2048, torch.bfloat16,
                                             "model", False, seed=21)
        good = [v for v in VARIANTS if res[v]["ok"]]
        for order in (good, good[::-1]):
            for v in order:
                wk._bwd_launcher = launchers[v].__getitem__
                res[v]["ms"].append(cs.time_ms(
                    lambda: wk.wkv6_bwd(*xs, u, None, dout), 10)[0])
        for v in good:
            wk._bwd_launcher = launchers[v].__getitem__
            acts = cs.device_kernels(lambda: wk.wkv6_bwd(*xs, u, None,
                                                         dout))[0]
            res[v]["walk_ms"] = sum(us for n_, us in acts
                                    if "wkv6_bwd_walk" in n_) / 1e3
            print(f"tile (CT, W, K) = {v}: call "
                  + ", ".join(f"{t:.4f}" for t in res[v]["ms"])
                  + f" ms (in turns); walk kernel {res[v]['walk_ms']:.4f} ms"
                  " (profiler)")
    finally:
        wk._bwd_launcher = own_launcher
    print(json.dumps({"card": card, "shape": [2, 40, 2048, 64],
                      "variants": [{"tile": list(v), **res[v]}
                                   for v in VARIANTS]}))
    return 0 if res[VARIANTS[0]]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
