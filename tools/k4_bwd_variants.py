"""Time K4's bf16 backward at hd 64 and 128 beside variants of its own
source and schedule, in one process on one card, in turns.

    PYTHONPATH=src python3 tools/k4_bwd_variants.py
    PYTHONPATH=src python3 tools/k4_bwd_variants.py --parent build/parent/src

Variants (each its own build of ``csrc/flash_attention_bwd_wgmma.cu``):

* ``tree``: the source and the schedule as they are;
* ``dq_overlap``: ``Cfg<128>::DQ_OVERLAP`` set, so that at hd 128 too a dQ
  step's product retires under the next step's S and dP, as at hd 64;
* ``cut`` (Whisper's shapes only): the tree's kernels on a schedule that
  cuts every walk longer than its block length (``WRAP_FACTOR`` 1,
  ``WRAP_SLACK`` 0), its partials summed by the fourth kernel;
* ``parent`` (with ``--parent``): the parent tree's backward, its
  ``repro_torch`` loaded as ``tools/compare_parent.py`` loads it.

Shapes: llama3-8b's train q (2, 32, 2048, 128) over 8 kv heads, Kimi-K2's
GQA 8 q (1, 64, 2048, 128) over 8 and Jamba's on ``chip_smoke.py``'s path
15, q (1, 64, 512, 128) over 8, causal; Whisper's (1, 12, 448, 64), not
causal and causal.  For each it prints the call's ms (CUDA events, median
of 20, ``chip_smoke.time_ms``) in turns (parent, tree, dq_overlap, cut,
then back), each kernel's median µs over 20 calls profiled together
(``chip_smoke.device_kernels``), whether each variant's gradients equal
the tree's bitwise, and the ptxas lines of every build; a JSON summary
last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

SHAPES = {"train": (2, 32, 8, 2048, 128, True),
          "gqa8": (1, 64, 8, 2048, 128, True),
          "jamba_path15": (1, 64, 8, 512, 128, True),
          "whisper": (1, 12, 12, 448, 64, False),
          "whisper_causal": (1, 12, 12, 448, 64, True)}
CUT_SHAPES = ("whisper", "whisper_causal")
REPS, PROFILED = 20, 20
OVERLAP_OFF = ("template <> struct Cfg<128> {\n    static constexpr int BKV = "
               "128, BK = 64, KV_STAGES = 3, Q_STAGES = 4;\n    static "
               "constexpr bool DQ_OVERLAP = false;")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the parent tree's src directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k4_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import compare_parent as cp
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    par = cp.load(args.parent, "repro_torch_parent") if args.parent else None
    tree = cp.load(os.path.join(ROOT, "src"))
    sys.modules.update(tree.modules)
    from repro_torch import _cuda
    fa = tree.fa
    src = fa.wgmma_bwd_kernel_source()
    if OVERLAP_OFF not in src:
        print("k4_bwd_variants: Cfg<128> is not as this tool expects",
              file=sys.stderr)
        return 1
    sources = {"tree": src, "dq_overlap": src.replace(
        OVERLAP_OFF, OVERLAP_OFF.replace("= false", "= true"))}
    _cuda.build_many({f"k4_bwd_{k}": v for k, v in sources.items()})
    for k in sources:
        for ln in cs.ptxas_kernels(_cuda.BUILD_LOG[f"k4_bwd_{k}"][1]):
            print(f"ptxas {k}: {ln}")
        for ln in _cuda.BUILD_LOG[f"k4_bwd_{k}"][1].splitlines():
            if "C7512" in ln:
                print(f"ptxas {k}: {ln.strip()}")
    entries = {}
    for k, s in sources.items():
        lib = _cuda.load(f"k4_bwd_{k}", s)
        entries[k] = (lib, _cuda.entry(
            lib, "flash_attention_bwd_wgmma_bf16",
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p]))
    wrap = (fa.WRAP_FACTOR, fa.WRAP_SLACK)

    def use(who):
        """Point the tree's wrapper at variant ``who``; the parent's call
        or the tree's."""
        sys.modules.update((par if who == "parent" else tree).modules)
        fa.WRAP_FACTOR, fa.WRAP_SLACK = (1.0, 0) if who == "cut" else wrap
        fa.dkdv_wrap.cache_clear()
        fa._wgmma_bwd_launcher = lambda: entries[
            "dq_overlap" if who == "dq_overlap" else "tree"]
        return (par if who == "parent" else tree).fa.flash_attention_bwd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for key, (B, H, Hkv, S, hd, causal) in SHAPES.items():
        q, k, v, dout = (torch.randn((B, S, h, hd), generator=g, device=dev)
                         .to(torch.bfloat16).transpose(1, 2)
                         for h in (H, Hkv, Hkv, H))
        out, lse = fa._run(q, k, v, causal, "wgmma", *fa.WGMMA_BLOCKS[hd][0],
                           True)
        inputs[key] = (q, k, v, out, lse, dout, causal)
    whos = (["parent"] if par else []) + ["tree", "dq_overlap", "cut"]
    res = {key: {} for key in SHAPES}
    for who in whos + whos[::-1]:
        bwd = use(who)
        for key, (q, k, v, out, lse, dout, causal) in inputs.items():
            if who == "cut" and key not in CUT_SHAPES:
                continue
            ms = cs.time_ms(lambda: bwd(q, k, v, out, lse, dout,
                                        causal=causal), REPS)[0]
            res[key].setdefault(who, {"ms": []})["ms"].append(ms)
            print(f"{who} {key}: {ms:.4f} ms", flush=True)
    for who in whos:
        bwd = use(who)
        for key, (q, k, v, out, lse, dout, causal) in inputs.items():
            if who == "cut" and key not in CUT_SHAPES:
                continue
            acts, _ = cs.device_kernels(lambda: [
                bwd(q, k, v, out, lse, dout, causal=causal)
                for _ in range(PROFILED)])
            per = {}
            for n_, us in cs.kernel_names(acts):
                per.setdefault(cs.short_name(n_), []).append(us)
            res[key][who]["kernel_us"] = {
                n_: statistics.median(v_) for n_, v_ in per.items()}
            res[key][who]["profiled_calls"] = {
                n_: len(v_) for n_, v_ in per.items()}
            if who != "tree":
                a = bwd(q, k, v, out, lse, dout, causal=causal)
                use("tree")
                b = tree.fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                causal=causal)
                bwd = use(who)
                res[key][who]["bitwise_tree"] = all(
                    torch.equal(x, y) for x, y in zip(a, b))
            print(f"{who} {key}: kernels " + ", ".join(
                f"{n_} {us:.2f} us" for n_, us in
                res[key][who]["kernel_us"].items()), flush=True)
    use("tree")
    print(json.dumps({"card": card, "shapes": SHAPES, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
