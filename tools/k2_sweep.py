"""Time the streamed kernel (K2) across its walk's knobs on one NVIDIA card.

    PYTHONPATH=src python3 tools/k2_sweep.py
    PYTHONPATH=src python3 tools/k2_sweep.py --programs harris \
        --runs 8,16 --col-tiles 512 --strip-rows 2,4

For each streamed program at n=4096 in float32, at the block size its
design point takes (``compare_parent.K2_BLOCK_ROWS``: the DSE's at n=8, as
``chip_smoke.py`` compiles it), and for every combination of

* ``--runs``: row tiles a block walks (``codegen._RUN_TILES``),
* ``--col-tiles``: the column tile (``codegen._COL_TILES``, the shared
  memory target lifted so the tile is taken as given),
* ``--strip-rows``: rows of a thread's strip at most
  (``codegen._STRIP_ROWS``),
* ``--ahead``: tiles of input rows in flight (``codegen._AHEAD``),

it lowers the program, builds its variants at once (one nvcc each; a
variant nvcc refuses is reported and skipped), checks each variant's output bit for bit against the plain version, and
prints one JSON line: the geometry (launch grid, threads, shared bytes),
ptxas' registers and spills of ``streamed_double``, and the kernel's time
(``chip_smoke.time_ms``, CUDA events, median of 25 calls).  The default
geometry (the module's own knobs) is timed first for each program, beside
two yardsticks: ``Tensor.copy_`` of the program's input (about the bytes
the kernel moves) and, on blur_chain's image, the hand-written K1.  The
last line is one JSON object: the card and every row.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from compare_parent import K2_BLOCK_ROWS as BLOCK_ROWS  # noqa: E402

N = 4096
REPS = 25


def ints(s: str) -> list:
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--programs", default=",".join(BLOCK_ROWS))
    ap.add_argument("--runs", type=ints, default=[4, 8, 16, 32])
    ap.add_argument("--col-tiles", type=ints, default=[256, 512, 1024])
    ap.add_argument("--strip-rows", type=ints, default=[2, 4])
    ap.add_argument("--ahead", type=ints, default=[1, 2])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k2_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import _cuda
    from repro_torch.core import codegen, programs, sim
    from repro_torch.kernels import stencil_pipeline as sp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    ctors = {**programs.CHAIN_BENCHMARKS, **programs.BENCHMARKS}
    knobs = ("_RUN_TILES", "_COL_TILES", "_STRIP_ROWS", "_AHEAD",
             "_SMEM_TARGET")
    default = {kn: getattr(codegen, kn) for kn in knobs}
    rows = []
    for name in args.programs.split(","):
        p = ctors[name](N, storage="bram")
        variants = [(None, codegen.lower_program(
            p, block_rows=BLOCK_ROWS[name]))]
        for run, cw, h, d in itertools.product(args.runs, args.col_tiles,
                                               args.strip_rows, args.ahead):
            for kn, v in zip(knobs, (run, (cw,), h, d, 1 << 30)):
                setattr(codegen, kn, v)
            try:
                k = codegen.lower_program(p, block_rows=BLOCK_ROWS[name])
            finally:
                for kn, v in default.items():
                    setattr(codegen, kn, v)
            k.program_name = f"{name}_R{run}_c{cw}_h{h}_d{d}"
            variants.append(({"run": run, "col_tile": cw, "strip_rows": h,
                              "ahead": d}, k))
        try:
            _cuda.build_many({k.lib_name: k.source for _, k in variants})
        except RuntimeError as e:
            print(str(e)[-3000:])
        x = sim.make_inputs(p, seed=0)
        xs = {a: torch.as_tensor(x[a], dtype=torch.float32, device=dev)
              for a in variants[0][1].inputs}
        sink = variants[0][1].outputs[0]
        want = variants[0][1].plain(xs)[sink]
        x0 = next(iter(xs.values()))
        y0 = torch.empty_like(x0)
        row = {"program": name, "yardstick": "Tensor.copy_ of the input",
               "bytes": 2 * x0.numel() * x0.element_size(),
               "ms": cs.time_ms(lambda: y0.copy_(x0), REPS)[0]}
        if name == "blur_chain":
            w = torch.tensor(cs.BLUR_W, device=dev)
            row["k1_ms"] = cs.time_ms(lambda: sp.stencil_pipeline(
                x0, w, w, block_rows=2, halo=2), REPS)[0]
        rows.append(row)
        print(json.dumps(row), flush=True)
        for cfg, k in variants:
            if not _cuda.library_path(k.lib_name, k.source).exists():
                continue
            log = _cuda.BUILD_LOG.get(k.lib_name, (0, ""))[1]
            row = {"program": name, "config": cfg or "default",
                   "block_rows": k.block_rows, "run": k.run,
                   "col_tile": k.col_tile, "launch_grid": list(k.launch_grid),
                   "threads": k.threads, "smem_bytes": k.smem_bytes,
                   "ptxas": cs.ptxas_summary(log),
                   "equal_plain": torch.equal(k(xs)[sink], want),
                   "ms": cs.time_ms(lambda: k(xs), REPS)[0]}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del xs, want
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if all(r.get("equal_plain", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
