"""Time the fused stencil (K1) on the 4K frame across its launch geometry,
beside two yardsticks, on one NVIDIA card.

    PYTHONPATH=src python3 tools/k1_sweep.py

For f32 and bf16 at the DSE's (block_rows, halo) = (2, 2) it prints, per
line, the kernel's time with a cold L2 (``chip_smoke.time_cold_ms``) and
warm (``chip_smoke.time_ms``):

* the geometry ``launch_geometry`` picks, and the same call timed after a
  flush that only writes the scratch buffer (``read_back=False``: the L2
  is left holding dirty lines the call must write back);
* output rows per run from 8 to 24 (the C entry takes any run; the grid
  follows), at the ring depths ``RING_DEPTHS`` (rows in flight a thread,
  each depth a build of the same source with its own ``K1_RING``);
* ``Tensor.copy_`` of the frame (the same bytes read and written as K1
  moves) and K1 on a 3x3 image (the launch floor).

Each run's output is checked bit for bit against the plain version.  The
last line is one JSON object: the card and every measurement.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

RUNS = range(8, 26, 2)
RING_DEPTHS = (4, 8)
REPS = 21


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import _cuda
    from repro_torch.kernels import stencil_pipeline as sp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    ring_line = f"#define K1_RING {sp.RING_ROWS}\n"
    assert ring_line in sp.kernel_source()
    sources = {f"k1_ring{d}": sp.kernel_source().replace(
        ring_line, f"#define K1_RING {d}\n") for d in RING_DEPTHS}
    _cuda.build_many(sources)
    for name in sources:
        print(f"{name}: ptxas " + " | ".join(
            cs.ptxas_summary(_cuda.BUILD_LOG.get(name, (0, ""))[1])))
    dev = torch.device("cuda")
    w = torch.tensor([0.25, 0.5, 0.25], device=dev)
    H, W = cs.FRAME
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        x = torch.rand((H, W), device=dev).to(dt)
        want = sp.stencil_pipeline_plain(x, w, w)
        g = sp.launch_geometry(H, W, dt, 2, 2)
        call = lambda: sp.stencil_pipeline(x, w, w, block_rows=2, halo=2)
        row = {"dtype": name, "what": "default", "run": g.run,
               "blocks": g.grid[0] * g.grid[1], "ring": sp.RING_ROWS,
               "cold_ms": cs.time_cold_ms(call, REPS),
               "warm_ms": cs.time_ms(call, REPS)[0],
               "write_only_flush_ms": cs.time_cold_ms(call, REPS,
                                                      read_back=False),
               "equal_plain": torch.equal(call(), want)}
        rows.append(row)
        print(json.dumps(row))
        for depth in RING_DEPTHS:
            lib = _cuda.load(f"k1_ring{depth}", sources[f"k1_ring{depth}"])
            f = getattr(lib, sp._ENTRY[dt])
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
                + [ctypes.c_void_p]
            smem = depth * (g.threads * 16 + g.threads // 32 * 8)
            for run in RUNS:
                runs = math.ceil((H - 2) / run)
                out = torch.empty((H - 2, W - 2), dtype=dt, device=dev)

                def go():
                    rc = f(x.data_ptr(), w.data_ptr(), w.data_ptr(),
                           out.data_ptr(), H, W, 2, 2, g.grid[0], runs,
                           g.threads, run, smem, _cuda.current_stream(dev))
                    _cuda.check(lib, rc, "k1_sweep")
                go()
                row = {"dtype": name, "what": "sweep", "run": run,
                       "blocks": g.grid[0] * runs, "ring": depth,
                       "cold_ms": cs.time_cold_ms(go, REPS),
                       "warm_ms": cs.time_ms(go, REPS)[0],
                       "equal_plain": torch.equal(out, want)}
                rows.append(row)
                print(json.dumps(row))
        y = torch.empty_like(x)
        tiny = torch.rand((3, 3), device=dev).to(dt)
        row = {"dtype": name, "what": "yardsticks",
               "copy_cold_ms": cs.time_cold_ms(lambda: y.copy_(x), REPS),
               "copy_warm_ms": cs.time_ms(lambda: y.copy_(x), REPS)[0],
               "launch_floor_ms": cs.time_ms(lambda: sp.stencil_pipeline(
                   tiny, w, w, block_rows=1, halo=2), REPS)[0]}
        rows.append(row)
        print(json.dumps(row))
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
