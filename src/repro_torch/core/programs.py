"""The paper's benchmark suite (§5.1) as affine programs.

  * unsharp mask      — 32x32 patch, blur-x/blur-y/sharpen/mask (4 nests)
  * harris corners    — 32x32, gradients + windowed sums + response (6 nests)
  * DUS               — 32x32 down-then-up-sample, 4 nests, the Vitis killer
                        (window reads ==> read order != write order)
  * optical flow      — 32x32 Lucas-Kanade single scale (9 nests)
  * 2mm               — 8x8 polybench, intermediate written to a function arg
  * fig1 conv chain   — the paper's motivating example
  * fig3 conv1d       — the paper's scheduling example (II must be 7)

Image arrays are completely partitioned (both dims) which is the paper's
supported ``array_partition`` mode; weights are folded constants (as a
``bind_op``-style simplification).  Op latencies are the paper's
(fp add/sub 5, mul 4, ld/st 1).
"""
from __future__ import annotations

from .ir import Program, ProgramBuilder

# Two storage presets:
#  * "reg":  complete partitioning of both dims (register arrays) — every
#    access parallel; the aggressive design point.
#  * "bram": row-partitioned block RAM with one write + three read ports
#    (port replication), the paper-era design point where consumers contend
#    on memory ports and the port pseudo-dependences bite.
_PRESETS = {
    "reg": dict(partition=(0, 1), ports=("w", "r")),
    "bram": dict(partition=(0,), ports=("w", "r", "r", "r")),
}



# ---------------------------------------------------------------------------


def fig3_conv1d() -> Program:
    b = ProgramBuilder("fig3_conv1d")
    b.array("A", (16,), ports=("w", "r"), is_arg=True)
    b.array("B", (17,), ports=("r",), is_arg=True)
    b.array("W", (2,), ports=("r",), is_arg=True)
    with b.loop("i", 0, 16) as i:
        with b.loop("j", 0, 2) as j:
            acc = b.load("A", i)
            x = b.load("B", i + j)
            w = b.load("W", j)
            s = b.add(acc, b.mul(x, w))
            b.store("A", s, i)
    return b.build()


def fig1_conv_chain(n: int = 8, storage: str = "reg") -> Program:
    """Two chained 2x2 convolutions (the paper's Fig. 1)."""
    b = ProgramBuilder("fig1_conv_chain")
    b.array("image", (n + 2, n + 2), is_arg=True, **_PRESETS[storage])
    b.array("convX", (n + 1, n + 1), **_PRESETS[storage])
    b.array("convY", (n, n), is_arg=True, **_PRESETS[storage])
    w = [[0.25, 0.5], [0.125, 0.0625]]
    for src, dst, tag, extent in (("image", "convX", "p", n + 1),
                                  ("convX", "convY", "c", n)):
        with b.loop(f"{tag}i", 0, extent) as i:
            with b.loop(f"{tag}j", 0, extent) as j:
                prods = []
                for u in range(2):
                    for v in range(2):
                        x = b.load(src, i + u, j + v)
                        prods.append(b.mul(x, b.const(w[u][v])))
                b.store(dst, b.sum_tree(prods), i, j)
    return b.build()


# ---------------------------------------------------------------------------
# benchmark helpers
# ---------------------------------------------------------------------------


def _stencil3x3(b, tag, dst, srcs, weights, H, W, combine="sum"):
    """dst[i][j] = sum_{u,v} w[u][v] * prod(srcs at [i+u][j+v])."""
    with b.loop(f"{tag}i", 0, H) as i:
        with b.loop(f"{tag}j", 0, W) as j:
            prods = []
            for u in range(3):
                for v in range(3):
                    if weights[u][v] == 0.0:
                        continue
                    vals = [b.load(s, i + u, j + v) for s in srcs]
                    term = vals[0]
                    for extra in vals[1:]:
                        term = b.mul(term, extra)
                    if weights[u][v] != 1.0:
                        term = b.mul(term, b.const(weights[u][v]))
                    prods.append(term)
            b.store(dst, b.sum_tree(prods), i, j)


_BOX = [[1.0] * 3 for _ in range(3)]
_GAUSS = [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125], [0.0625, 0.125, 0.0625]]


def unsharp(n: int = 32, storage: str = "reg") -> Program:
    b = ProgramBuilder("unsharp")
    b.array("img", (n + 2, n + 2), is_arg=True, **_PRESETS[storage])
    b.array("bx", (n + 2, n), **_PRESETS[storage])          # blur-x (rows keep padding)
    b.array("by", (n, n), **_PRESETS[storage])
    b.array("sharp", (n, n), **_PRESETS[storage])
    b.array("out", (n, n), is_arg=True, **_PRESETS[storage])
    # blur-x: 3-tap along columns
    with b.loop("bxi", 0, n + 2) as i:
        with b.loop("bxj", 0, n) as j:
            t = [b.mul(b.load("img", i, j + v), b.const(c))
                 for v, c in ((0, 0.25), (1, 0.5), (2, 0.25))]
            b.store("bx", b.sum_tree(t), i, j)
    # blur-y: 3-tap along rows
    with b.loop("byi", 0, n) as i:
        with b.loop("byj", 0, n) as j:
            t = [b.mul(b.load("bx", i + u, j), b.const(c))
                 for u, c in ((0, 0.25), (1, 0.5), (2, 0.25))]
            b.store("by", b.sum_tree(t), i, j)
    # sharpen: (1+w)*img - w*blur   (pointwise, img is a second consumer)
    with b.loop("shi", 0, n) as i:
        with b.loop("shj", 0, n) as j:
            o = b.load("img", i + 1, j + 1)
            g = b.load("by", i, j)
            s = b.sub(b.mul(o, b.const(1.6)), b.mul(g, b.const(0.6)))
            b.store("sharp", s, i, j)
    # mask: out = img + k*(sharp - img)   (multi-consumer on img and sharp)
    with b.loop("mki", 0, n) as i:
        with b.loop("mkj", 0, n) as j:
            o = b.load("img", i + 1, j + 1)
            s = b.load("sharp", i, j)
            d = b.sub(s, o)
            b.store("out", b.add(o, b.mul(d, b.const(0.8))), i, j)
    return b.build()


def harris(n: int = 32, storage: str = "reg") -> Program:
    b = ProgramBuilder("harris")
    b.array("img", (n + 4, n + 4), is_arg=True, **_PRESETS[storage])
    b.array("Ix", (n + 2, n + 2), **_PRESETS[storage])
    b.array("Iy", (n + 2, n + 2), **_PRESETS[storage])
    b.array("Sxx", (n, n), **_PRESETS[storage])
    b.array("Syy", (n, n), **_PRESETS[storage])
    b.array("Sxy", (n, n), **_PRESETS[storage])
    b.array("R", (n, n), is_arg=True, **_PRESETS[storage])
    # gradients (central difference)
    for tag, dst, (du, dv) in (("gx", "Ix", (0, 1)), ("gy", "Iy", (1, 0))):
        with b.loop(f"{tag}i", 0, n + 2) as i:
            with b.loop(f"{tag}j", 0, n + 2) as j:
                p = b.load("img", i + 1 + du, j + 1 + dv)
                m = b.load("img", i + 1 - du, j + 1 - dv)
                b.store(dst, b.mul(b.sub(p, m), b.const(0.5)), i, j)
    # structure tensor: 3x3 window sums of products (multi-consumer Ix, Iy)
    _stencil3x3(b, "sxx", "Sxx", ["Ix", "Ix"], _BOX, n, n)
    _stencil3x3(b, "syy", "Syy", ["Iy", "Iy"], _BOX, n, n)
    _stencil3x3(b, "sxy", "Sxy", ["Ix", "Iy"], _BOX, n, n)
    # response R = det - k * trace^2
    with b.loop("ri", 0, n) as i:
        with b.loop("rj", 0, n) as j:
            xx = b.load("Sxx", i, j)
            yy = b.load("Syy", i, j)
            xy = b.load("Sxy", i, j)
            det = b.sub(b.mul(xx, yy), b.mul(xy, xy))
            tr = b.add(xx, yy)
            r = b.sub(det, b.mul(b.mul(tr, tr), b.const(0.04)))
            b.store("R", r, i, j)
    return b.build()


def dus(n: int = 32, storage: str = "reg") -> Program:
    """Downsample (blur + decimate) then upsample (linear interp), per axis.
    Four loop nests; the window reads break Vitis' same-order rule."""
    b = ProgramBuilder("dus")
    h = n // 2
    b.array("img", (n + 3, n + 3), is_arg=True, **_PRESETS[storage])
    b.array("dx", (n + 3, h + 1), **_PRESETS[storage])   # downsampled along x
    b.array("d", (h + 1, h + 1), **_PRESETS[storage])    # downsampled both axes
    b.array("uy", (n, h + 1), **_PRESETS[storage])       # upsampled along y
    b.array("out", (n, n), is_arg=True, partition=(0, 1), ports=("w",))
    # down-x: dx[i][j] = 0.25*img[i][2j] + 0.5*img[i][2j+1] + 0.25*img[i][2j+2]
    with b.loop("dxi", 0, n + 3) as i:
        with b.loop("dxj", 0, h + 1) as j:
            t = [b.mul(b.load("img", i, j * 2 + v), b.const(c))
                 for v, c in ((0, 0.25), (1, 0.5), (2, 0.25))]
            b.store("dx", b.sum_tree(t), i, j)
    # down-y
    with b.loop("dyi", 0, h + 1) as i:
        with b.loop("dyj", 0, h + 1) as j:
            t = [b.mul(b.load("dx", i * 2 + u, j), b.const(c))
                 for u, c in ((0, 0.25), (1, 0.5), (2, 0.25))]
            b.store("d", b.sum_tree(t), i, j)
    # up-y: even rows copy, odd rows interpolate (two affine stores)
    with b.loop("uyi", 0, h) as i:
        with b.loop("uyj", 0, h + 1) as j:
            a = b.load("d", i, j)
            c = b.load("d", i + 1, j)
            b.store("uy", a, i * 2, j)
            b.store("uy", b.mul(b.add(a, c), b.const(0.5)), i * 2 + 1, j)
    # up-x
    with b.loop("uxi", 0, n) as i:
        with b.loop("uxj", 0, h) as j:
            a = b.load("uy", i, j)
            c = b.load("uy", i, j + 1)
            b.store("out", a, i, j * 2)
            b.store("out", b.mul(b.add(a, c), b.const(0.5)), i, j * 2 + 1)
    return b.build()


def optical_flow(n: int = 32, storage: str = "reg") -> Program:
    """Lucas-Kanade dense optical flow, single scale (§5.1)."""
    b = ProgramBuilder("optical_flow")
    b.array("f1", (n + 4, n + 4), is_arg=True, **_PRESETS[storage])
    b.array("f2", (n + 4, n + 4), is_arg=True, **_PRESETS[storage])
    for nm in ("Ix", "Iy", "It"):
        b.array(nm, (n + 2, n + 2), **_PRESETS[storage])
    for nm in ("Sxx", "Syy", "Sxy", "Sxt", "Syt"):
        b.array(nm, (n, n), **_PRESETS[storage])
    b.array("u", (n, n), is_arg=True, **_PRESETS[storage])
    b.array("v", (n, n), is_arg=True, **_PRESETS[storage])
    # gradients on frame 1 + temporal difference
    for tag, dst, (du, dv) in (("gx", "Ix", (0, 1)), ("gy", "Iy", (1, 0))):
        with b.loop(f"{tag}i", 0, n + 2) as i:
            with b.loop(f"{tag}j", 0, n + 2) as j:
                p = b.load("f1", i + 1 + du, j + 1 + dv)
                m = b.load("f1", i + 1 - du, j + 1 - dv)
                b.store(dst, b.mul(b.sub(p, m), b.const(0.5)), i, j)
    with b.loop("gti", 0, n + 2) as i:
        with b.loop("gtj", 0, n + 2) as j:
            a = b.load("f2", i + 1, j + 1)
            c = b.load("f1", i + 1, j + 1)
            b.store("It", b.sub(a, c), i, j)
    # window sums (products folded into the window nests; multi-consumer)
    _stencil3x3(b, "sxx", "Sxx", ["Ix", "Ix"], _BOX, n, n)
    _stencil3x3(b, "syy", "Syy", ["Iy", "Iy"], _BOX, n, n)
    _stencil3x3(b, "sxy", "Sxy", ["Ix", "Iy"], _BOX, n, n)
    _stencil3x3(b, "sxt", "Sxt", ["Ix", "It"], _BOX, n, n)
    _stencil3x3(b, "syt", "Syt", ["Iy", "It"], _BOX, n, n)
    # solve the 2x2 system per pixel
    with b.loop("svi", 0, n) as i:
        with b.loop("svj", 0, n) as j:
            xx = b.load("Sxx", i, j)
            yy = b.load("Syy", i, j)
            xy = b.load("Sxy", i, j)
            xt = b.load("Sxt", i, j)
            yt = b.load("Syt", i, j)
            det = b.sub(b.mul(xx, yy), b.mul(xy, xy))
            un = b.sub(b.mul(xy, yt), b.mul(yy, xt))
            vn = b.sub(b.mul(xy, xt), b.mul(xx, yt))
            b.store("u", b.div(un, det), i, j)
            b.store("v", b.div(vn, det), i, j)
    return b.build()


def two_mm(m: int = 8, storage: str = "reg") -> Program:
    """tmp = A@B ; D = tmp@C — both written to function arguments, so Vitis
    dataflow is inapplicable even after SPSC conversion (§5.2)."""
    b = ProgramBuilder("two_mm")
    b.array("A", (m, m), is_arg=True, ports=("r", "r"))
    b.array("B", (m, m), is_arg=True, ports=("r", "r"))
    b.array("C", (m, m), is_arg=True, ports=("r", "r"))
    b.array("tmp", (m, m), is_arg=True, ports=("w", "r"))   # pre-zeroed arg
    b.array("D", (m, m), is_arg=True, ports=("w", "r"))     # pre-zeroed arg
    for tag, (x, w, dst) in (("p", ("A", "B", "tmp")), ("c", ("tmp", "C", "D"))):
        with b.loop(f"{tag}i", 0, m) as i:
            with b.loop(f"{tag}j", 0, m) as j:
                with b.loop(f"{tag}k", 0, m) as k:
                    acc = b.load(dst, i, j)
                    prod = b.mul(b.load(x, i, k), b.load(w, k, j))
                    b.store(dst, b.add(acc, prod), i, j)
    return b.build()


# ---------------------------------------------------------------------------
# Mismatched-bounds producer-consumer chains (shift-and-peel fusion targets).
#
# Each is a two-nest chain whose consumer nest has strictly smaller (or
# stride-scaled) bounds than its producer, so equal-bounds fusion cannot
# apply — the shapes the paper's Fig. 1-3 motivating example is made of.
# ---------------------------------------------------------------------------


def blur_chain(n: int = 32, storage: str = "reg", taps: int = 3) -> Program:
    """blur-x -> blur-y (the paper's motivating stencil chain): the producer
    covers ``n + taps - 1`` rows, the consumer ``n`` — fusing needs a
    consumer shift of ``taps - 1`` rows and a peeled prologue."""
    b = ProgramBuilder("blur_chain")
    m = n + taps - 1
    w = [1.0 / (2 ** abs(t - (taps - 1) // 2) + 1) for t in range(taps)]
    b.array("img", (m, m), is_arg=True, **_PRESETS[storage])
    b.array("bx", (m, n), **_PRESETS[storage])
    b.array("by", (n, n), is_arg=True, **_PRESETS[storage])
    with b.loop("bxi", 0, m) as i:
        with b.loop("bxj", 0, n) as j:
            t = [b.mul(b.load("img", i, j + v), b.const(w[v]))
                 for v in range(taps)]
            b.store("bx", b.sum_tree(t), i, j)
    with b.loop("byi", 0, n) as i:
        with b.loop("byj", 0, n) as j:
            t = [b.mul(b.load("bx", i + u, j), b.const(w[u]))
                 for u in range(taps)]
            b.store("by", b.sum_tree(t), i, j)
    return b.build()


def conv_pool(n: int = 32, storage: str = "reg") -> Program:
    """3x3 conv then 2x2 max-pool (stride 2): the consumer runs at HALF the
    producer's rate (index coefficient 2), so the legal shift is n/2 and the
    fused core interleaves one pool row per conv row."""
    assert n % 2 == 0, n
    h = n // 2
    b = ProgramBuilder("conv_pool")
    b.array("img", (n + 2, n + 2), is_arg=True, **_PRESETS[storage])
    b.array("conv", (n, n), **_PRESETS[storage])
    b.array("pool", (h, h), is_arg=True, **_PRESETS[storage])
    _stencil3x3(b, "cv", "conv", ["img"], _GAUSS, n, n)
    with b.loop("pli", 0, h) as i:
        with b.loop("plj", 0, h) as j:
            vals = [b.load("conv", i * 2 + u, j * 2 + v)
                    for u in range(2) for v in range(2)]
            m = vals[0]
            for v in vals[1:]:
                m = b.arith("max", m, v)
            b.store("pool", m, i, j)
    return b.build()


def gradient_harris(n: int = 32, storage: str = "reg") -> Program:
    """Gradient field then a 3x3-window Harris-style response: the gradient
    nest covers ``(n+2)^2``, the response ``n^2`` — a two-level shift of
    (2, 2) with peeled prologues at both levels."""
    b = ProgramBuilder("gradient_harris")
    b.array("img", (n + 4, n + 4), is_arg=True, **_PRESETS[storage])
    b.array("G", (n + 2, n + 2), **_PRESETS[storage])
    b.array("R", (n, n), is_arg=True, **_PRESETS[storage])
    with b.loop("gi", 0, n + 2) as i:
        with b.loop("gj", 0, n + 2) as j:
            gx = b.sub(b.load("img", i + 1, j + 2), b.load("img", i + 1, j))
            gy = b.sub(b.load("img", i + 2, j + 1), b.load("img", i, j + 1))
            b.store("G", b.mul(b.add(gx, gy), b.const(0.5)), i, j)
    with b.loop("ri", 0, n) as i:
        with b.loop("rj", 0, n) as j:
            terms = [b.load("G", i + u, j + v)
                     for u in range(3) for v in range(3)]
            s = b.sum_tree(terms)
            q = b.sum_tree([b.mul(t, t) for t in terms])
            b.store("R", b.sub(q, b.mul(b.mul(s, s), b.const(0.04))), i, j)
    return b.build()


def correlated_chain(n: int = 32, storage: str = "reg") -> Program:
    """Producer/consumer with CORRELATED access distances: the consumer
    reads ``mid`` at (i+2, j) and (i, j+5), so the dependence-distance
    vectors are (2, 0) and (0, 5).  The lexicographic-minimum legal shift
    is their lex-maximum (2, 0); per-level componentwise maxima would
    overshoot to (2, 5), delaying every row by five columns and peeling
    five producer columns per row for nothing — the regression this chain
    pins (ROADMAP: lexicographic-minimum fusion shift)."""
    b = ProgramBuilder("correlated_chain")
    b.array("img", (n + 3, n + 6), is_arg=True, **_PRESETS[storage])
    b.array("mid", (n + 2, n + 5), **_PRESETS[storage])
    b.array("out", (n, n), is_arg=True, **_PRESETS[storage])
    with b.loop("mi", 0, n + 2) as i:
        with b.loop("mj", 0, n + 5) as j:
            v = b.add(b.load("img", i, j), b.load("img", i + 1, j + 1))
            b.store("mid", b.mul(v, b.const(0.5)), i, j)
    with b.loop("oi", 0, n) as i:
        with b.loop("oj", 0, n) as j:
            a = b.load("mid", i + 2, j)
            c = b.load("mid", i, j + 5)
            d = b.sub(b.mul(a, b.const(0.75)), b.mul(c, b.const(0.25)))
            b.store("out", d, i, j)
    return b.build()


BENCHMARKS = {
    "unsharp": unsharp,
    "harris": harris,
    "dus": dus,
    "optical_flow": optical_flow,
    "two_mm": two_mm,
}

# Mismatched-bounds stencil chains: the shift-and-peel fusion benchmark set
# (kept out of BENCHMARKS so the paper-figure tables stay comparable across
# PRs; benchmarks/run.py records them in BENCH_fusion.json).
CHAIN_BENCHMARKS = {
    "blur_chain": blur_chain,
    "conv_pool": conv_pool,
    "gradient_harris": gradient_harris,
    "correlated_chain": correlated_chain,
}
