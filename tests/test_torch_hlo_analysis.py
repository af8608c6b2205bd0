"""The port's graph cost analyzer (``repro_torch.launch.hlo_analysis``)
beside the reference's HLO-text analyzer: the four cases of
``tests/test_hlo_analysis.py`` run through both on the same shapes (the
JAX function's compiled text, the torch function's ``make_fx`` graph);
collective bytes by kind on a fake group's graph; K4 and K5 counted by
their formulas; ``peak_live_bytes`` on hand-built chains."""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._higher_order_ops.scan import scan
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro.launch import hlo_analysis as jha
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()
    assert not dist.is_initialized()


def _jax(fn, *shapes):
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    return jha.analyze(jax.jit(fn).lower(*args).compile().as_text())


def _torch(fn, *shapes):
    return ha.analyze(_graph(fn, *shapes))


def _graph(fn, *shapes):
    return make_fx(fn, tracing_mode="fake")(*(torch.zeros(s)
                                               for s in shapes))


def test_dot_flops_exact_matmul():
    want = 2 * 64 * 128 * 32
    assert _jax(lambda x, y: x @ y, (64, 128), (128, 32))["flops"] == want
    assert _torch(lambda x, y: x @ y, (64, 128), (128, 32))["flops"] == want


def test_batched_dot_contraction():
    want = 2 * 2 * 8 * 32 * 4
    shapes = ((2, 8, 32), (2, 32, 4))
    assert _jax(lambda x, y: jnp.einsum("bij,bjk->bik", x, y),
                *shapes)["flops"] == want
    assert _torch(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                  *shapes)["flops"] == want


def _torch_scan(w, x):
    def body(h, wi):
        h = torch.tanh(h @ wi)
        return h, h.clone()
    return scan(body, x, w)[0]


def _torch_loop(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


@pytest.mark.parametrize("form", ["scan", "loop"])
def test_scan_trip_count_multiplies(form):
    """The JAX scan's trip count from its while loop's condition; the
    port's ``torch._higher_order_ops.scan`` body times its inputs' leading
    dim, recorded in ``trips``; an unrolled loop the same flops."""
    want = 8 * 2 * 4 * 16 * 16
    shapes = ((8, 16, 16), (4, 16))

    def jfn(w, x):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, x, w)[0]
    ref = _jax(jfn, *shapes)
    assert 8 in ref["trips"].values() and ref["flops"] == want
    got = _torch(_torch_scan if form == "scan" else _torch_loop, *shapes)
    assert got["flops"] == want
    if form == "scan":
        assert got["trips"] == {"scan_combine_graph_0": 8}
        body = got["per_comp"]["scan_combine_graph_0"]
        assert body["mult"] == 8 and body["flops"] == 2 * 4 * 16 * 16
        assert got["per_comp"]["entry"]["flops"] == 0
    else:
        assert got["trips"] == {} and list(got["per_comp"]) == ["entry"]


def test_bytes_counted_for_copies():
    want = 2 * 1024 * 4                  # at least read + write
    assert _jax(lambda v: v * 2.0 + 1.0, (1024,))["bytes"] >= want
    got = _torch(lambda v: v * 2.0 + 1.0, (1024,))
    assert got["bytes"] >= want
    # two elementwise passes, each reading and writing 4 KB
    assert got["bytes"] == 2 * want


def test_views_are_free_and_slices_charge_their_window():
    x = (64, 256)
    assert _torch(lambda v: v.t()[:16].unsqueeze(0).expand(2, 16, 64),
                  x)["bytes"] == 0
    # a gather reads and writes its window: 8 rows of 256 floats
    gm = make_fx(lambda v, i: v[i], tracing_mode="fake")(
        torch.zeros(x), torch.arange(8))
    assert ha.analyze(gm)["bytes"] == 2 * 8 * 256 * 4


def test_collective_bytes_by_kind_on_a_fake_group():
    """Each ``_c10d_functional`` collective counts its result bytes under
    its kind; its ``wait_tensor`` is in the graph and not counted."""
    n, shape = 4, (8, 16)               # 512 bytes a rank

    def fn(x):
        c10d, g = torch.ops._c10d_functional, dist.group.WORLD.group_name
        return [c10d.wait_tensor(t) for t in (
            c10d.all_gather_into_tensor(x, n, g),
            c10d.all_reduce(x, "sum", g),
            c10d.reduce_scatter_tensor(x, "sum", n, g),
            c10d.all_to_all_single(x, [2] * n, [2] * n, g))]
    with dryrun.dryrun_mesh((n,), ("data",)):
        gm = _graph(fn, shape)
    kinds = {str(nd.target) for nd in gm.graph.nodes}
    assert "_c10d_functional.wait_tensor.default" in kinds
    got = ha.analyze(gm)["collective_bytes"]
    assert got == {"all-gather": n * 512, "all-reduce": 512,
                   "reduce-scatter": 512 // n, "all-to-all": 512}


def test_k4_and_k5_nodes_count_by_their_formulas():
    """Under a trace the kernels are one operator node each, counted by
    PERF.md's formulas: K4 4 hd a kept score (its backward 10 hd), K5 5 a
    state entry and token (its backward 14)."""
    B, H, Hkv, S, hd = 1, 4, 2, 128, 64
    kept = S * (S + 1) // 2

    def attn(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o.sum(), (q, k, v))
    gm = _graph(attn, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    ops = [str(n.target) for n in gm.graph.nodes
           if str(n.target).startswith("repro_torch.")]
    assert ops == ["repro_torch.flash_attention_lse.default",
                   "repro_torch.flash_attention_bwd.default"]
    assert ha.analyze(gm)["flops"] == (4 + 10) * hd * kept * B * H

    Bw, Hw, Sw, hw = 2, 3, 64, 16

    def wkv(r, k, v, w, u):
        xs = [t.requires_grad_() for t in (r, k, v)]
        out, _ = wk.wkv6_state(*xs, w, u)
        return torch.autograd.grad(out.sum(), xs)
    big = (Bw, Hw, Sw, hw)
    gm = _graph(wkv, big, big, big, big, (Hw, hw))
    ops = [str(n.target) for n in gm.graph.nodes
           if str(n.target).startswith("repro_torch.")]
    assert ops == ["repro_torch.wkv6.default", "repro_torch.wkv6_bwd.default"]
    assert ha.analyze(gm)["flops"] == (5 + 14) * Bw * Hw * Sw * hw * hw
    # without grad K5 writes out= and s_out= in place: no result of its own
    gm = _graph(lambda r, k, v, w, u: wk.wkv6_state(r, k, v, w, u), big, big,
                big, big, (Hw, hw))
    node = next(n for n in gm.graph.nodes if str(n.target).startswith(
        "repro_torch."))
    assert ha.node_flops(node) == 5 * Bw * Hw * Sw * hw * hw
    # it reads r, k, v, w, u and writes out and the state once each (f32)
    N = Bw * Hw * Sw * hw
    assert ha.node_bytes(node) == 4 * (5 * N + Hw * hw + Bw * Hw * hw * hw)


def test_peak_live_bytes_on_hand_built_chains():
    """Each result lives from its definition to its last use; views,
    in-place writes and ``getitem`` extend their base; the arguments and
    the outputs are not counted."""
    def chain(x):
        a = x * 2                       # 4000
        b = x[:500] * 3                 # 2000 (a view of x, then a result)
        c = a + 1                       # 4000: a's last use
        d = torch.cat([c, b])           # 6000: b's and c's last use
        return d.sum()
    gm = _graph(chain, (1000,))
    assert ha.peak_live_bytes(gm) == 2000 + 4000 + 6000

    def aliased(x):
        a = x * 2                       # 4000
        v = a.view(10, 100)             # a view: a lives on through it
        s = torch.split(x, 500)         # views of the argument: free
        b = s[0] + 1                    # 2000
        v.mul_(b.sum())                 # in place: a lives to here
        return x + 1                    # an output: not counted
    gm = _graph(aliased, (1000,))
    sizes = {"a": 4000, "b": 2000, "sum": 4}
    # at ``sum``: a, b and its own result; at ``mul_``: a and the sum
    assert ha.peak_live_bytes(gm) == sizes["a"] + sizes["b"] + sizes["sum"]


def test_fake_tensors_reach_the_fake_implementations_alone(monkeypatch):
    """Under FakeTensorMode the wrappers neither run the plain versions
    nor launch: the operators' fake implementations give the shapes."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on FakeTensors")
    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(fa, name, refuse)
    for name in ("wkv6_chunked_plain", "wkv6_bwd_windowed_plain",
                 "wkv6_bwd_chunked_plain"):
        monkeypatch.setattr(wk, name, refuse)
    n0 = sum(fa.LAUNCHES.values()) + sum(wk.LAUNCHES.values())
    with FakeTensorMode():
        q = torch.empty((1, 4, 256, 64), dtype=torch.bfloat16,
                        device="cuda" if torch.backends.cuda.is_built()
                        else "cpu").requires_grad_()
        o = fa.flash_attention(q, q[:, :2], q[:, :2])
        (dq,) = torch.autograd.grad(o.sum(), (q,))
        r = torch.empty((2, 3, 64, 64), device=q.device)
        out, s = wk.wkv6_state(r, r, r, r, torch.empty((3, 64),
                                                       device=q.device))
    assert o.shape == dq.shape == q.shape and o.dtype == torch.bfloat16
    assert out.shape == r.shape and s.shape == (2, 3, 64, 64)
    assert sum(fa.LAUNCHES.values()) + sum(wk.LAUNCHES.values()) == n0
