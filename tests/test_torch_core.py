"""Independence and fork guards for the PyTorch port's compiler.

``repro_torch.core`` keeps its own copy of ``repro.core``'s pure-Python
modules (the port may import nothing of the JAX package).  These tests pin
the copy to the reference: the same programs must give the same Pareto
frontiers, knee schedules and pinned seed schedules, and a schedule packed
by the reference must rehydrate in the port.  A change to one side's
algorithms that is not made in the other fails here.
"""
import ast
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.core import cache as ref_cache
from repro.core import hls as ref_hls
from repro.core import programs as ref_programs
from repro_torch.core import analysis, cache, hls, programs, sim
from repro_torch.core.autotune import compile_program
from repro_torch.core.dataflow import RESOURCE_KEYS
from repro_torch.kernels.stencil_pipeline import restricted_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHAINS = sorted(programs.CHAIN_BENCHMARKS)

# copies of tests/test_sched_regression.py's seed-captured schedules
SEED_FIG3 = dict(iis={"i": 14, "j": 7}, theta=[0, 0, 4, 0, 0, 1, 5, 10])

SEED_UNSHARP8 = dict(
    iis={"bxi": 8, "bxj": 1, "byi": 8, "byj": 1,
         "shi": 8, "shj": 1, "mki": 8, "mkj": 1},
    theta=[0, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 5, 10, 15, 0, 0, 18, 19, 19,
           25, 26, 26, 32, 33, 33, 30, 37, 42, 0, 0, 10, 43, 11, 11, 44,
           44, 48, 53, 0, 0, 54, 54, 55, 60, 60, 64, 69])


@pytest.fixture(autouse=True)
def _port_fault_free():
    """tests/conftest.py resets only repro's fault harness; reset the
    port's copy around every test too."""
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


@functools.lru_cache(maxsize=None)
def _compiled(name: str, side: str, default_spec: bool = False):
    h, progs = (ref_hls, ref_programs) if side == "ref" else (hls, programs)
    p = progs.CHAIN_BENCHMARKS[name](8, storage="bram")
    if default_spec:
        return h.compile(p)
    return h.compile(p, **restricted_spec(h))   # the stencil sweep's


def _point(c) -> tuple:
    return (c.desc, c.latency, tuple(c.res[k] for k in RESOURCE_KEYS))


def _positional(s) -> tuple:
    """A schedule by walk position: loop IIs, then every node's theta
    (either package's schedule: loops are matched by class name)."""
    nodes = [n for n, _ in s.program.walk()]
    return ([s.iis[n.uid] for n in nodes if type(n).__name__ == "Loop"],
            [s.theta[n.uid] for n in nodes])


# ---------------------------------------------------------------------------
# independence
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels.stencil_pipeline, "
            "repro_torch.core.frontend, repro_torch.core.pipeline_ilp, "
            "repro_torch.core.overlap\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


# ---------------------------------------------------------------------------
# compiler parity against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CHAINS)
def test_frontier_and_knee_equal_reference(name):
    r, q = _compiled(name, "ref"), _compiled(name, "port")
    assert [_point(c) for c in q.frontier] == [_point(c) for c in r.frontier]
    assert _point(q.best) == _point(r.best)
    kr, kq = r.knee("latency", "bram"), q.knee("latency", "bram")
    assert kq.desc == kr.desc
    assert _positional(kq.schedule) == _positional(kr.schedule)


def test_default_spec_blur_chain_equals_reference():
    r = _compiled("blur_chain", "ref", default_spec=True)
    q = _compiled("blur_chain", "port", default_spec=True)
    assert [_point(c) for c in q.frontier] == [_point(c) for c in r.frontier]
    assert _point(q.best) == _point(r.best)
    assert _positional(q.best.schedule) == _positional(r.best.schedule)


def test_fig3_schedule_matches_seed():
    p = programs.fig3_conv1d()
    s = compile_program(p)
    assert {l.ivname: s.iis[l.uid] for l in p.loops()} == SEED_FIG3["iis"]
    assert [s.theta[n.uid] for n, _ in p.walk()] == SEED_FIG3["theta"]


def test_unsharp_stencil_schedule_matches_seed():
    p = programs.unsharp(8)
    s = compile_program(p)
    assert {l.ivname: s.iis[l.uid] for l in p.loops()} == SEED_UNSHARP8["iis"]
    assert [s.theta[n.uid] for n, _ in p.walk()] == SEED_UNSHARP8["theta"]


@pytest.mark.parametrize("name", CHAINS)
def test_lint_clean_and_winner_validates(name):
    p = programs.CHAIN_BENCHMARKS[name](8, storage="bram")
    assert [d for d in analysis.lint(p) if d.severity == "error"] == []
    knee = _compiled(name, "port").knee("latency", "bram")
    v = analysis.validate_static(knee.program, knee.schedule)
    assert v.ok, v


# ---------------------------------------------------------------------------
# state carried across: a schedule packed by the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CHAINS)
def test_reference_schedule_unpacks_in_port(name):
    kr = _compiled(name, "ref").knee("latency", "bram")
    kq = _compiled(name, "port").knee("latency", "bram")
    blob = json.loads(json.dumps(ref_cache.pack_schedule(kr.schedule)))
    s = cache.unpack_schedule(kq.program, blob)
    assert cache.pack_schedule(s) == cache.pack_schedule(kq.schedule)
    assert _positional(s) == _positional(kq.schedule)
    assert sim.validate_schedule(kq.program, s) == []
