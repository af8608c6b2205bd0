"""The port's copies of ``core/pipeline_ilp.py`` and ``core/overlap.py``
against the reference's, on the cases ``tests/test_pipeline_ilp.py`` uses:
the same schedules, field for field."""
import dataclasses

import pytest

from repro.core import overlap as ref_overlap
from repro.core import pipeline_ilp as ref_pp
from repro_torch.core import overlap, pipeline_ilp as pp


@pytest.fixture(autouse=True)
def _port_fault_free():
    from repro_torch.core import faults
    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("args,kw", [
    ((4, 8), dict(t_f=1, t_b=2)),
    ((4, 6), dict(t_f=1, t_b=2)),
    ((3, 6), dict(t_f=2, t_b=2)),
    ((4, 8), dict(t_f=1, backward=False)),
    ((4, 16), dict(t_f=1, t_b=2)),
    ((5, 6), dict(t_f=1, backward=False, cross_from=1)),
    ((4, 8), dict(t_f=2, t_b=4)),
])
def test_synthesize_equals_reference(args, kw):
    got = dataclasses.asdict(pp.synthesize(*args, **kw))
    assert got == dataclasses.asdict(ref_pp.synthesize(*args, **kw))


def test_synthesize_interleaved_equals_reference():
    got = pp.synthesize_interleaved(4, 2, 8, t_f=1, t_b=2)
    want = ref_pp.synthesize_interleaved(4, 2, 8, t_f=1, t_b=2)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("args", [(4, 8), (4, 16, 1, 2), (5, 6, 1, 0),
                                  (3, 6, 2, 2)])
def test_latency_baselines_equal_reference(args):
    assert pp.sequential_latency(*args) == ref_pp.sequential_latency(*args)
    assert pp.gpipe_latency(*args) == ref_pp.gpipe_latency(*args)


@pytest.mark.parametrize("n,kw", [(8, {}), (8, dict(send_ticks=2,
                                                     mm_ticks=1))])
def test_ring_overlap_equals_reference(n, kw):
    got = overlap.plan_ring_overlap(n, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_overlap.plan_ring_overlap(n, **kw))
