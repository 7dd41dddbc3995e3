"""The port's ``sched.pipeline`` plan arithmetic against the JAX
package's: mirrors of ``tests/test_sched_pipeline.py``'s five tests, each
plan's makespan, bubble fraction, events and bounded flag equal to
``repro.sched.plan``'s on the same timetable.  ``pipeline_apply`` runs
on gloo ranks in ``tests/test_torch_distributed.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.schedule import (  # noqa: E402
    LogicalSynchronyNetwork as RefLSN)
from repro.core.topology import line as ref_line  # noqa: E402
from repro.sched.pipeline import plan as ref_plan  # noqa: E402

from repro_torch.core.schedule import LogicalSynchronyNetwork  # noqa: E402
from repro_torch.core.topology import line  # noqa: E402
from repro_torch.sched import plan  # noqa: E402


def both(n, lam_ticks=1, **kw):
    """The port's plan on a line of n stages with unit-free latency
    ``lam_ticks``, held to the reference's."""
    topo = line(n)
    p = plan(LogicalSynchronyNetwork(
        topo, np.full(topo.num_edges, lam_ticks, np.int64)), **kw)
    rtopo = ref_line(n)
    r = ref_plan(RefLSN(rtopo, np.full(rtopo.num_edges, lam_ticks,
                                       np.int64)), **kw)
    assert p.makespan_ticks == r.makespan_ticks
    assert p.bubble_fraction == r.bubble_fraction
    assert p.bounded == r.bounded
    assert (p.num_stages, p.num_microbatches, p.queue_depth_frames) == (
        r.num_stages, r.num_microbatches, r.queue_depth_frames)
    assert [(e.src, e.dst, e.send_tick, e.recv_tick, e.frames, e.tag)
            for e in p.schedule.events] == [
        (e.src, e.dst, e.send_tick, e.recv_tick, e.frames, e.tag)
        for e in r.schedule.events]
    return p


def test_single_stage_plan():
    """S=1: no transfers, zero bubble; makespan is the serial fwd fill
    followed by the bwd chain: fwd_ticks + M·bwd_ticks."""
    p = both(1, stages=(0,), num_microbatches=3, fwd_ticks=2, bwd_ticks=3,
             activation_frames=0)
    assert p.bubble_fraction == 0.0
    assert p.schedule.events == []
    assert p.makespan_ticks == 11
    assert p.bounded


def test_fewer_microbatches_than_stages():
    """S=4, M=2, λ=1, fwd=bwd=1, zero activation frames: fwd drains at
    tick 8, bwd at tick 15."""
    p = both(4, stages=(0, 1, 2, 3), num_microbatches=2, fwd_ticks=1,
             bwd_ticks=1, activation_frames=0)
    assert p.bubble_fraction == pytest.approx(3 / 5)
    assert p.makespan_ticks == 15
    assert len(p.schedule.events) == 2 * (4 - 1) * 2
    assert {e.tag for e in p.schedule.events} == {"fwd0", "fwd1", "bwd0",
                                                  "bwd1"}


def test_bubble_fraction_shrinks_with_more_microbatches():
    """GPipe (S-1)/(S-1+M): monotone in M, → 0 as M → ∞."""
    fracs = [both(2, stages=(0, 1), num_microbatches=m, fwd_ticks=1,
                  bwd_ticks=1, activation_frames=0).bubble_fraction
             for m in (1, 2, 8, 30)]
    assert fracs[0] == pytest.approx(1 / 2)
    assert fracs[-1] == pytest.approx(1 / 31)
    assert all(a > b for a, b in zip(fracs, fracs[1:]))


def test_makespan_grows_with_logical_latency():
    """λ enters every hop of the timetable: scaling λ lengthens the
    makespan."""
    kw = dict(stages=(0, 1, 2), num_microbatches=4, fwd_ticks=2,
              bwd_ticks=2, activation_frames=1)
    fast = both(3, lam_ticks=1, **kw)
    slow = both(3, lam_ticks=7, **kw)
    assert slow.makespan_ticks > fast.makespan_ticks


def test_bounded_flag_tracks_queue_depth():
    """The same timetable is schedulable with deep buffers and not with
    buffers smaller than one activation transfer."""
    kw = dict(stages=(0, 1, 2, 3), num_microbatches=3, fwd_ticks=1,
              bwd_ticks=1, activation_frames=4)
    deep = both(4, queue_depth_frames=1 << 16, **kw)
    shallow = both(4, queue_depth_frames=3, **kw)
    assert deep.bounded
    assert not shallow.bounded
    assert deep.makespan_ticks == shallow.makespan_ticks
