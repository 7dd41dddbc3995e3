"""repro_torch.ft.straggler against repro.ft.straggler.

Mirrors ``tests/test_ft_straggler.py`` on the port (``device="cpu"``, the
segment-sum lane): worker step-rate offsets ±50,000 ppm on adjacent ring
nodes, 100 s at 10 steps/s, both controller branches (PI with ki > 0 and
proportional with ki = 0) and the queue-depth flag in both directions.

Then every ``StragglerReport`` field is held to the reference's on the
same inputs.  The offsets are large (±5 %), so a bar in absolute ppm
(``FREQ_ATOL_PPM`` = 1e-6) cannot hold in float32: the two packages round
the same sums in different orders (XLA contracts ``a + b·c``), one ulp
per step, adding up like a random walk.  So each field is held to √steps
float32 ulps of its scale: the queue peaks (frames) of the reference's
peak, the final rate spread (a difference of two rates) to twice that of
the largest offset (relative units), the throughput ratio to √steps ulps
of the largest offset; ``bounded`` exactly.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.ft.straggler as ref_ft  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch.ft import StragglerReport, simulate_stragglers  # noqa: E402

SPEED = np.array([50_000.0, -50_000.0, 0.0, 0.0])  # ±5% on neighbors
SPS = 10.0
DURATION = 100.0
STEPS = int(DURATION * SPS)


def _ulps(scale: float) -> float:
    """√steps float32 ulps at ``scale``."""
    return np.sqrt(STEPS) * float(np.spacing(np.float32(abs(scale))))


@pytest.fixture(scope="module", params=[5e-5, 0.0], ids=["pi", "prop"])
def report(request):
    return request.param, simulate_stragglers(
        tc.ring(4), SPEED, queue_depth=512, steps_per_second=SPS,
        duration_s=DURATION, kp=5e-3, ki=request.param, device="cpu")


def test_uncontrolled_peak_matches_hand_computation(report):
    """kp=0 queue growth = Δν_rel · steps_per_second · duration."""
    _, rep = report
    expected = 0.1 * SPS * DURATION  # 100 microbatches
    assert rep.uncontrolled_queue_peak == pytest.approx(expected, rel=0.02)


def test_controlled_queue_stays_small_and_bounded(report):
    _, rep = report
    assert isinstance(rep, StragglerReport)
    assert rep.controlled_queue_peak < 10.0  # vs ~100 uncontrolled
    assert rep.controlled_queue_peak < rep.uncontrolled_queue_peak / 5
    assert rep.bounded  # peak well within depth/2 = 256


def test_rate_spread_collapses(report):
    """Controlled workers agree on a common step rate (±5% at t=0)."""
    _, rep = report
    assert rep.rate_spread_final < 1e-3  # relative; started at 1e-1


def test_throughput_ratio_is_consensus_over_mean(report):
    """Symmetric offsets ⇒ consensus ≈ mean ⇒ ratio ≈ 1."""
    _, rep = report
    assert rep.throughput_ratio == pytest.approx(1.0, abs=5e-3)


def test_integral_term_tightens_queue_peak():
    """Beyond-paper PI branch: ki>0 drives queues back toward the
    setpoint, so its peak is no worse than pure proportional."""
    kw = dict(queue_depth=512, steps_per_second=SPS, duration_s=DURATION,
              kp=5e-3, device="cpu")
    pi = simulate_stragglers(tc.ring(4), SPEED, ki=5e-5, **kw)
    prop = simulate_stragglers(tc.ring(4), SPEED, ki=0.0, **kw)
    assert pi.controlled_queue_peak <= prop.controlled_queue_peak


def test_bounded_flag_respects_queue_depth():
    """Same dynamics, tiny buffers: the bound must report False."""
    rep = simulate_stragglers(tc.ring(4), SPEED, queue_depth=8,
                              steps_per_second=SPS, duration_s=DURATION,
                              kp=5e-3, ki=0.0, device="cpu")
    assert rep.controlled_queue_peak > 8 / 2
    assert not rep.bounded


@pytest.mark.parametrize("ki,depth", [(5e-5, 512), (0.0, 512), (0.0, 8)],
                         ids=["pi", "prop", "prop_tiny_buffers"])
def test_report_fields_match_reference(ki, depth):
    kw = dict(queue_depth=depth, steps_per_second=SPS, duration_s=DURATION,
              kp=5e-3, ki=ki)
    ref = ref_ft.simulate_stragglers(rc.ring(4), SPEED, **kw)
    port = simulate_stragglers(tc.ring(4), SPEED, device="cpu", **kw)
    rate = float(np.abs(SPEED).max()) * 1e-6
    assert abs(port.controlled_queue_peak - ref.controlled_queue_peak) \
        <= _ulps(ref.controlled_queue_peak)
    assert abs(port.uncontrolled_queue_peak - ref.uncontrolled_queue_peak) \
        <= _ulps(ref.uncontrolled_queue_peak)
    assert abs(port.rate_spread_final - ref.rate_spread_final) \
        <= 2 * _ulps(rate)
    assert abs(port.throughput_ratio - ref.throughput_ratio) <= _ulps(rate)
    assert port.bounded == ref.bounded
