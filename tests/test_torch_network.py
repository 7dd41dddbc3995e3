"""The port's paper facade against repro.core's.

``BittideNetwork`` (sync, run_scenario), the logical-latency tables, the
AOT schedules, the bit-faithful DDC counters and the frame-level oracle
of ``repro_torch.core`` run the same inputs as ``repro.core``'s, made
with numpy from a seed; the port runs with ``device="cpu"``.

Tolerances: the DDC functions, the latency tables, the schedules and the
frame-level oracle (integer or numpy arithmetic copied as it is) are
held exactly.  ``sync`` runs the segment-sum lane on both sides, so its
frequency records are held to ``FREQ_ATOL_PPM`` and the logical
synchrony network it returns (integers) exactly.  The cable swap through
``BittideNetwork.run_scenario`` on the port's per-step lane is held to
the reference's segment-sum lane at the float32 floor of ROADMAP §3
(``chip_smoke.float32_floor_ppm``), with the RTT shift exactly equal.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import FREQ_ATOL_PPM, assert_freq_parity  # noqa: E402
from repro.core import ddc as rddc  # noqa: E402
from repro.core import frame_level as rfl  # noqa: E402
from repro.core import latency as rlat  # noqa: E402
from repro.core import schedule as rsched  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.core import frame_level as tfl  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

U64_MAX = (1 << 64) - 1
_rng = np.random.default_rng(11)
# Edge values (0, 2^32 - 1, 2^32, 2^63, 2^64 - 1) and random draws.
U64S = [0, 1, 2**32 - 1, 2**32, 2**63, U64_MAX] + [
    int(x) for x in _rng.integers(0, 2**63, 6, dtype=np.int64) * 2 + 1]
U32S = [0, 1, 2**31 - 1, 2**31, 2**32 - 1] + [
    int(x) for x in _rng.integers(0, 2**32, 5, dtype=np.int64)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _u64(value):
    return tddc.u64(value, device="cpu")


# ----------------------------------------------------------------- DDC

@pytest.mark.parametrize("a", U64S)
def test_u64_add_sub_equal_reference(a):
    for b in U64S:
        for op in ("u64_add", "u64_sub"):
            got = tddc.u64_to_int(getattr(tddc, op)(_u64(a), _u64(b)))
            want = rddc.u64_to_int(getattr(rddc, op)(rddc.u64(a),
                                                     rddc.u64(b)))
            assert got == want == ((a + b) if op == "u64_add"
                                   else (a - b)) & U64_MAX


@pytest.mark.parametrize("x", U32S)
def test_gray_equal_reference(x):
    g = tddc.gray_encode(torch.tensor(x))
    assert int(g) == int(rddc.gray_encode(jnp.uint32(x)))
    assert int(tddc.gray_decode(g)) == x
    g1 = int(tddc.gray_encode(torch.tensor((x + 1) & 0xFFFFFFFF)))
    assert bin(int(g) ^ g1).count("1") == 1


@pytest.mark.parametrize("delta", [0, 1, -1, 2**31 - 1, -(2**31) + 1,
                                   2**31, -(2**31), 2**32 + 5])
def test_occupancy_s32_equal_reference(delta):
    """Exact within ±2^31, wrapping beyond it — bit for bit the
    reference's truncation."""
    for rx in (0, 2**32 - 3, 2**40 + 7, U64_MAX):
        tx = (rx - delta) & U64_MAX
        got = int(tddc.occupancy_s32(_u64(rx), _u64(tx)))
        want = int(rddc.occupancy_s32(rddc.u64(rx), rddc.u64(tx)))
        assert got == want
        if abs(delta) < 2**31:
            assert got == delta


def test_ddc_step_equal_reference_with_lo_word_carry():
    """The DDC block over 50 random periods, its low words started near
    the wrap so that carries happen, equals the reference's counters and
    occupancies."""
    t_state = tddc.ddc_init(3, device="cpu")
    r_state = rddc.ddc_init(3)
    start = np.array([0xFFFFFF00, 0xFFFFFFF0, 7], np.uint32)
    t_state["rx_lo"] = torch.tensor(start.astype(np.int64))
    r_state["rx_lo"] = jnp.asarray(start)
    rng = np.random.default_rng(0)
    total = np.zeros(3, np.int64)
    for _ in range(50):
        rx = rng.integers(0, 100, 3).astype(np.uint32)
        tx = rng.integers(0, 100, 3).astype(np.uint32)
        t_state, t_occ = tddc.ddc_step(t_state, rx, tx)
        r_state, r_occ = rddc.ddc_step(r_state, jnp.asarray(rx),
                                       jnp.asarray(tx))
        total += rx.astype(np.int64) - tx.astype(np.int64)
        np.testing.assert_array_equal(t_occ.numpy(), np.asarray(r_occ))
        for k in t_state:
            np.testing.assert_array_equal(t_state[k].numpy(),
                                          np.asarray(r_state[k], np.int64))
    # occupancy = trunc32(Σrx − Σtx), the rx counters started at `start`
    want = (start.astype(np.int64) + total + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(t_occ.numpy(), want)
    assert int(t_state["rx_hi"][0]) == 1


def test_ddc_object_wrapper():
    d = tddc.Ddc(2, device="cpu")
    occ = d.step(np.array([5, 1], np.uint32), np.array([2, 3], np.uint32))
    np.testing.assert_array_equal(occ.numpy(), [3, -2])


# ------------------------------------------------ latency and schedules

def _spool_links(topo):
    cable = np.full(topo.num_edges, 1.5)
    pair = ((topo.src == 0) & (topo.dst == 2)) | ((topo.src == 2)
                                                   & (topo.dst == 0))
    cable[pair] = 1000.0
    return cable


@pytest.mark.parametrize("jitter", [None, 3])
def test_latency_tables_equal_reference(jitter):
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=_spool_links(topo))
    t_topo, t_links = convert.topology(topo), convert.links(links)
    kw = dict(phase_jitter_seed=jitter)
    np.testing.assert_array_equal(
        tlat.logical_latency(t_topo, t_links, **kw),
        rlat.logical_latency(topo, links, **kw))
    np.testing.assert_array_equal(
        tlat.round_trip_latency(t_topo, t_links, **kw),
        rlat.round_trip_latency(topo, links, **kw))
    assert tlat.rtt_table(t_topo, t_links, **kw) == \
        rlat.rtt_table(topo, links, **kw)
    assert max(max(v) for v in tlat.rtt_table(t_topo, t_links).values()) \
        in range(1296, 1303)          # Table 2: 1299


def _lsns(n):
    topo = rc.ring(n)
    links = rc.make_links(topo, cable_m=2.0)
    lam = rlat.logical_latency(topo, links)
    return (tsched.LogicalSynchronyNetwork(convert.topology(topo), lam),
            rsched.LogicalSynchronyNetwork(topo, lam))


@pytest.mark.parametrize("n,chunk,combine", [(3, 1, 0), (4, 8, 4),
                                             (7, 33, 9), (12, 256, 64)])
def test_ring_allreduce_schedule_equal_reference(n, chunk, combine):
    t_lsn, r_lsn = _lsns(n)
    got = tsched.ring_allreduce_schedule(t_lsn, list(range(n)), chunk,
                                         combine)
    want = rsched.ring_allreduce_schedule(r_lsn, list(range(n)), chunk,
                                          combine)
    assert got.events == [tsched.CommEvent(**vars(e)) for e in want.events]
    assert got.makespan_ticks == want.makespan_ticks
    assert len(got.events) == 2 * (n - 1) * n
    for depth in (0, 4, 2 * n * chunk + 64):
        assert tsched.verify_bounded(got, t_lsn, depth) == \
            rsched.verify_bounded(want, r_lsn, depth)
    assert tsched.verify_bounded(got, t_lsn, 2 * n * chunk + 64)


def test_pipeline_schedule_equal_reference():
    t_lsn, r_lsn = _lsns(4)
    kw = dict(stages=[0, 1, 2, 3], num_microbatches=8, fwd_ticks=100,
              bwd_ticks=200, activation_frames=16)
    got = tsched.pipeline_schedule(t_lsn, **kw)
    want = rsched.pipeline_schedule(r_lsn, **kw)
    assert got.events == [tsched.CommEvent(**vars(e)) for e in want.events]
    assert got.makespan_ticks == want.makespan_ticks >= 8 * 300
    assert tsched.verify_bounded(got, t_lsn, 1024)
    assert t_lsn.latency(0, 1) == r_lsn.latency(0, 1)


# ------------------------------------------------- frame-level oracle

def _controller(kp=2e-7):
    return lambda err: kp * err


def _frame_cases():
    ring3 = rc.ring(3)
    swap = rs.edges_between(ring3, 0, 1)
    return {
        "controlled": (ring3, rc.make_links(ring3, cable_m=2.0),
                       np.array([3.0, -2.0, 1.0]), 3.0,
                       dict(controller=_controller(),
                            control_period_s=1e-3), None),
        "uncontrolled": (rc.fully_connected(2),
                         rc.make_links(rc.fully_connected(2), cable_m=2.0),
                         np.array([300.0, -300.0]), 40.0, {}, None),
        "latency_step": (ring3, rc.make_links(ring3, cable_m=2.0),
                         np.zeros(3), 2.5, {},
                         [rs.LatencyStep(t=1.0, edges=swap, cable_m=999.0)]),
        "double_swap": (ring3, rc.make_links(ring3, cable_m=2.0),
                        np.array([2.0, -1.0, 0.5]), 3.5,
                        dict(controller=_controller(),
                             control_period_s=1e-3),
                        [rs.LatencyStep(t=1.0, edges=swap, cable_m=999.0),
                         rs.LatencyStep(t=2.2, edges=swap, cable_m=2.0)]),
        "freq_step": (ring3, rc.make_links(ring3, cable_m=2.0), np.zeros(3),
                      2.0, {}, [rs.FreqStep(t=0.5, nodes=(0,),
                                            delta_ppm=40.0)]),
        "reframe": (ring3, rc.make_links(ring3, cable_m=2.0),
                    np.array([1.0, -1.0, 0.0]), 2.0,
                    dict(controller=_controller(), control_period_s=1e-3),
                    [rs.Reframe(t=1.0, shift=3),
                     rs.Reframe(t=1.5, mode="graph")]),
    }


@pytest.mark.parametrize("case", list(_frame_cases()))
def test_frame_level_equal_reference(case):
    topo, links, ppm, dur, kw, events = _frame_cases()[case]
    want = rfl.simulate_frames(topo, links, ppm, dur, events=events, **kw)
    got = tfl.simulate_frames(
        convert.topology(topo), convert.links(links), ppm, dur,
        events=None if events is None else convert.scenario(
            rs.Scenario(events=tuple(events))), **kw)
    for field in ("lam", "occupancy_min", "occupancy_max", "ticks",
                  "inserted", "rotated"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.lam_constant, got.underflow, got.overflow) == \
        (want.lam_constant, want.underflow, want.overflow)
    assert got.lam_epochs == want.lam_epochs
    if case == "uncontrolled":
        assert got.underflow or got.overflow
    elif case == "latency_step":
        assert got.lam_constant and got.inserted.max() > 500


def test_frame_level_rejects_abstract_only_events():
    topo = tc.ring(3)
    with pytest.raises(ValueError, match="LatencyStep"):
        tfl.simulate_frames(topo, tc.make_links(topo), np.zeros(3), 1.0,
                            events=[ts.NodeHoldover(t=0.5, nodes=(0,))])


# -------------------------------------------------------- the facade

QUICKSTART = dict(
    ctrl=dict(kind="discrete", kp=2e-8, fs=1e-7, pulses_per_update=50),
    cfg=dict(dt=5e-5, steps=10_000, record_every=20, quantize_beta=True))


def test_quickstart_flow_equal_reference():
    """examples/quickstart.py's flow: the network converges, and the
    logical synchrony network and its RTT table equal the reference's."""
    osc = rc.OscillatorSpec(initial_ppm=8.0, seed=0)
    ref_net = rc.BittideNetwork.build(rc.fully_connected(8), cable_m=2.0,
                                      osc=osc)
    net = tc.BittideNetwork.build(tc.fully_connected(8), cable_m=2.0,
                                  osc=tc.OscillatorSpec(initial_ppm=8.0,
                                                        seed=0),
                                  device="cpu")
    np.testing.assert_array_equal(net.ppm_u, ref_net.ppm_u)
    want = ref_net.sync(ctrl=rc.ControllerConfig(**QUICKSTART["ctrl"]),
                        cfg=rc.SimConfig(**QUICKSTART["cfg"]))
    got = net.sync(ctrl=tc.ControllerConfig(**QUICKSTART["ctrl"]),
                   cfg=tc.SimConfig(**QUICKSTART["cfg"]))
    assert got.converged and want.converged
    assert got.freq_spread_ppm < 1.0 and got.convergence_time_s < 0.3
    assert got.convergence_time_s == want.convergence_time_s
    assert_freq_parity(got.sim.freq_ppm, want.sim.freq_ppm)
    np.testing.assert_array_equal(got.lsn.lam, want.lsn.lam)
    assert np.all((got.lsn.lam >= 33) & (got.lsn.lam <= 37))
    assert tlat.rtt_table(got.lsn.topo, net.links) == \
        rlat.rtt_table(want.lsn.topo, ref_net.links)
    assert got.lsn.latency(0, 1) == want.lsn.latency(0, 1)


def test_unconverged_sync_reported():
    net = tc.BittideNetwork.build(tc.fully_connected(8),
                                  osc=tc.OscillatorSpec(initial_ppm=8.0,
                                                        seed=1),
                                  device="cpu")
    out = net.sync(ctrl=tc.ControllerConfig(kp=1e-12),
                   cfg=tc.SimConfig(dt=1e-3, steps=2_000, record_every=20))
    assert not out.converged
    np.testing.assert_array_equal(
        out.lsn.lam, tlat.logical_latency(net.topo, net.links))


def test_convert_network_carries_the_reference_network():
    ref_net = rc.BittideNetwork.build(rc.torus3d(3), cable_m=5.0,
                                      osc=rc.OscillatorSpec(seed=4))
    net = convert.network(ref_net, device="cpu")
    assert net.device == "cpu" and net.topo.name == ref_net.topo.name
    np.testing.assert_array_equal(net.topo.src, ref_net.topo.src)
    np.testing.assert_array_equal(net.topo.dst, ref_net.topo.dst)
    np.testing.assert_array_equal(net.ppm_u, ref_net.ppm_u)
    np.testing.assert_array_equal(net.links.latency_s,
                                  ref_net.links.latency_s)
    np.testing.assert_array_equal(net.links.beta0, ref_net.links.beta0)
    assert net.omega_nom == ref_net.omega_nom


def test_cable_swap_through_the_facade_on_per_step():
    """examples/cable_swap.py's scenario (at its smoke length) through
    ``BittideNetwork.run_scenario`` on the port's per-step lane: the RTT
    shift equals the reference's (≈1231 frames), ν follows the
    reference's segment-sum lane, and the run went through the per-step
    wrapper (its plain version here)."""
    steps = 4_000
    osc = rc.OscillatorSpec(initial_ppm=8.0, seed=0)
    ref_net = rc.BittideNetwork.build(rc.fully_connected(8), cable_m=2.0,
                                      osc=osc)
    net = convert.network(ref_net, device="cpu")
    swap = rs.edges_between(ref_net.topo, 0, 2)
    sc = rs.Scenario(events=(rs.LatencyStep(t=steps * 1e-4 / 2, edges=swap,
                                            cable_m=1000.0,
                                            reestablish=True),),
                     name="fiber-spool-swap")
    cfg = rc.SimConfig(dt=1e-4, steps=steps, record_every=20)
    want = ref_net.run_scenario(sc, rc.ControllerConfig(kp=2e-8), cfg,
                                options=rk.EngineOptions(
                                    engine="segment-sum"))
    from repro_torch.kernels.bittide_step import VARIANTS_USED
    got = net.run_scenario(convert.scenario(sc),
                           tc.ControllerConfig(kp=2e-8),
                           convert.sim_config(cfg),
                           options=tk.EngineOptions(engine="per-step"),
                           telemetry=Telemetry(beta=True))
    assert got.engine == "per-step" and got.beta.shape == got.freq_ppm.shape
    assert ("per-step", True, False, False) in VARIANTS_USED
    shift = (got.rtt(1) - got.rtt(0))[swap[0]]
    assert shift == (want.rtt(1) - want.rtt(0))[swap[0]]
    assert abs(int(shift) - 1231) <= 3
    floor = _chip_smoke().float32_floor_ppm(2e-8, 7,
                                            float(np.abs(got.psi).max()))
    np.testing.assert_allclose(got.freq_ppm, want.freq_ppm, rtol=0,
                               atol=max(floor, FREQ_ATOL_PPM))


def test_facade_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = tc.fully_connected(4)
    for call in (lambda: tc.BittideNetwork.build(topo),
                 lambda: tc.BittideNetwork(topo, tc.make_links(topo),
                                           np.zeros(4)).sync(),
                 lambda: tddc.ddc_init(2), lambda: tddc.u64(3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
