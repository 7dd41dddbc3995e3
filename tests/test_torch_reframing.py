"""repro_torch's scenario layer against repro's: the copied numpy modules,
pointer rotations, and the in-kernel reframing guard through run_scenario.

``repro_torch.core.envelopes`` / ``reframing`` and
``repro_torch.scenarios.events`` / ``compiler`` are numpy copies of the
reference's modules, on the port's topology and frame model: the same
inputs must give the same outputs (exactly, or to float64 rounding for
the pseudo-inverse-based solves) on fully_connected(8), ring(12), cube()
and hourglass(4).

The runner cases mirror ``tests/test_reframing.py``: manual ``Reframe``
events on every lane; the harness's guard-on lane
(``engine_harness.guard_case``), whose splice records and shifts must be
IDENTICAL to the reference's fused lane with ``guard_latency == 1``; the
never-tripping guard, bit-identical to the guard-off run; per-draw
shifts on a batch.  Frequencies are held to ``FREQ_ATOL_PPM`` at the
reference's parity gain and, on the guard-on cases (kp = 2e-8, β swept
through the guard band), to the reference's own cross-lane bar there
(1e-5 ppm, ``tests/test_reframing.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import (assert_freq_parity, guard_case,  # noqa: E402
                            run_guarded)
from repro.core import envelopes as renv  # noqa: E402
from repro.core import reframing as rref  # noqa: E402
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import envelopes as tenv  # noqa: E402
from repro_torch.core import reframing as tref  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

KERNEL_LANES = ["fused", "tiled"]
GUARD_FREQ_ATOL_PPM = 1e-5     # tests/test_reframing.py's cross-lane bar
TOPOS = [rc.fully_connected(8), rc.ring(12), rc.cube(), rc.hourglass(4)]


def _zero_mean_ppm(n, scale, seed=7):
    ppm = np.random.default_rng(seed).uniform(-scale, scale, n)
    return (ppm - ppm.mean()).astype(np.float32)


def _port(topo, links, ctrl, ppm, sc, cfg, engine, telemetry=None, **opts):
    return ts.run_scenario(
        convert.topology(topo), convert.links(links),
        convert.controller(ctrl), ppm, convert.scenario(sc),
        convert.sim_config(cfg),
        options=tk.EngineOptions(engine=engine, **opts),
        telemetry=telemetry, device="cpu")


# ------------------------------------------------------- copied modules

@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t.name)
def test_envelopes_match_reference(topo):
    port_topo = convert.topology(topo)
    w = np.ones(topo.num_edges)
    w[0] = 0.5
    np.testing.assert_array_equal(tenv.laplacian(port_topo, w),
                                  renv.laplacian(topo, w))
    lap = renv.laplacian(topo)
    assert tenv.spectral_gap(lap) == renv.spectral_gap(lap)
    kw = dict(kp=2e-8, dt=1e-3)
    f_ref = renv.freq_step_envelope(topo, nodes=(0, 1), delta_ppm=2.0, **kw)
    f_port = tenv.freq_step_envelope(port_topo, nodes=(0, 1), delta_ppm=2.0,
                                     **kw)
    np.testing.assert_array_equal(f_port.db_inf, f_ref.db_inf)
    assert (f_port.amp, f_port.sigma) == (f_ref.amp, f_ref.sigma)
    l_ref = renv.latency_step_envelope(topo, edges=(0, 1), dlat_s=5e-6,
                                       nu_bound=1e-5, **kw)
    l_port = tenv.latency_step_envelope(port_topo, edges=(0, 1),
                                        dlat_s=5e-6, nu_bound=1e-5, **kw)
    assert l_port.amp == l_ref.amp
    args = (1e-3, 12, 1e-5, 60.0)
    assert (tenv.reframe_guard_margin(port_topo, 2e-8, *args)
            == renv.reframe_guard_margin(topo, 2e-8, *args))
    np.testing.assert_array_equal(
        tenv.reframe_guard_margins(port_topo, [2e-8, 6e-8], 1e-3, 12,
                                   [1e-5, 3e-5], 60.0),
        renv.reframe_guard_margins(topo, [2e-8, 6e-8], 1e-3, 12,
                                   [1e-5, 3e-5], 60.0))


@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t.name)
def test_reframing_matches_reference(topo):
    port_topo = convert.topology(topo)
    rng = np.random.default_rng(3)
    links = rc.make_links(topo, cable_m=2.0,
                          beta0=rng.uniform(-4, 4, topo.num_edges))
    psi = rng.normal(0.0, 50.0, topo.num_nodes)
    nu = np.full(topo.num_nodes, 3e-6)
    lat = np.asarray(links.latency_s) * 125e6
    beta_ref = rref.edge_occupancy(topo, psi, nu, lat, links.beta0)
    beta_port = tref.edge_occupancy(port_topo, psi, nu, lat, links.beta0)
    np.testing.assert_array_equal(beta_port, beta_ref)
    np.testing.assert_array_equal(
        tref.node_net_occupancy(port_topo, beta_ref),
        rref.node_net_occupancy(topo, beta_ref))
    d = rng.normal(0, 20, topo.num_nodes)
    d -= d.mean()
    for got, want in zip(tref.graph_shifts(port_topo, d),
                         rref.graph_shifts(topo, d)):
        np.testing.assert_array_equal(got, want)
    for mode in ("graph", "per-edge"):
        for got, want in zip(
                tref.shift_assignment(port_topo, beta_ref, None, mode, 1.0),
                rref.shift_assignment(topo, beta_ref, None, mode, 1.0)):
            np.testing.assert_array_equal(got, want)
    rf_ref = rref.reframe_state(topo, links, psi, nu, mode="graph")
    rf_port = tref.reframe_state(port_topo, convert.links(links), psi, nu,
                                 mode="graph")
    np.testing.assert_array_equal(rf_port.shift, rf_ref.shift)
    np.testing.assert_array_equal(rf_port.links.beta0, rf_ref.links.beta0)
    assert tref.potential_residual(port_topo, rf_port.shift) == 0.0
    pol = rc.ReframePolicy(depth=16, margin=None)
    assert (convert.reframe_policy(pol).guard(np.array([2.0, 3.0])).tolist()
            == pol.guard(np.array([2.0, 3.0])).tolist())


def _event_mix(topo):
    e01 = rs.edges_between(topo, 0, 1)
    return rs.Scenario(events=(
        rs.Mark(t=0.012),
        rs.LatencyStep(t=0.024, edges=e01, cable_m=1000.0),
        rs.FreqStep(t=0.048, nodes=(3,), delta_ppm=2.0),
        rs.DriftRamp(t=0.06, t_end=0.1, nodes=(0, 1), rate_ppm_per_s=5.0),
        rs.NodeHoldover(t=0.108, nodes=(2,)),
        rs.LinkDrop(t=0.12, edges=e01),
        rs.NodeReset(t=0.144, nodes=(2,)),
        rs.LinkRestore(t=0.156, edges=e01),
        rs.Reframe(t=0.18, mode="graph"),
        rs.LatencyStep(t=0.192, edges=e01, cable_m=2.0, reestablish=True),
    ), name="mix")


@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t.name)
def test_events_and_compiler_match_reference(topo):
    sc = _event_mix(topo)
    port_sc = convert.scenario(sc)
    assert [type(e).__name__ for e in port_sc.events] == \
        [type(e).__name__ for e in sc.events]
    assert port_sc.horizon == sc.horizon and port_sc.name == sc.name
    assert ts.edges_between(convert.topology(topo), 0, 1) == \
        rs.edges_between(topo, 0, 1)
    links = rc.make_links(topo, cable_m=2.0)
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12)
    ref = rs.compile_scenario(sc, topo, links, cfg)
    port = ts.compile_scenario(port_sc, convert.topology(topo),
                               convert.links(links), convert.sim_config(cfg))
    assert port.chunk_records == ref.chunk_records
    assert port.notes == ref.notes
    np.testing.assert_array_equal(port.lat_classes, ref.lat_classes)
    assert port.num_segments == ref.num_segments
    for a, b in zip(port.segments, ref.segments):
        assert (a.start_record, a.records) == (b.start_record, b.records)
        for name in ("latency_s", "dppm", "edge_w", "ctrl_mask"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        assert a.reestablish == b.reestablish
        assert [type(r).__name__ for r in a.reframe] == \
            [type(r).__name__ for r in b.reframe]
    with pytest.raises(ValueError, match="graph-mode"):
        ts.Reframe(t=0.0, edges=(0, 1), mode="graph")


# -------------------------------------------------- rotations in the runner

@pytest.mark.parametrize("engine", ["segment-sum"] + KERNEL_LANES)
def test_manual_graph_reframe_matches_reference(engine):
    """A mid-run graph-mode Reframe: identical shifts and λ tables, ν at
    FREQ_ATOL_PPM, on every lane."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ctrl = rc.ControllerConfig(kp=2e-7)
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12)
    sc = rs.Scenario(events=(rs.Reframe(t=0.12, mode="graph"),))
    ppm = _zero_mean_ppm(8, 2.0)
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine=engine),
                          telemetry=RefTelemetry(beta=True))
    port = _port(topo, links, ctrl, ppm, sc, cfg, engine,
                 Telemetry(beta=True))
    (rec,) = port.reframes
    assert not rec.auto and np.any(rec.shift != 0)
    np.testing.assert_array_equal(rec.shift, ref.reframes[0].shift)
    np.testing.assert_array_equal(port.lam, ref.lam)
    assert_freq_parity(port.freq_ppm, ref.freq_ppm)


@pytest.mark.parametrize("engine", KERNEL_LANES)
def test_guard_lane_matches_reference_fused(engine):
    """The harness's guard-on lane: the in-kernel trip records, the
    spliced shifts and the one-record guard latency are IDENTICAL to the
    reference's fused lane."""
    topo, links, ctrl, ppm, sc, cfg, pol = guard_case()
    ref = run_guarded(topo, links, ctrl, ppm, sc, cfg, "fused", pol)
    port = _port(topo, links, ctrl, ppm, sc, cfg, engine,
                 Telemetry(beta=True, guard=convert.reframe_policy(pol)))
    assert port.engine == engine and len(port.reframes) >= 1
    assert all(r.guard_latency == 1 and r.auto for r in port.reframes)
    assert ([(r.record, np.asarray(r.shift).tolist()) for r in port.reframes]
            == [(r.record, np.asarray(r.shift).tolist())
                for r in ref.reframes])
    np.testing.assert_array_equal(port.lam_final, ref.lam_final)
    np.testing.assert_allclose(port.freq_ppm, ref.freq_ppm, rtol=0,
                               atol=GUARD_FREQ_ATOL_PPM)


@pytest.mark.parametrize("engine", KERNEL_LANES)
def test_guard_lane_never_trips_bit_identical(engine):
    """A band far outside reach: the guard-on run is bit-identical to the
    guard-off run and logs no splice."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ctrl = rc.ControllerConfig(kp=2e-7)
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12)
    ppm = _zero_mean_ppm(8, 0.5)
    sc = rs.Scenario(events=())
    off = _port(topo, links, ctrl, ppm, sc, cfg, engine, Telemetry(beta=True))
    on = _port(topo, links, ctrl, ppm, sc, cfg, engine,
               Telemetry(beta=True,
                         guard=tc.ReframePolicy(depth=64, margin=1.0)))
    assert on.reframes == []
    for name in ("freq_ppm", "beta", "psi", "nu"):
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name),
                                      err_msg=name)


def test_guard_per_draw_shifts_match_reference():
    """A batch rotates per draw: (B, E) shifts, only tripping draws move;
    the port's fused and tiled lanes splice exactly where the reference's
    fused lane does, with the same shifts, and conserve every RTT."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ctrl = rc.ControllerConfig(kp=2e-8)
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12)
    rng = np.random.default_rng(3)
    ppm_b = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
    ppm_b -= ppm_b.mean(axis=1, keepdims=True)
    sc = rs.Scenario(events=(rs.DriftRamp(t=0.06, t_end=0.18, nodes=(0, 1),
                                          rate_ppm_per_s=20.0),))
    pol = rc.ReframePolicy(depth=16, margin=4.0)
    ref = rs.run_scenario(topo, links, ctrl, ppm_b, sc, cfg,
                          options=rk.EngineOptions(engine="fused"),
                          telemetry=RefTelemetry(guard=pol))
    rev = topo.reverse_edge_index()
    assert len(ref.reframes) >= 1
    for engine in KERNEL_LANES:
        port = _port(topo, links, ctrl, ppm_b, sc, cfg, engine,
                     Telemetry(guard=convert.reframe_policy(pol)))
        assert len(port.reframes) == len(ref.reframes)
        for a, b in zip(ref.reframes, port.reframes):
            assert a.record == b.record and b.guard_latency == 1
            assert b.shift.shape == (4, topo.num_edges)
            np.testing.assert_array_equal(a.shift, b.shift)
        total = port.total_reframe_shift
        np.testing.assert_array_equal(total + total[..., rev], 0)
        np.testing.assert_allclose(port.freq_ppm, ref.freq_ppm, rtol=0,
                                   atol=GUARD_FREQ_ATOL_PPM)


def test_segment_sum_guard_matches_reference():
    """The host-inspected trigger of the segment-sum lane (Laplacian
    estimate of the per-edge record, exposure up to one chunk): same
    splices, shifts and guard latencies as the reference's."""
    topo, links, ctrl, ppm, sc, cfg, pol = guard_case()
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          telemetry=RefTelemetry(beta=True, guard=pol))
    port = _port(topo, links, ctrl, ppm, sc, cfg, "segment-sum",
                 Telemetry(beta=True, guard=convert.reframe_policy(pol)))
    assert len(port.reframes) == len(ref.reframes) >= 1
    for a, b in zip(ref.reframes, port.reframes):
        assert (a.record, a.guard_latency) == (b.record, b.guard_latency)
        np.testing.assert_array_equal(a.shift, b.shift)
    np.testing.assert_allclose(port.freq_ppm, ref.freq_ppm, rtol=0,
                               atol=GUARD_FREQ_ATOL_PPM)


def test_default_margins_are_per_draw_and_match_reference():
    """``margin=None``: per-draw margins from each draw's own gain and
    disturbance; the fused lane rotates only the drifting draw, as the
    reference does."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12)
    ctrl = rc.ControllerConfig(kp=np.array([2e-8, 3e-8]))
    ppm_b = np.tile(_zero_mean_ppm(8, 0.5), (2, 1))
    sc = rs.Scenario(events=(rs.FreqStep(t=0.06, nodes=(0,),
                                         delta_ppm=np.array([0.0, 8.0])),))
    pol = rc.ReframePolicy(depth=12, margin=None)
    ref = rs.run_scenario(topo, links, ctrl, ppm_b, sc, cfg,
                          options=rk.EngineOptions(engine="fused"),
                          telemetry=RefTelemetry(beta=True, guard=pol))
    port = _port(topo, links, ctrl, ppm_b, sc, cfg, "fused",
                 Telemetry(beta=True, guard=convert.reframe_policy(pol)))
    assert len(port.reframes) == len(ref.reframes) >= 1
    for a, b in zip(ref.reframes, port.reframes):
        assert a.record == b.record
        np.testing.assert_array_equal(a.shift, b.shift)
        np.testing.assert_array_equal(b.shift[0], 0)


def test_telemetry_trace_and_guard_are_accepted():
    """``Telemetry(trace=..., guard=...)`` raised until the scenario runner
    was ported; now they reach run_scenario, and the single-call dense
    runner points at it."""
    tel = Telemetry(trace=True, guard=tc.ReframePolicy(depth=16))
    assert tel.trace is True and tel.guard.depth == 16
    topo = tc.fully_connected(4)
    with pytest.raises(ValueError, match="run_scenario"):
        tk.simulate_ensemble_dense(topo, tc.make_links(topo),
                                   np.zeros((1, 4)), 12, 2e-9,
                                   record_every=12, telemetry=tel,
                                   device="cpu")
    res = ts.run_scenario(topo, tc.make_links(topo),
                          tc.ControllerConfig(kp=2e-8), np.zeros(4),
                          ts.Scenario(events=()),
                          tc.SimConfig(dt=1e-3, steps=48, record_every=12),
                          options=tk.EngineOptions(engine="fused"),
                          telemetry=tel, device="cpu")
    assert res.reframes == [] and len(res.trace.by_kind("guard_eval")) == 1


def test_torus_guard_case_on_the_tiled_lane_matches_reference():
    """tests/test_reframing.py's torus case (torus3d(8), DriftRamp +
    LatencyStep, ReframePolicy(depth=16, margin=5.0)): the port's tiled
    lane ("auto" above 256 nodes) splices at the reference fused lane's
    records with its shifts, one record after each crossing, and stays
    within that test's cross-lane bar for this case (1e-3 ppm)."""
    topo = rc.torus3d(8)
    links = rc.make_links(topo, cable_m=2.0)
    ppm = _zero_mean_ppm(topo.num_nodes, 0.25)
    ctrl = rc.ControllerConfig(kp=6e-7)
    cfg = rc.SimConfig(dt=1e-3, steps=384, record_every=6)
    sc = rs.Scenario(events=(
        rs.DriftRamp(t=0.048, t_end=0.24, nodes=tuple(range(64)),
                     rate_ppm_per_s=150.0),
        rs.LatencyStep(t=0.288, edges=rs.edges_between(topo, 0, 1),
                       cable_m=1000.0)), name="torus-drift-swap")
    pol = rc.ReframePolicy(depth=16, margin=5.0)
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="fused"),
                          telemetry=RefTelemetry(beta=True, guard=pol))
    port = _port(topo, links, ctrl, ppm, sc, cfg, "auto",
                 Telemetry(beta=True, guard=convert.reframe_policy(pol)))
    assert port.engine == "tiled" and len(port.reframes) >= 3
    assert len(port.reframes) == len(ref.reframes)
    for a, b in zip(ref.reframes, port.reframes):
        assert a.record == b.record and b.guard_latency == 1
        np.testing.assert_array_equal(a.shift, b.shift)
    np.testing.assert_allclose(port.freq_ppm, ref.freq_ppm, rtol=0,
                               atol=1e-3)
    deg = np.zeros(topo.num_nodes)
    np.add.at(deg, np.asarray(topo.dst), 1.0)
    assert np.abs(port.beta / deg).max() < 32 / 2
