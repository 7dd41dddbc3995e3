"""repro_torch.scenarios.run_scenario against repro.scenarios.run_scenario.

The same scenario, links, gains and numpy oscillator draws go through the
reference runner (its Pallas lanes in interpret mode on the CPU, as its
own tests run them) and the port's runner with ``device="cpu"`` (the
kernels' plain versions), on the segment-sum, fused and tiled lanes.
``repro_torch.convert`` carries the topology, links, configs and the
scenario's events across.

Tolerances (``tests/engine_harness.py``): ν at every record point within
``FREQ_ATOL_PPM`` at the reference's parity gain ``PARITY_KP``; logical
latency tables (integers) and λeff folds exactly equal.  The non-converged
β records (|β| up to ~10³ frames) are held to ``BETA_ULPS`` float32 ulps
of the largest reference value, or ``BETA_ATOL_CROSS_FRAMES`` where that
is larger: the two packages round the same sums in different orders.
The cable swap runs at the example's gain (kp = 2e-8, dt = 1e-4), where
the float32 floor of ROADMAP §3 (``chip_smoke.float32_floor_ppm``) is the
frequency bar.  The port's own bit-identity claims (split vs unsplit,
batched vs per-draw, on every lane) are held exactly.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import (BETA_ATOL_CROSS_FRAMES, PARITY_KP,  # noqa: E402
                            assert_freq_parity)
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.telemetry import (RunTrace, Telemetry,  # noqa: E402
                                   no_new_compiles)

BETA_ULPS = 8
LANES = ["segment-sum", "fused", "tiled"]
TOPO = rc.fully_connected(8)
LINKS = rc.make_links(TOPO, cable_m=2.0)
PPM = np.random.default_rng(7).uniform(-8, 8, 8).astype(np.float32)
SWAP = rs.edges_between(TOPO, 0, 2)


def _cfg(**kw):
    base = dict(dt=1e-3, steps=240, record_every=12)
    base.update(kw)
    return rc.SimConfig(**base)


def _swap(reestablish=False):
    return rs.Scenario(events=(rs.LatencyStep(t=0.12, edges=SWAP,
                                              cable_m=1000.0,
                                              reestablish=reestablish),),
                       name="fc8-swap")


def _port(topo, links, ctrl, ppm, sc, cfg, engine="segment-sum",
          telemetry=None, **opts):
    return ts.run_scenario(
        convert.topology(topo), convert.links(links),
        convert.controller(ctrl), ppm, convert.scenario(sc),
        convert.sim_config(cfg), options=tk.EngineOptions(engine=engine,
                                                          **opts),
        telemetry=telemetry, device="cpu")


def _pair(topo, links, ctrl, ppm, sc, cfg, engine, beta=True, **opts):
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine=engine, **opts),
                          telemetry=RefTelemetry(beta=beta))
    port = _port(topo, links, ctrl, ppm, sc, cfg, engine,
                 Telemetry(beta=beta), **opts)
    return ref, port


def _beta_bar(ref) -> float:
    return max(BETA_ATOL_CROSS_FRAMES, BETA_ULPS * float(
        np.spacing(np.float32(np.abs(ref).max()))))


def _assert_pair(ref, port):
    assert port.engine == ref.engine
    assert port.freq_ppm.shape == ref.freq_ppm.shape
    assert port.num_launches == ref.num_launches
    assert_freq_parity(port.freq_ppm, ref.freq_ppm)
    np.testing.assert_array_equal(port.lam, ref.lam)
    np.testing.assert_array_equal(port.segment_records, ref.segment_records)
    np.testing.assert_allclose(port.lam_eff, ref.lam_eff, rtol=0,
                               atol=BETA_ATOL_CROSS_FRAMES)
    assert port.beta.shape == ref.beta.shape
    np.testing.assert_allclose(port.beta, ref.beta, rtol=0,
                               atol=_beta_bar(ref.beta))


# ----------------------------------------------------------- bit identity

@pytest.mark.parametrize("ctrl", [
    tc.ControllerConfig(kind="proportional", kp=2e-8),
    tc.ControllerConfig(kind="pi", kp=2e-8, ki=1e-9),
    tc.ControllerConfig(kind="discrete", kp=2e-8, fs=1e-8),
], ids=lambda c: c.kind)
def test_no_event_two_segment_run_bit_identical(ctrl):
    """A Mark-only split run reproduces the unsplit segment-sum run bit
    for bit — ψ/ν, the controller state and the quantization phase."""
    topo, links = convert.topology(TOPO), convert.links(LINKS)
    cfg = tc.SimConfig(dt=1e-3, steps=240, record_every=12,
                       quantize_beta=True)
    plain = tc.simulate(topo, links, ctrl, PPM, cfg, device="cpu")
    res = ts.run_scenario(topo, links, ctrl, PPM,
                          ts.Scenario(events=(ts.Mark(t=0.12),)), cfg,
                          device="cpu")
    assert res.num_launches == 2 and res.engine == "segment-sum"
    np.testing.assert_array_equal(res.freq_ppm, plain.freq_ppm)
    np.testing.assert_array_equal(res.beta, plain.beta)
    np.testing.assert_array_equal(res.psi, plain.psi)
    np.testing.assert_array_equal(res.nu, plain.nu)
    for k in plain.c_state:
        np.testing.assert_array_equal(res.c_state[k], plain.c_state[k])


@pytest.mark.parametrize("engine", LANES)
def test_split_runs_are_bit_identical(engine):
    """chunk_records=1 (one engine call per record) and a Mark split both
    reproduce the unsplit run bit for bit on every lane."""
    ctrl = rc.ControllerConfig(kp=2e-8)
    tel = Telemetry(beta=True, watermarks=True)
    whole = _port(TOPO, LINKS, ctrl, PPM, rs.Scenario(events=()), _cfg(),
                  engine, tel)
    chunked = _port(TOPO, LINKS, ctrl, PPM, rs.Scenario(events=()), _cfg(),
                    engine, tel, chunk_records=1)
    split = _port(TOPO, LINKS, ctrl, PPM,
                  rs.Scenario(events=(rs.Mark(t=0.06),)), _cfg(), engine,
                  tel)
    assert whole.num_launches == 1
    assert chunked.num_launches == 20 and split.num_launches == 4
    for res in (chunked, split):
        for name in ("freq_ppm", "beta", "psi", "nu"):
            np.testing.assert_array_equal(getattr(res, name),
                                          getattr(whole, name), err_msg=name)
        np.testing.assert_array_equal(res.watermarks.peak_record,
                                      whole.watermarks.peak_record)
        np.testing.assert_array_equal(res.watermarks.beta_abs_max,
                                      whole.watermarks.beta_abs_max)


@pytest.mark.parametrize("engine", LANES)
def test_scenario_ensemble_rows_match_single_runs(engine):
    """Batched scenario == per-draw scenario runs, bit for bit on every
    lane (a draw's bits depend on neither B nor the kernel's layout)."""
    ctrl = rc.ControllerConfig(kp=2e-9)
    ppm_b = np.random.default_rng(11).uniform(-8, 8, (4, 8)).astype(
        np.float32)
    tel = Telemetry(beta=True)
    ens = _port(TOPO, LINKS, ctrl, ppm_b, _swap(True), _cfg(), engine, tel)
    assert ens.freq_ppm.shape == (4, 20, 8)
    for b in (0, 3):
        single = _port(TOPO, LINKS, ctrl, ppm_b[b], _swap(True), _cfg(),
                       engine, tel)
        np.testing.assert_array_equal(ens.freq_ppm[b], single.freq_ppm)
        np.testing.assert_array_equal(ens.beta[b], single.beta)
        np.testing.assert_array_equal(ens.psi[b], single.psi)


# ---------------------------------------------------- parity with repro

@pytest.mark.parametrize("reestablish", [False, True],
                         ids=["plain", "reestablish"])
@pytest.mark.parametrize("engine", LANES)
def test_latency_step_matches_reference(engine, reestablish):
    ctrl = rc.ControllerConfig(kp=PARITY_KP)
    ref, port = _pair(TOPO, LINKS, ctrl, PPM, _swap(reestablish), _cfg(),
                      engine)
    _assert_pair(ref, port)


@pytest.mark.parametrize("engine", LANES)
def test_freq_drift_and_holdover_events_match_reference(engine):
    """FreqStep, a DriftRamp (one segment per record inside the ramp) and
    NodeHoldover / NodeReset on one run."""
    ctrl = rc.ControllerConfig(kp=PARITY_KP)
    sc = rs.Scenario(events=(
        rs.FreqStep(t=0.036, nodes=(3,), delta_ppm=2.0),
        rs.DriftRamp(t=0.06, t_end=0.12, nodes=(0, 1), rate_ppm_per_s=40.0),
        rs.NodeHoldover(t=0.144, nodes=(5,)),
        rs.NodeReset(t=0.192, nodes=(5,)),
    ), name="events")
    ref, port = _pair(TOPO, LINKS, ctrl, PPM, sc, _cfg(), engine)
    assert port.compiled.num_segments == ref.compiled.num_segments > 5
    _assert_pair(ref, port)
    held = (port.times > 0.144) & (port.times <= 0.192)
    f5 = port.freq_ppm[held, 5]
    assert np.all(f5 == f5[0])


@pytest.mark.parametrize("engine", ["fused", "tiled"])
def test_chunk_override_matches_reference(engine):
    ctrl = rc.ControllerConfig(kp=PARITY_KP)
    ref, port = _pair(TOPO, LINKS, ctrl, PPM, _swap(), _cfg(), engine,
                      chunk_records=5)
    assert port.num_launches == 4 and port.chunk_records == 5
    _assert_pair(ref, port)
    with pytest.raises(ValueError, match="does not divide"):
        _port(TOPO, LINKS, ctrl, PPM, _swap(), _cfg(), engine,
              chunk_records=7)


def test_latency_step_shifts_logical_latency_table():
    """Table 2: the swap shifts λ by rint(ω·Δl) per direction — the
    in-flight frames the 2 km spool adds — and the RTT by ≈1231."""
    res = _port(TOPO, LINKS, rc.ControllerConfig(kp=2e-8), PPM, _swap(),
                _cfg())
    shift = res.lam_shift()
    expected = int(np.rint((1000.0 - 2.0) / 2.03e8 * 125e6))  # 615
    for e in SWAP:
        assert shift[e] == expected
    assert abs(int((res.rtt(-1) - res.rtt(0))[SWAP[0]]) - 1231) <= 1
    others = [e for e in range(TOPO.num_edges) if e not in SWAP]
    assert np.all(shift[others] == 0)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("engine", ["fused", "segment-sum"])
def test_cable_swap_rtt_shift_equals_reference(engine):
    """examples/cable_swap.py's scenario in its smoke form (4,000 periods,
    re-established buffers): the port's RTT shift equals the reference's
    fused lane's, ν stays within the float32 floor of it."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ppm = rc.OscillatorSpec(initial_ppm=8.0, seed=0).sample(8).astype(
        np.float32)
    ctrl = rc.ControllerConfig(kp=2e-8)
    cfg = rc.SimConfig(dt=1e-4, steps=4000, record_every=20)
    swap = rs.edges_between(topo, 0, 2)
    sc = rs.Scenario(events=(rs.LatencyStep(t=0.2, edges=swap,
                                            cable_m=1000.0,
                                            reestablish=True),),
                     name="fiber-spool-swap")
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="auto"),
                          telemetry=RefTelemetry(beta=True))
    port = _port(topo, links, ctrl, ppm, sc, cfg, engine,
                 Telemetry(beta=True))
    assert ref.engine == "fused"
    shift_ref = (ref.rtt(1) - ref.rtt(0))[swap[0]]
    shift_port = (port.rtt(1) - port.rtt(0))[swap[0]]
    assert shift_port == shift_ref and abs(int(shift_port) - 1231) <= 3
    np.testing.assert_array_equal(port.lam, ref.lam)
    floor = _chip_smoke().float32_floor_ppm(2e-8, 7,
                                            float(np.abs(port.psi).max()))
    np.testing.assert_allclose(port.freq_ppm, ref.freq_ppm, rtol=0,
                               atol=max(floor, 1e-6))


# ----------------------------------------------- options, counts, tracing

@pytest.mark.parametrize("engine", ["per-step"])
def test_unported_engines_raise(engine):
    with pytest.raises(NotImplementedError, match="ROADMAP queue item"):
        _port(TOPO, LINKS, rc.ControllerConfig(kp=2e-8), PPM, _swap(),
              _cfg(), engine)


def test_auto_runs_tiled_above_the_fused_regime():
    topo = rc.torus3d(7)
    links = rc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(2).uniform(-8, 8, topo.num_nodes)
    sc = rs.Scenario(events=(rs.LatencyStep(
        t=0.024, edges=rs.edges_between(topo, 0, 1), cable_m=1000.0),))
    ref, port = _pair(topo, links, rc.ControllerConfig(kp=PARITY_KP), ppm,
                      sc, _cfg(steps=48), "auto")
    assert port.engine == "tiled" and port.tile_j == tk.TILE_J
    _assert_pair(ref, port)


def test_dense_validation_mirrors_reference():
    ctrl_pi = rc.ControllerConfig(kind="pi", kp=2e-8, ki=1e-9)
    with pytest.raises(ValueError, match="proportional"):
        _port(TOPO, LINKS, ctrl_pi, PPM, _swap(), _cfg(), "fused")
    with pytest.raises(ValueError, match="segment-sum features"):
        _port(TOPO, LINKS, rc.ControllerConfig(kp=2e-8), PPM, _swap(),
              _cfg(quantize_beta=True), "tiled")
    with pytest.raises(ValueError, match="unknown engine"):
        _port(TOPO, LINKS, rc.ControllerConfig(kp=2e-8), PPM, _swap(),
              _cfg(), "warp")


@pytest.mark.parametrize("engine", LANES)
def test_scenario_builds_nothing_new_and_traces(engine):
    """A warm re-run selects no new kernel variant; the flight recorder
    sees one chunk span per engine call and a zero build delta."""
    ctrl = rc.ControllerConfig(kp=2e-8)
    sc = rs.Scenario(events=(rs.LatencyStep(t=0.06, edges=SWAP,
                                            cable_m=1000.0),
                             rs.FreqStep(t=0.12, nodes=(0,), delta_ppm=1.0)))
    _port(TOPO, LINKS, ctrl, PPM, sc, _cfg(), engine, Telemetry(beta=True))
    trace = RunTrace(name="t")
    with no_new_compiles():
        res = _port(TOPO, LINKS, ctrl, PPM, sc, _cfg(), engine,
                    Telemetry(beta=True, trace=trace))
    assert res.trace is trace
    assert len(trace.by_kind("chunk")) == res.num_launches == 4
    (cs,) = trace.by_kind("compile_stats")
    assert all(v == 0 for v in cs.data["delta"].values())


@pytest.mark.parametrize("engine", ["fused", "tiled"])
def test_dense_watermarks_equal_the_full_record(engine):
    """Chunk-merged in-kernel watermarks equal the reduction of the full
    β record (Watermarks.from_record)."""
    from repro_torch.telemetry import Watermarks
    ctrl = rc.ControllerConfig(kp=2e-8)
    ppm_b = np.random.default_rng(5).uniform(-8, 8, (2, 8)).astype(
        np.float32)
    res = _port(TOPO, LINKS, ctrl, ppm_b, _swap(), _cfg(), engine,
                Telemetry(beta=True, watermarks=True))
    full = Watermarks.from_record(res.beta, res.freq_ppm)
    np.testing.assert_array_equal(res.watermarks.peak_record,
                                  full.peak_record)
    np.testing.assert_array_equal(res.watermarks.beta_abs_max,
                                  full.beta_abs_max)
    assert res.watermarks.num_records == 20


def test_run_scenario_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.run_scenario(convert.topology(TOPO), convert.links(LINKS),
                        tc.ControllerConfig(kp=2e-8), PPM,
                        ts.Scenario(events=()), tc.SimConfig(steps=24,
                                                             record_every=12))
