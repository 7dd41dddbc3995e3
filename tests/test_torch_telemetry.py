"""repro_torch's telemetry on the dense lanes: β, watermarks, the flight
recorder and the occupancy envelopes, on the fused and the tiled lane.

Mirrors the fused/tiled rows of ``tests/test_beta_telemetry.py`` and
``tests/test_telemetry_watermarks.py``.  The reference is the JAX
package's segment-sum lane (per-edge β folded per node with
``engine_harness.node_recon``) on the same numpy draws, the port's own
dense oracle (``use_ref=True``), and reductions of the port's own full
records.

Tolerances (``tests/engine_harness.py``): β within ``BETA_ATOL_FRAMES``
and ν within ``FREQ_ATOL_PPM`` of segment-sum on ``BETA_PARITY_CASES``
(converged, |β| = O(1) frames); watermarks exactly the reduction of the
same run's full record (the same float32 values, compared as the
reference compares its own); the dense oracle within 1e-5 frames as in
the reference's ``test_beta_matches_multistep_oracle_batched``; lanes
against segment-sum on a scenario within ``BETA_ATOL_CROSS_FRAMES``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
from engine_harness import (BETA_ATOL_CROSS_FRAMES,  # noqa: E402
                            BETA_ATOL_FRAMES, BETA_PARITY_CASES,
                            FREQ_ATOL_PPM, node_recon, zero_mean_ppm)

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.envelopes import (check_occupancy_envelope,  # noqa: E402
                                        default_slack, freq_step_envelope)
from repro_torch.telemetry import (NULL_TRACE, RunTrace, Telemetry,  # noqa: E402
                                   TraceEvent, Watermarks, coerce_trace,
                                   no_new_compiles)

LANES = ["fused", "tiled"]


def _fused(topo, links, ppm, engine, telemetry=None, **kw):
    return tk.simulate_fused(topo, links, ppm, options=tk.EngineOptions(
        engine=engine), telemetry=telemetry, device="cpu", **kw)


@pytest.mark.parametrize("engine", LANES)
@pytest.mark.parametrize("case", BETA_PARITY_CASES,
                         ids=[c[0].name for c in BETA_PARITY_CASES])
def test_beta_parity_vs_reference_segment_sum(case, engine):
    """In-kernel β == the reference's segment-sum per-edge record folded
    per node, at every record point; ν at FREQ_ATOL_PPM."""
    topo, kp, ppm_scale, steps, rec = case
    links = rc.make_links(topo, cable_m=2.0)
    ppm = zero_mean_ppm(topo.num_nodes, ppm_scale)
    ref = rc.simulate(topo, links, rc.ControllerConfig(kp=kp), ppm,
                      rc.SimConfig(dt=1e-3, steps=steps, record_every=rec))
    res = _fused(convert.topology(topo), convert.links(links), ppm, engine,
                 Telemetry(beta=True), steps=steps, kp=kp, dt=1e-3,
                 record_every=rec)
    assert res.engine == engine
    assert res.beta.shape == (steps // rec, topo.num_nodes)
    np.testing.assert_allclose(res.beta, node_recon(topo, ref.beta),
                               rtol=0, atol=BETA_ATOL_FRAMES)
    np.testing.assert_allclose(res[0], ref.freq_ppm, rtol=0,
                               atol=FREQ_ATOL_PPM)


@pytest.mark.parametrize("engine", LANES)
def test_beta_and_watermarks_ride_along(engine):
    """β and watermarks observe: ν, ψ and the β record are bit-identical
    with and without them; the in-kernel watermarks equal the reduction
    of the full record, with and without that record."""
    topo, kp, scale, steps, rec = BETA_PARITY_CASES[0]
    topo = convert.topology(topo)
    links = tc.make_links(topo, cable_m=2.0)
    ppm = zero_mean_ppm(topo.num_nodes, scale)
    kw = dict(steps=steps, kp=kp, dt=1e-3, record_every=rec)
    off = _fused(topo, links, ppm, engine, **kw)
    beta = _fused(topo, links, ppm, engine, Telemetry(beta=True), **kw)
    both = _fused(topo, links, ppm, engine,
                  Telemetry(beta=True, watermarks=True), **kw)
    wm_only = _fused(topo, links, ppm, engine, Telemetry(watermarks=True),
                     **kw)
    for res in (beta, both, wm_only):
        np.testing.assert_array_equal(res[0], off[0])
        np.testing.assert_array_equal(res[1], off[1])
        np.testing.assert_array_equal(res.nu, off.nu)
    np.testing.assert_array_equal(both.beta, beta.beta)
    assert off.beta is None and wm_only.beta is None
    full = Watermarks.from_record(beta.beta, beta[0])
    for wm in (both.watermarks, wm_only.watermarks):
        np.testing.assert_array_equal(wm.peak_record, full.peak_record)
        np.testing.assert_allclose(wm.beta_abs_max, full.beta_abs_max,
                                   rtol=0, atol=BETA_ATOL_FRAMES)
        np.testing.assert_allclose(wm.nu_min_ppm, full.nu_min_ppm, rtol=0,
                                   atol=FREQ_ATOL_PPM)
        np.testing.assert_allclose(wm.nu_max_ppm, full.nu_max_ppm, rtol=0,
                                   atol=FREQ_ATOL_PPM)
        assert wm.num_records == steps // rec


@pytest.mark.parametrize("engine", LANES)
def test_beta_matches_dense_oracle_batched(engine):
    """In-kernel β == the dense oracle (use_ref) for a batch with
    per-draw gains, β_off and λeff at the setpoint."""
    topo = tc.fully_connected(8)
    links = tc.make_links(topo, cable_m=2.0, beta0=1.0)
    ppm = np.stack([zero_mean_ppm(8, 1.0, seed=s) for s in range(6)])
    kps = np.geomspace(5e-8, 2e-7, 6)
    kw = dict(steps=60, dt=1e-3, record_every=12, beta_off=1.0,
              device="cpu", telemetry=Telemetry(beta=True))
    lane = tk.simulate_ensemble_dense(
        topo, links, ppm, kp=kps, options=tk.EngineOptions(engine=engine),
        **kw)
    ref = tk.simulate_ensemble_dense(topo, links, ppm, kp=kps, use_ref=True,
                                     **kw)
    assert lane.beta.shape == (6, 5, 8) and ref.engine == "ref"
    np.testing.assert_allclose(lane.beta, ref.beta, rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", LANES)
def test_beta_at_rest_is_the_setpoint_exactly(engine):
    """Zero ppm and β_off at the λeff setpoint: no clock moves, and every
    record's per-node β is exactly in-degree × β0."""
    topo = tc.fully_connected(4)
    links = tc.make_links(topo, cable_m=2.0, beta0=2.0)
    res = _fused(topo, links, np.zeros(4, np.float32), engine,
                 Telemetry(beta=True), steps=40, kp=2e-8, beta_off=2.0,
                 dt=1e-3, record_every=10)
    np.testing.assert_array_equal(res.beta, np.full((4, 4), 6.0))
    np.testing.assert_array_equal(res[0], 0.0)


@pytest.mark.parametrize("engine", LANES)
def test_freq_step_stays_inside_closed_form_envelope(engine):
    """The FC8 FreqStep β transient recorded in-kernel stays inside the
    port's closed-form envelope, and a 10x-deflated envelope is violated;
    the equilibrium shift matches (mean(δν) − δν)/kp to 0.05 frames."""
    topo = tc.fully_connected(8)
    links = tc.make_links(topo, cable_m=2.0)
    ppm = zero_mean_ppm(8, 2.0)
    kp, dt, rec, steps, t0 = 2e-7, 1e-3, 10, 1200, 0.6
    sc = ts.Scenario(events=(ts.FreqStep(t=t0, nodes=(3,), delta_ppm=2.0),))
    res = ts.run_scenario(topo, links, tc.ControllerConfig(kp=kp), ppm, sc,
                          tc.SimConfig(dt=dt, steps=steps, record_every=rec),
                          options=tk.EngineOptions(engine=engine),
                          telemetry=Telemetry(beta=True), device="cpu")
    env = freq_step_envelope(topo, kp, dt, (3,), 2.0)
    lat_fr = float(np.max(links.latency_s) * 125e6)
    slack = default_slack(env, 1e-5, lat_fr, dt, rec)
    ok, margin = check_occupancy_envelope(res.times, res.beta, t0, env,
                                          slack)
    assert ok, f"transient escaped the closed-form envelope by {-margin}"
    tight = dataclasses.replace(env, amp=env.amp / 10.0)
    assert not check_occupancy_envelope(res.times, res.beta, t0, tight,
                                        slack / 10.0)[0]
    i0 = np.searchsorted(res.times, t0)
    np.testing.assert_allclose(res.beta[-1] - res.beta[i0 - 1], env.db_inf,
                               rtol=0, atol=0.05)


def _scenario_setup(steps=144, t0=0.072):
    topo = tc.fully_connected(8)
    links = tc.make_links(topo, cable_m=2.0)
    ctrl = tc.ControllerConfig(kp=2e-7)
    ppm = zero_mean_ppm(topo.num_nodes, 0.5, seed=5)
    scen = ts.Scenario(events=(ts.FreqStep(t=t0, nodes=(2,),
                                           delta_ppm=0.02),))
    cfg = tc.SimConfig(dt=1e-3, steps=steps, record_every=12)
    return topo, links, ctrl, ppm, scen, cfg


def _run(engine, telemetry, **opts):
    topo, links, ctrl, ppm, scen, cfg = _scenario_setup()
    return ts.run_scenario(topo, links, ctrl, ppm, scen, cfg,
                           options=tk.EngineOptions(engine=engine, **opts),
                           telemetry=telemetry, device="cpu")


def test_run_scenario_watermarks_all_lanes_agree():
    """Chunk-merged in-kernel watermarks equal their own record's
    reduction, and the dense lanes agree with the segment-sum lane's
    host-side fold."""
    tel = Telemetry(beta=True, watermarks=True)
    wms = {}
    for engine in ["segment-sum"] + LANES:
        res = _run(engine, tel)
        if engine != "segment-sum":
            full = Watermarks.from_record(res.beta, res.freq_ppm)
            np.testing.assert_array_equal(res.watermarks.peak_record,
                                          full.peak_record)
            np.testing.assert_allclose(res.watermarks.beta_abs_max,
                                       full.beta_abs_max, rtol=0,
                                       atol=BETA_ATOL_FRAMES)
        wms[engine] = res.watermarks
    for engine in LANES:
        np.testing.assert_allclose(wms[engine].beta_abs_max,
                                   wms["segment-sum"].beta_abs_max, rtol=0,
                                   atol=BETA_ATOL_CROSS_FRAMES)
        np.testing.assert_allclose(wms[engine].nu_spread_ppm,
                                   wms["segment-sum"].nu_spread_ppm, rtol=0,
                                   atol=FREQ_ATOL_PPM)
    a = _run("tiled", Telemetry(watermarks=True), chunk_records=2)
    b = _run("tiled", Telemetry(watermarks=True), chunk_records=6)
    assert a.num_launches > b.num_launches
    np.testing.assert_array_equal(a.watermarks.beta_abs_max,
                                  b.watermarks.beta_abs_max)
    np.testing.assert_array_equal(a.watermarks.peak_record,
                                  b.watermarks.peak_record)
    assert a.watermarks.num_records == b.watermarks.num_records == 12


@pytest.mark.parametrize("engine", LANES)
def test_trace_taxonomy_jsonl_roundtrip_and_no_new_builds(engine, tmp_path):
    _run(engine, Telemetry(watermarks=True))
    tr = RunTrace(name="unit")
    with no_new_compiles():
        res = _run(engine, Telemetry(watermarks=True, trace=tr))
    assert res.trace is tr
    assert {"engine_dispatch", "chunk", "compile_stats"} <= {
        e.kind for e in tr.events}
    disp = tr.by_kind("engine_dispatch")[0]
    assert disp.data["engine"] == engine and disp.data["stack_bytes"] > 0
    assert all(ch.dur is not None and ch.dur >= 0
               for ch in tr.by_kind("chunk"))
    delta = tr.by_kind("compile_stats")[0].data["delta"]
    assert all(v == 0 for v in delta.values())
    path = os.fspath(tmp_path / "trace.jsonl")
    tr.to_jsonl(path)
    back = RunTrace.from_jsonl(path)
    assert back.name == "unit" and len(back) == len(tr)
    assert [e.kind for e in back.events] == [e.kind for e in tr.events]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": "something-else/9"}\n')
    with pytest.raises(ValueError):
        RunTrace.from_jsonl(os.fspath(bad))
    assert tr.summary().startswith("RunTrace 'unit'")


def test_null_trace_coercion_and_event_data():
    assert coerce_trace(False) is NULL_TRACE and not NULL_TRACE
    tr = RunTrace()
    assert tr and len(tr) == 0
    assert coerce_trace(tr) is tr
    assert isinstance(coerce_trace(True, name="x"), RunTrace)
    with NULL_TRACE.span("chunk"):
        NULL_TRACE.event("mark")
    tr.event("mark", small=np.arange(3), big=np.zeros((100,)),
             scalar=np.float32(1.5), tensor=torch.arange(2))
    row = json.loads(tr.events[0].to_json())
    assert row["data"]["small"] == [0, 1, 2]
    assert row["data"]["big"] == {"shape": [100], "dtype": "float64"}
    assert row["data"]["scalar"] == 1.5 and row["data"]["tensor"] == [0, 1]
    with pytest.raises(Exception):
        TraceEvent(kind="mark", t=0.0).kind = "other"


def test_engine_cache_sizes_is_compile_stats():
    """The reference's original name stays an alias of ``compile_stats``,
    exported from the package (``tests/test_telemetry_watermarks.py``'s
    ``test_compile_stats_is_the_harness_guard``), and an unknown lane
    still raises."""
    import repro.telemetry as ref_tel
    import repro_torch.telemetry as tel
    from repro_torch.telemetry import compile_stats, engine_cache_sizes
    from repro_torch.telemetry.compile_stats import (
        engine_cache_sizes as module_alias)
    assert engine_cache_sizes is compile_stats is module_alias
    assert "engine_cache_sizes" in tel.__all__
    assert ("engine_cache_sizes" in ref_tel.__all__) == (
        "engine_cache_sizes" in tel.__all__)
    assert set(engine_cache_sizes()) == set(compile_stats())
    with pytest.raises(KeyError):
        no_new_compiles(nonsense=1)
