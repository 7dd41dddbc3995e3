"""repro_torch.scenarios chaos campaigns against repro.scenarios'.

Mirrors ``tests/test_chaos.py``: seeded samplers give the reference's
events and oscillator rows; a campaign's rows equal single-draw replays
on every ported lane (segment-sum, fused, tiled, sparse); per-draw
LinkDrop victims run on the sparse lane, match segment-sum and build
nothing new on a reseed; the per-draw guard rotates only the tripping
draw (the quiet one stays bit-exact); partition-heal cycles heal inside
the envelope; triage gives the reference's verdicts for the same seeds
and every shrunk repro reproduces.  The reference runs as its own tests
run it on the CPU (segment-sum, and the sparse Pallas lane in interpret
mode); the port with ``device="cpu"``.

Tolerances: batch rows vs single-draw replays within ``FREQ_ATOL_PPM``
(ν) and ``BETA_ATOL_CROSS_FRAMES`` (β), as the reference holds them;
sparse vs segment-sum within the reference's 2e-5 ppm for LinkDrop
campaigns (re-establishment boundaries at kp = 2e-8 set a float32 floor
of a few 1e-6 ppm); verdicts exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import (BETA_ATOL_CROSS_FRAMES,  # noqa: E402
                            FREQ_ATOL_PPM)
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.telemetry import (Telemetry, launch_counts,  # noqa: E402
                                   no_new_compiles)

PORT_LANES = ["segment-sum", "fused", "tiled", "sparse"]
TOPO = tc.fully_connected(8)
LINKS = tc.make_links(TOPO, cable_m=2.0)
CTRL = tc.ControllerConfig(kp=2e-8)
VERDICTS = {ts.VERDICT_PASS, ts.VERDICT_RESCUED, ts.VERDICT_ENVELOPE,
            ts.VERDICT_OVERFLOW}


def _cfg(pkg=tc, **kw):
    base = dict(dt=1e-3, steps=240, record_every=12)
    base.update(kw)
    return pkg.SimConfig(**base)


def _campaign(pkg, num_draws=8, seed=0, engine="segment-sum", steps=240,
              ppm_lo=0.05, ppm_hi=0.5, **kw):
    """tests/test_chaos.py's campaign (FreqStep, DriftRamp, LatencyStep
    samplers on FC8) built with either package's types."""
    core = rc if pkg is rs else tc
    topo = core.fully_connected(8)
    t_hold = steps * 1e-3
    return pkg.ChaosCampaign(
        topo=topo, ctrl=core.ControllerConfig(kp=2e-8),
        samplers=(
            pkg.FreqStepSampler(t=0.15 * t_hold, ppm_range=(ppm_lo, ppm_hi)),
            pkg.DriftRampSampler(t=0.35 * t_hold, t_end=0.6 * t_hold,
                                 rate_range=(0.05, ppm_hi)),
            pkg.LatencyStepSampler(t=0.5 * t_hold,
                                   edges=pkg.edges_between(topo, 0, 1),
                                   cable_range=(5.0, 100.0)),
        ),
        num_draws=num_draws, seed=seed, ppm_range=0.05,
        links=core.make_links(topo, cable_m=2.0),
        cfg=_cfg(core, steps=steps, record_every=24), engine=engine, **kw)


def _run(ppm, sc, cfg, engine, guard=False, **kw):
    return ts.run_scenario(TOPO, LINKS, CTRL, ppm, sc, cfg,
                           options=tk.EngineOptions(engine=engine),
                           telemetry=Telemetry(beta=True, guard=guard),
                           device="cpu", **kw)


# ------------------------------------------------------------- samplers

@pytest.mark.parametrize("seed", [3, 4])
def test_samplers_equal_the_reference(seed):
    """Same seed -> the reference's oscillator rows and per-draw events
    (every draw's scalarized event prints the same); convert.scenario
    carries the reference's per-draw scenario across unchanged."""
    ref_sc, ref_ppm = _campaign(rs, seed=seed).build()
    sc, ppm = _campaign(ts, seed=seed).build()
    np.testing.assert_array_equal(ppm, ref_ppm)
    assert sc.num_draws == ref_sc.num_draws == 8
    carried = convert.scenario(ref_sc)
    for ev, ref_ev, c_ev in zip(sc.events, ref_sc.events, carried.events):
        assert type(ev).__name__ == type(ref_ev).__name__
        assert type(c_ev) is type(ev)
        for d in range(8):
            assert repr(ev.draw(d)) == repr(ref_ev.draw(d)) \
                == repr(c_ev.draw(d))


def test_linkdrop_sampler_equals_the_reference():
    ref = rs.LinkDropSampler(t=0.1, t_restore=0.16, drops=2).sample(
        np.random.default_rng(5), rc.torus3d(4), 6)
    port = ts.LinkDropSampler(t=0.1, t_restore=0.16, drops=2).sample(
        np.random.default_rng(5), tc.torus3d(4), 6)
    assert [repr(e) for e in port] == [repr(e) for e in ref]
    assert all(len(row) == 4 for row in port[0].edges)


@pytest.mark.parametrize("engine", ["fused", "tiled"])
def test_linkdrop_sampler_rejected_on_dense_lanes(engine):
    camp = ts.ChaosCampaign(
        topo=TOPO, ctrl=CTRL,
        samplers=(ts.LinkDropSampler(t=0.12, t_restore=0.24),),
        num_draws=4, links=LINKS, cfg=_cfg(), engine=engine)
    with pytest.raises(ValueError, match="segment-sum or sparse"):
        camp.run(device="cpu")


# ------------------------------------- batch vs single replay, per lane

@pytest.mark.parametrize("engine", PORT_LANES)
def test_campaign_rows_match_single_draw_replays(engine):
    camp = _campaign(ts, num_draws=6, engine=engine)
    scenario, ppm = camp.build()
    res = _run(ppm, scenario, camp.cfg, engine)
    for b in (0, 3, 5):
        single = _run(ppm[b], scenario.draw(b), camp.cfg, engine)
        np.testing.assert_allclose(res.freq_ppm[b], single.freq_ppm, rtol=0,
                                   atol=FREQ_ATOL_PPM)
        np.testing.assert_allclose(res.beta[b], single.beta, rtol=0,
                                   atol=BETA_ATOL_CROSS_FRAMES)


def test_second_campaign_builds_nothing_new():
    """A reseeded campaign (other magnitudes, victims, cable draws) selects
    no new kernel instance on any lane."""
    for engine in PORT_LANES:
        _campaign(ts, num_draws=4, seed=0, engine=engine).run(device="cpu")
    with no_new_compiles():
        for engine in PORT_LANES:
            _campaign(ts, num_draws=4, seed=9, engine=engine).run(
                device="cpu")


# ------------------------------------------- LinkDrop on the sparse lane

def _linkdrop_campaign(pkg, seed):
    core = rc if pkg is rs else tc
    topo = core.fully_connected(8)
    return pkg.ChaosCampaign(
        topo=topo, ctrl=core.ControllerConfig(kp=2e-8),
        samplers=(pkg.FreqStepSampler(t=0.06, ppm_range=(1.0, 4.0)),
                  pkg.LinkDropSampler(t=0.1, t_restore=0.16)),
        num_draws=4, seed=seed, ppm_range=8.0,
        links=core.make_links(topo, cable_m=2.0), cfg=_cfg(core))


def test_linkdrop_campaign_runs_on_sparse_and_builds_nothing_new():
    """Per-draw LinkDrop victims (per-draw slot weights) on the sparse
    lane: within 2e-5 ppm of the segment-sum lane and of the reference's
    sparse lane; a reseeded campaign builds and selects nothing new, and
    nothing launches on the CPU."""
    scenario, ppm = _linkdrop_campaign(ts, 5).build()
    res = _run(ppm, scenario, _cfg(), "sparse")
    assert res.engine == "sparse"
    seg = _run(ppm, scenario, _cfg(), "segment-sum")
    np.testing.assert_allclose(res.freq_ppm, seg.freq_ppm, rtol=0, atol=2e-5)
    ref_sc, ref_ppm = _linkdrop_campaign(rs, 5).build()
    np.testing.assert_array_equal(ppm, ref_ppm)
    ref = rs.run_scenario(rc.fully_connected(8),
                          rc.make_links(rc.fully_connected(8), cable_m=2.0),
                          rc.ControllerConfig(kp=2e-8), ref_ppm, ref_sc,
                          _cfg(rc), options=rk.EngineOptions(engine="sparse"),
                          telemetry=RefTelemetry(beta=True))
    np.testing.assert_allclose(res.freq_ppm, np.asarray(ref.freq_ppm),
                               rtol=0, atol=2e-5)
    sc2, ppm2 = _linkdrop_campaign(ts, 9).build()
    before = launch_counts()["sparse"]
    with no_new_compiles():
        _run(ppm2, sc2, _cfg(), "sparse")
    assert launch_counts()["sparse"] == before


# ------------------------------------------------- per-draw guard

@pytest.mark.parametrize("engine", ["segment-sum", "sparse"])
def test_guard_trips_only_the_drifting_draw(engine):
    """Draw 1 steps 6 ppm and trips the guard; draw 0 is quiet, keeps zero
    shifts and equals its own single-draw run bit for bit."""
    cfg = _cfg(steps=1200)
    ppm = np.zeros((2, 8), np.float32)
    sc = ts.Scenario(events=(ts.FreqStep(t=0.12, nodes=((0,), (0,)),
                                         delta_ppm=np.array([0.0, 6.0])),))
    policy = tc.ReframePolicy(depth=16, margin=4.0)
    res = _run(ppm, sc, cfg, engine, guard=policy)
    auto = [r for r in res.reframes if r.auto]
    assert auto, "the 6 ppm draw must trip the guard"
    for r in auto:
        sh = np.asarray(r.shift)
        assert sh.shape[0] == 2
        assert not (sh[0] != 0).any() and (sh[1] != 0).any()
    single = _run(ppm[0], sc.draw(0), cfg, engine, guard=policy)
    np.testing.assert_array_equal(res.freq_ppm[0], single.freq_ppm)
    np.testing.assert_array_equal(res.beta[0], single.beta)


# ------------------------------------------------- partition-heal cycles

def _heal_scenario(a, b, cycles, t0=0.12, period=0.3, outage=0.12):
    ed = ts.edges_between(TOPO, a, b)
    events = []
    for k in range(cycles):
        t = t0 + period * k
        events += [ts.LinkDrop(t=t, edges=ed),
                   ts.LinkRestore(t=t + outage, edges=ed, reestablish=True)]
    return ts.Scenario(events=tuple(events), name="heal-cycle")


@pytest.mark.parametrize("engine", ["segment-sum", "sparse"])
def test_partition_heal_cycles_fc8(engine):
    """Three drop/restore cycles of one FC8 edge pair heal back inside the
    envelope (PASS, positive margin); a second cycle scenario (other edge
    pair, other timing) selects nothing new."""
    cfg = _cfg(steps=1200)
    ppm = np.random.default_rng(3).uniform(-0.05, 0.05,
                                           8).astype(np.float32)
    res = _run(ppm, _heal_scenario(0, 2, 3), cfg, engine)
    assert np.isfinite(res.beta).all()
    verdicts, margins, _, _ = ts.triage_result(res, depth=32)
    assert verdicts[0] == ts.VERDICT_PASS and margins[0] > 0.0
    with no_new_compiles():
        res2 = _run(ppm, _heal_scenario(1, 4, 3, t0=0.24), cfg, engine)
    assert ts.triage_result(res2, depth=32)[0][0] == ts.VERDICT_PASS


# --------------------------------------------------------------- triage

def _ref_campaign_result(camp):
    return camp.run(telemetry=RefTelemetry())


@pytest.mark.parametrize("engine", ["segment-sum", "sparse"])
def test_triage_verdicts_equal_the_reference_and_shrink(engine):
    """A hot campaign: the port's verdicts equal the reference's
    segment-sum verdicts draw for draw, overflow margins are NaN, and the
    worst draw's shrunk repro reproduces its verdict standalone."""
    ref = _ref_campaign_result(_campaign(rs, num_draws=16, steps=1200,
                                         ppm_lo=0.2, ppm_hi=8.0))
    camp = _campaign(ts, num_draws=16, steps=1200, ppm_lo=0.2, ppm_hi=8.0,
                     engine=engine)
    result = camp.run(device="cpu")
    assert result.result.engine == engine
    np.testing.assert_array_equal(result.verdicts, ref.verdicts)
    assert result.counts() == ref.counts()
    assert result.counts()[ts.VERDICT_OVERFLOW] > 0
    over = result.verdicts == ts.VERDICT_OVERFLOW
    assert np.isnan(result.margins[over]).all()
    assert (result.peaks[over] > camp.depth / 2).all()
    assert 0.0 <= result.survival_rate() < 1.0
    shrunk = result.shrink()
    assert shrunk.expected_verdict == ts.VERDICT_OVERFLOW
    assert shrunk.device == "cpu" and shrunk.reproduces
    assert result.shrink().draw_index == ref.shrink().draw_index


@pytest.mark.parametrize("engine", ["segment-sum", "sparse"])
def test_triage_with_the_guard_equals_the_reference(engine):
    """With the guard on, verdicts and the guard-rotated draws equal the
    reference's on the same lane (segment-sum: the host-side guard, whose
    rescued draws triage RESCUED-BY-REFRAME with a NaN margin; sparse: the
    in-kernel guard), and a shrunk repro reproduces its verdict."""
    kw = dict(num_draws=24, steps=1200, ppm_lo=0.2, ppm_hi=8.0,
              auto_reframe=True, engine=engine)
    result = _campaign(ts, **kw).run(device="cpu")
    ref = _ref_campaign_result(_campaign(rs, **kw))
    assert result.result.engine == engine
    np.testing.assert_array_equal(result.verdicts, ref.verdicts)
    np.testing.assert_array_equal(result.reframed, ref.reframed)
    assert result.reframed.any()
    resc = np.flatnonzero(result.verdicts == ts.VERDICT_RESCUED)
    assert np.isnan(result.margins[resc]).all()
    assert result.reframed[resc].all()
    if engine == "segment-sum":
        assert resc.size > 0, "expected at least one guard rescue"
    shrunk = result.shrink(int(resc[0]) if resc.size else None)
    assert shrunk.expected_verdict == str(ref.verdicts[shrunk.draw_index])
    assert shrunk.reproduces


def test_triage_requires_beta_record():
    sc, ppm = _campaign(ts, num_draws=2).build()
    res = ts.run_scenario(TOPO, LINKS, CTRL, ppm, sc, _cfg(record_every=24),
                          options=tk.EngineOptions(engine="sparse"),
                          telemetry=Telemetry(beta=False), device="cpu")
    with pytest.raises(ValueError, match="record_beta"):
        ts.triage_result(res)


@pytest.mark.parametrize("engine", ["segment-sum", "sparse"])
def test_holdover_and_linkdrop_campaign_triage(engine):
    """Per-draw holdover victims and per-draw LinkDrop victim edges: every
    draw classifies as the reference's segment-sum run does, and the worst
    shrinks to a reproducing repro."""
    def camp(pkg, **kw):
        core = rc if pkg is rs else tc
        topo = core.fully_connected(8)
        return pkg.ChaosCampaign(
            topo=topo, ctrl=core.ControllerConfig(kp=2e-8),
            samplers=(pkg.HoldoverSampler(t=0.2, t_reset=0.5),
                      pkg.LinkDropSampler(t=0.3, t_restore=0.6)),
            num_draws=6, seed=2, ppm_range=0.05,
            links=core.make_links(topo, cable_m=2.0),
            cfg=_cfg(core, steps=960, record_every=24), **kw)

    result = camp(ts, engine=engine).run(device="cpu")
    ref = _ref_campaign_result(camp(rs))
    assert set(result.verdicts) <= VERDICTS
    np.testing.assert_array_equal(result.verdicts, ref.verdicts)
    assert result.shrink().reproduces


def test_campaign_trace_and_summary():
    """The campaign's flight recorder holds the build span, the sparse
    dispatch and one chaos_draw event per draw; the summary names the
    lane."""
    result = _campaign(ts, num_draws=3, engine="sparse").run(
        telemetry=Telemetry(trace=True), device="cpu")
    tr = result.result.trace
    assert len(tr.by_kind("chaos_draw")) == 3
    assert tr.by_kind("engine_dispatch")[0].data["engine"] == "sparse"
    assert "engine=sparse" in result.summary()
