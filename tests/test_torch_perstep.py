"""repro_torch's per-step lane against repro's.

The JAX side runs as its own tests run it on the CPU: the per-step
Pallas kernel in interpret mode (``repro.kernels.bittide_step(
interpret=True)``, ``_perstep_engine(interpret=True)``, the per-step
engine of ``simulate_ensemble_dense`` / ``run_scenario``).  The port runs
``bittide_perstep``'s plain version, which the wrapper takes for CPU
tensors.  Inputs are made with numpy from a seed.

Tolerances: one period of ``ops.bittide_step`` is held to the reference
kernel test's bars (ν rtol 1e-5 / atol 1e-11, ψ rtol 1e-5 / atol 1e-4:
its random ψ of ±50 frames rounds in a different order); ν records at
every record point within ``FREQ_ATOL_PPM``; non-converged β (|β| up to
~10³ frames) within ``BETA_ULPS`` float32 ulps of the largest value or
``BETA_ATOL_CROSS_FRAMES`` (the reference centres ψ over its 128-node
padded row, the port over the N real nodes); converged β against the
segment-sum reconstruction within ``BETA_ATOL_FRAMES``; the guard's
cross-lane runs within tests/test_reframing.py's 1e-5 ppm; watermark
peak records, guard trip records, splice records and shifts exactly
equal.  The port's own claims — per-step and fused lanes bit-identical
at one draw, split vs unsplit runs bit-identical — are held exactly.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import (BETA_ATOL_CROSS_FRAMES,  # noqa: E402
                            BETA_ATOL_FRAMES, PARITY_KP, assert_beta_parity,
                            assert_freq_parity, guard_case, node_recon,
                            run_guarded, zero_mean_ppm)
from repro.kernels.ops import _perstep_engine as ref_perstep  # noqa: E402
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bittide_step import (bittide_fused_torch,  # noqa
                                              bittide_perstep)
from repro_torch.telemetry import (Telemetry, compile_stats,  # noqa: E402
                                   launch_counts, no_new_compiles)

BETA_ULPS = 8
GUARD_FREQ_ATOL_PPM = 1e-5     # tests/test_reframing.py's cross-lane bar
DT_FRAMES = 125000.0
# tests/test_kernels_bittide_step.py's topologies.
TOPOS = [rc.fully_connected(8), rc.hourglass(4), rc.cube(), rc.ring(5),
         rc.fully_connected(20), rc.random_regular(130, 3, 0),
         rc.torus3d(7)]


def _bar(*refs) -> float:
    big = max(float(np.abs(r).max()) for r in refs)
    return max(BETA_ATOL_CROSS_FRAMES,
               BETA_ULPS * float(np.spacing(np.float32(big))))


def _spool_links(topo, one_way=False):
    """2 m cables, plus 1000 m on the pair (0, 2) (or on 0 → 2 only)."""
    cable = np.full(topo.num_edges, 2.0)
    pair = (topo.src == 0) & (topo.dst == 2)
    if not one_way:
        pair |= (topo.src == 2) & (topo.dst == 0)
    cable[pair] = 1000.0
    return rc.make_links(topo, cable_m=cable)


# ------------------------------------------------ one period: bittide_step

def _rand_state(npad, seed):
    """tests/test_kernels_bittide_step.py's random state."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 50, npad).astype(np.float32),
            rng.normal(0, 1e-5, npad).astype(np.float32),
            rng.uniform(-8e-6, 8e-6, npad).astype(np.float32))


def _one_period_pair(topo, links, seed, kw, mask=None):
    a, lam, lat, npad = rk.densify(topo, links)
    psi, nu, nu_u = _rand_state(npad, seed)
    n = topo.num_nodes
    mask_pad = None
    if mask is not None:
        mask_pad = np.ones(npad, np.float32)
        mask_pad[:n] = mask
    p1, n1 = rk.bittide_step(psi, nu, nu_u, a, lam, lat, interpret=True,
                             ctrl_mask=mask_pad, **kw)
    a_t, lam_t, lat_t, _ = tk.densify(convert.topology(topo),
                                      convert.links(links), device="cpu")
    p2, n2 = tops.bittide_step(psi[:n], nu[:n], nu_u[:n], a_t, lam_t, lat_t,
                               ctrl_mask=mask, device="cpu", **kw)
    return (p1, n1), (p2, n2), n


def _assert_one_period(ref, port, n):
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1])[:n],
                               rtol=1e-5, atol=1e-11)
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0])[:n],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t.name)
def test_bittide_step_matches_reference_kernel(topo):
    kw = dict(kp=2e-9, beta_off=1.5, dt_frames=DT_FRAMES)
    ref, port, n = _one_period_pair(topo, rc.make_links(topo, cable_m=2.0),
                                    0, kw)
    _assert_one_period(ref, port, n)


@pytest.mark.parametrize("case", ["spool", "holdover"])
def test_bittide_step_two_classes_and_holdover(case):
    """The §5.6 spool (two latency classes) and a holdover mask (held
    nodes keep their ν exactly)."""
    topo = rc.fully_connected(8)
    links = _spool_links(topo) if case == "spool" else \
        rc.make_links(topo, cable_m=2.0)
    mask = None
    if case == "holdover":
        mask = np.ones(8, np.float32)
        mask[[0, 3]] = 0.0
    kw = dict(kp=2e-9, beta_off=0.0, dt_frames=DT_FRAMES)
    ref, port, n = _one_period_pair(topo, links, 1, kw, mask=mask)
    _assert_one_period(ref, port, n)
    if case == "holdover":
        nu = _rand_state(128, 1)[1]
        np.testing.assert_array_equal(port[1].numpy()[[0, 3]], nu[[0, 3]])


def test_bittide_step_oracle_lane_agrees():
    topo = rc.cube()
    a_t, lam_t, lat, n = tk.densify(
        convert.topology(topo), convert.links(rc.make_links(topo)),
        device="cpu")
    psi, nu, nu_u = _rand_state(n, 2)
    kw = dict(kp=2e-9, beta_off=0.5, dt_frames=DT_FRAMES, device="cpu")
    k = tops.bittide_step(psi, nu, nu_u, a_t, lam_t, lat, **kw)
    r = tops.bittide_step(psi, nu, nu_u, a_t, lam_t, lat, use_ref=True, **kw)
    np.testing.assert_allclose(k[1].numpy(), r[1].numpy(), rtol=1e-5,
                               atol=1e-11)
    np.testing.assert_allclose(k[0].numpy(), r[0].numpy(), rtol=1e-5,
                               atol=1e-4)


# ----------------------------------------- the lane: bit identity at B=1

@pytest.mark.parametrize("variant", [(False, False), (True, False),
                                     (False, True), (True, True)],
                         ids=["nu", "beta", "wm", "beta+wm"])
def test_perstep_lane_bit_identical_to_fused_lane(variant):
    """One draw: the per-step lane and the fused lane (both plain
    versions here) give the same bits — ν, ψ, β and watermarks."""
    topo = tc.hourglass(4)
    links = convert.links(_spool_links(rc.hourglass(4), one_way=True))
    ppm = np.random.default_rng(3).uniform(-8, 8, (1, topo.num_nodes))
    kw = dict(record_every=6, device="cpu",
              telemetry=Telemetry(beta=variant[0], watermarks=variant[1]),
              ctrl_mask=np.r_[0.0, np.ones(topo.num_nodes - 1)])
    f = tk.simulate_ensemble_dense(topo, links, ppm, 36, 2e-8,
                                   beta_off=0.7, options=tk.EngineOptions(
                                       engine="fused"), **kw)
    p = tk.simulate_ensemble_dense(topo, links, ppm, 36, 2e-8,
                                   beta_off=0.7, options=tk.EngineOptions(
                                       engine="per-step"), **kw)
    assert (p.engine, p.tile_j) == ("per-step", 0)
    np.testing.assert_array_equal(p.nu, f.nu)
    np.testing.assert_array_equal(p[0], f[0])
    np.testing.assert_array_equal(p[1], f[1])
    if variant[0]:
        np.testing.assert_array_equal(p.beta, f.beta)
    if variant[1]:
        for field in ("beta_abs_max", "peak_record", "nu_min_ppm",
                      "nu_max_ppm"):
            np.testing.assert_array_equal(getattr(p.watermarks, field),
                                          getattr(f.watermarks, field))


@pytest.mark.parametrize("stop", [7, 3], ids=["trip", "stop-cap"])
def test_perstep_guard_bit_identical_to_fused_guard(stop):
    """The guard on one draw: the trip record and every record up to the
    freeze equal the fused plain version's; frozen records re-emit the
    frozen ν with zero β."""
    topo = tc.fully_connected(8)
    a_t, _, classes, n = tk.densify(topo, tc.make_links(topo),
                                    device="cpu")
    rng = np.random.default_rng(4)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    nu_u = t(rng.uniform(-8, 8, (1, n)) * 1e-6)
    args = (torch.zeros(1, n), nu_u, nu_u.clone(), a_t, a_t.sum(dim=(0, 1)),
            t(rng.uniform(-2, 2, (1, n))), classes[None].clone(),
            t([2e-8]), t([0.3]), DT_FRAMES)
    kw = dict(num_records=8, record_every=5, record_beta=True,
              record_watermarks=True)
    base = bittide_fused_torch(*args, **kw)
    band = float((base.beta[4].abs() / args[4]).max()) * 0.999
    fused = bittide_fused_torch(*args, **kw, record_guard=True,
                                guard_lo=t([-band]), guard_hi=t([band]),
                                guard_stop=stop)
    per = bittide_perstep(*(x[0] for x in args[:3]), a_t, args[4],
                          args[5][0], classes, 2e-8, 0.3, DT_FRAMES, **kw,
                          record_guard=True, guard_lo=-band, guard_hi=band,
                          guard_stop=stop)
    trip = int(per.guard_state)
    assert trip == int(fused.guard_state[0, 0]) == (4 if stop == 7 else 8)
    last = min(trip, stop)
    torch.testing.assert_close(per.freq[:last + 1], fused.freq[:last + 1, 0],
                               rtol=0, atol=0)
    torch.testing.assert_close(per.beta[:last + 1], fused.beta[:last + 1, 0],
                               rtol=0, atol=0)
    assert torch.equal(per.psi, fused.psi[0])
    assert torch.equal(per.freq[last + 1:],
                       per.nu.expand(7 - last, n))
    assert not per.beta[last + 1:].any()


# ----------------------------------------------------------- vs reference

@pytest.mark.parametrize("topo", [rc.fully_connected(8), rc.cube(),
                                  rc.hourglass(4)], ids=lambda t: t.name)
@pytest.mark.parametrize("use_ref", [False, True], ids=["kernel", "oracle"])
def test_simulate_dense_perstep_matches_reference(topo, use_ref):
    links = rc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(7).uniform(-8, 8, topo.num_nodes)
    want = rk.simulate_dense_perstep(topo, links, ppm, 120, PARITY_KP,
                                     use_ref=use_ref)
    got = tk.simulate_dense_perstep(convert.topology(topo),
                                    convert.links(links), ppm, 120,
                                    PARITY_KP, use_ref=use_ref,
                                    device="cpu")
    assert got.engine == want.engine == "per-step"
    assert got[0].shape == (120, topo.num_nodes)
    assert_freq_parity(got[0], want[0])


def _engine_inputs(topo, seed=5):
    rng = np.random.default_rng(seed)
    links = _spool_links(topo)
    links = rc.frame_model.LinkParams(
        latency_s=links.latency_s,
        beta0=rng.uniform(-2, 2, topo.num_edges))
    n = topo.num_nodes
    mask = np.ones(n, np.float32)
    mask[1] = 0.0
    return links, dict(
        nu_u=(rng.uniform(-8, 8, n) * 1e-6).astype(np.float32), mask=mask,
        kp=float(np.float32(PARITY_KP * 7)), beta_off=0.4)


def _ref_engine(topo, links, x, records, every, guard=None):
    a, lam, lat, npad = rk.densify(topo, links)
    n = topo.num_nodes
    pad = lambda v, fill=0.0: np.pad(v, (0, npad - n), constant_values=fill)
    kw = {}
    if guard is not None:
        kw = dict(record_guard=True, guard_lo=guard[0], guard_hi=guard[1],
                  guard_stop=guard[2])
    out = ref_perstep(np.zeros(npad, np.float32), pad(x["nu_u"]),
                      pad(x["nu_u"]), pad(x["mask"], 1.0), a, lam, lat,
                      x["kp"], x["beta_off"], DT_FRAMES, records, every,
                      True, False, True, True, **kw)
    cut = lambda v: np.asarray(v)[..., :n]
    return dict(freq=cut(out.freq), beta=cut(out.beta), psi=cut(out.psi),
                wm=[cut(w) for w in out.watermarks],
                trip=None if out.guard_state is None
                else int(out.guard_state))


def _port_engine(topo, links, x, records, every, guard=None):
    a_t, lam_t, lat, _ = tk.densify(convert.topology(topo),
                                    convert.links(links), device="cpu")
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    nu_u = t(x["nu_u"])
    kw = {}
    if guard is not None:
        kw = dict(record_guard=True, guard_lo=guard[0], guard_hi=guard[1],
                  guard_stop=guard[2])
    return tops._perstep_engine(
        torch.zeros_like(nu_u), nu_u, nu_u, t(x["mask"]), a_t,
        a_t.sum(dim=(0, 1)), lam_t.sum(dim=(0, 1)), lat, x["kp"],
        x["beta_off"], DT_FRAMES, records, every, True, True, **kw)


@pytest.mark.parametrize("guard", ["off", "trip", "never", "stop-cap"])
def test_perstep_engine_matches_reference(guard):
    """``_perstep_engine`` (records, β, watermarks, the guard's trip and
    its frozen records) against the reference's in interpret mode."""
    topo = rc.hourglass(4)
    links, x = _engine_inputs(topo)
    records, every = 8, 4
    band = None
    if guard != "off":
        base = _port_engine(topo, links, x, records, every)
        deg = np.maximum(np.bincount(topo.dst, minlength=topo.num_nodes), 1)
        peak = (np.abs(base.beta.numpy()) / deg).max(axis=1)
        b = float(peak[3] * 0.999) if guard != "never" else \
            float(10 * peak.max())
        band = (-b, b, records - 1 if guard != "stop-cap" else 2)
    want = _ref_engine(topo, links, x, records, every, band)
    got = _port_engine(topo, links, x, records, every, band)
    assert_freq_parity(got.freq.numpy() * 1e6, want["freq"] * 1e6)
    bar = _bar(want["beta"], want["psi"])
    np.testing.assert_allclose(got.beta.numpy(), want["beta"], rtol=0,
                               atol=bar)
    np.testing.assert_allclose(got.psi.numpy(), want["psi"], rtol=0,
                               atol=bar)
    bmax, idx, lo, hi = (w.numpy() for w in got.watermarks)
    np.testing.assert_array_equal(idx, want["wm"][1])
    np.testing.assert_allclose(bmax, want["wm"][0], rtol=0, atol=bar)
    assert_freq_parity(lo * 1e6, want["wm"][2] * 1e6)
    assert_freq_parity(hi * 1e6, want["wm"][3] * 1e6)
    if band is not None:
        assert int(got.guard_state) == want["trip"] == \
            {"trip": 3, "never": records, "stop-cap": records}[guard]
        frozen = min(int(got.guard_state), band[2]) + 1
        assert not got.beta[frozen:].any()


def test_ensemble_per_step_per_draw_beta0_matches_reference():
    """Per-draw λeff (B, E) β0 on the per-step lane: a per-draw lamsum row
    in the port, a per-draw λeff stack in the reference."""
    topo = rc.cube()
    rng = np.random.default_rng(8)
    base = rc.make_links(topo, cable_m=2.0)
    links = rc.frame_model.LinkParams(
        latency_s=base.latency_s, beta0=rng.uniform(-2, 2,
                                                    (3, topo.num_edges)))
    ppm = rng.uniform(-8, 8, (3, 8))
    want = rk.simulate_ensemble_dense(
        topo, links, ppm, 60, PARITY_KP, record_every=12,
        options=rk.EngineOptions(engine="per-step", interpret=True),
        telemetry=RefTelemetry(beta=True, watermarks=True))
    got = tk.simulate_ensemble_dense(
        convert.topology(topo), convert.links(links), ppm, 60, PARITY_KP,
        record_every=12, options=tk.EngineOptions(engine="per-step"),
        telemetry=Telemetry(beta=True, watermarks=True), device="cpu")
    assert got.engine == want.engine == "per-step"
    assert got.tile_j == want.tile_j == 0
    assert_freq_parity(got[0], want[0])
    np.testing.assert_allclose(got.beta, want.beta, rtol=0,
                               atol=_bar(want.beta))
    np.testing.assert_array_equal(got.watermarks.peak_record,
                                  want.watermarks.peak_record)
    assert_freq_parity(got.nu * 1e6, want.nu * 1e6)


def test_auto_falls_back_to_per_step_with_the_reference_warning(monkeypatch):
    """Beyond every regime ``"auto"`` runs the per-step lane and warns as
    the reference does; per-draw edge weights stay rejected there."""
    monkeypatch.setattr(tops, "select_engine", lambda *a, **k: ("per-step",
                                                                0))
    topo = tc.cube()
    links = tc.make_links(topo)
    with pytest.warns(UserWarning, match="falling back to the per-step"):
        res = tk.simulate_ensemble_dense(topo, links, np.zeros((2, 8)), 12,
                                         2e-9, record_every=6, device="cpu")
    assert res.engine == "per-step" and res[0].shape == (2, 2, 8)
    with pytest.raises(ValueError, match="sparse or segment-sum"):
        tk.simulate_ensemble_dense(topo, links, np.zeros((2, 8)), 12, 2e-9,
                                   record_every=6, device="cpu",
                                   edge_w=np.ones((2, topo.num_edges)),
                                   options=tk.EngineOptions(
                                       engine="per-step"))


# ------------------------------------------------------------ run_scenario

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


def _port(topo, links, ctrl, ppm, sc, cfg, engine="per-step",
          telemetry=None, **opts):
    return ts.run_scenario(
        convert.topology(topo), convert.links(links),
        convert.controller(ctrl), ppm, convert.scenario(sc),
        convert.sim_config(cfg), options=tk.EngineOptions(engine=engine,
                                                          **opts),
        telemetry=telemetry, device="cpu")


@pytest.mark.parametrize("batched", [False, True], ids=["single", "B=3"])
def test_cable_swap_matches_reference_per_step(batched):
    """tests/test_scenarios.py's cable-swap parity case on the per-step
    lane: ν within FREQ_ATOL_PPM of the reference's per-step lane and of
    its segment-sum lane, the λ tables and the launches equal."""
    ctrl = rc.ControllerConfig(kp=PARITY_KP)
    ppm = (np.stack([PPM, PPM[::-1], 0.5 * PPM]) if batched else PPM)
    ref = rs.run_scenario(TOPO, LINKS, ctrl, ppm, _swap(), _cfg(),
                          options=rk.EngineOptions(engine="per-step"),
                          telemetry=RefTelemetry(beta=True))
    seg = rs.run_scenario(TOPO, LINKS, ctrl, ppm, _swap(), _cfg())
    port = _port(TOPO, LINKS, ctrl, ppm, _swap(), _cfg(),
                 telemetry=Telemetry(beta=True))
    assert port.engine == ref.engine == "per-step"
    assert port.tile_j == 0 and port.num_launches == ref.num_launches
    assert port.freq_ppm.shape == ref.freq_ppm.shape == seg.freq_ppm.shape
    assert_freq_parity(port.freq_ppm, ref.freq_ppm)
    assert_freq_parity(port.freq_ppm, seg.freq_ppm)
    np.testing.assert_array_equal(port.lam, ref.lam)
    np.testing.assert_allclose(port.beta, ref.beta, rtol=0,
                               atol=_bar(ref.beta))


@pytest.mark.parametrize("reestablish", [False, True],
                         ids=["lam-preserved", "reestablish"])
def test_beta_through_latency_step_matches_segment_sum(reestablish):
    """tests/test_beta_telemetry.py's per-step row: in-kernel β through a
    cable swap equals the reference's segment-sum reconstruction at every
    record point (converged regime)."""
    ppm = zero_mean_ppm(8, 0.5)
    ctrl = rc.ControllerConfig(kp=2e-7)
    ref = rs.run_scenario(TOPO, LINKS, ctrl, ppm, _swap(reestablish), _cfg())
    res = _port(TOPO, LINKS, ctrl, ppm, _swap(reestablish), _cfg(),
                telemetry=Telemetry(beta=True))
    assert_beta_parity(res.beta, node_recon(TOPO, ref.beta),
                       atol=BETA_ATOL_FRAMES)


def test_split_runs_bit_identical_and_equal_fused():
    """A Mark-split run and a one-record-per-call run reproduce the
    unsplit per-step run bit for bit, which equals the fused lane's."""
    ctrl = rc.ControllerConfig(kp=2e-8)
    ppm = np.stack([PPM, PPM[::-1]])
    tel = Telemetry(beta=True, watermarks=True)
    plain = _port(TOPO, LINKS, ctrl, ppm, rs.Scenario(events=()), _cfg(),
                  telemetry=tel)
    marked = _port(TOPO, LINKS, ctrl, ppm,
                   rs.Scenario(events=(rs.Mark(t=0.12),)), _cfg(),
                   telemetry=tel)
    ones = _port(TOPO, LINKS, ctrl, ppm, rs.Scenario(events=()), _cfg(),
                 telemetry=tel, chunk_records=1)
    fused = _port(TOPO, LINKS, ctrl, ppm, rs.Scenario(events=()), _cfg(),
                  "fused", telemetry=tel)
    assert marked.num_launches == 2 and ones.num_launches == 20
    for other in (marked, ones, fused):
        for name in ("freq_ppm", "beta", "psi", "nu"):
            np.testing.assert_array_equal(getattr(other, name),
                                          getattr(plain, name),
                                          err_msg=name)
        np.testing.assert_array_equal(other.watermarks.peak_record,
                                      plain.watermarks.peak_record)


def test_guard_lane_matches_reference_fused():
    """The harness's guard-on lane on per-step: the trip records, the
    spliced shifts and the one-record guard latency are identical to the
    reference's fused lane."""
    topo, links, ctrl, ppm, sc, cfg, pol = guard_case()
    ref = run_guarded(topo, links, ctrl, ppm, sc, cfg, "fused", pol)
    port = _port(topo, links, ctrl, ppm, sc, cfg,
                 telemetry=Telemetry(beta=True,
                                     guard=convert.reframe_policy(pol)))
    assert port.engine == "per-step" and len(port.reframes) >= 1
    assert all(r.guard_latency == 1 and r.auto for r in port.reframes)
    assert ([(r.record, np.asarray(r.shift).tolist()) for r in port.reframes]
            == [(r.record, np.asarray(r.shift).tolist())
                for r in ref.reframes])
    np.testing.assert_array_equal(port.lam_final, ref.lam_final)
    assert_freq_parity(port.freq_ppm, ref.freq_ppm, atol=GUARD_FREQ_ATOL_PPM)


def test_guard_resync_matches_reference_per_step_and_fused():
    """Draws whose guard trips at different records: the per-step lane's
    host resync lands the batch at the earliest trip, so the splices
    equal the reference per-step lane's and the port's fused lane's (bit
    for bit on the port)."""
    topo, links, ctrl, ppm1, sc, cfg, pol = guard_case()
    ppm = np.stack([ppm1, 0.5 * ppm1, ppm1[::-1]]).astype(np.float32)
    sc = rs.Scenario(events=(rs.DriftRamp(
        t=0.06, t_end=0.3, nodes=(0, 1),
        rate_ppm_per_s=np.array([40.0, 25.0, 60.0])),))
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="per-step"),
                          telemetry=RefTelemetry(beta=True, guard=pol))
    tel = Telemetry(beta=True, guard=convert.reframe_policy(pol))
    port = _port(topo, links, ctrl, ppm, sc, cfg, telemetry=tel)
    fused = _port(topo, links, ctrl, ppm, sc, cfg, "fused", telemetry=tel)
    splices = lambda r: [(x.record, np.asarray(x.shift).tolist())
                         for x in r.reframes]
    assert len(port.reframes) >= 2
    # Not every draw rotates at every splice: the trips differed.
    assert any(not np.asarray(x.shift)[i].any() for x in port.reframes
               for i in range(3))
    assert splices(port) == splices(ref) == splices(fused)
    assert_freq_parity(port.freq_ppm, ref.freq_ppm, atol=GUARD_FREQ_ATOL_PPM)
    for name in ("freq_ppm", "beta", "psi", "nu"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(fused, name), err_msg=name)


def test_long_horizon_guard_matches_reference_fused():
    """tests/test_reframing.py's FC8 drift-and-swap case on per-step:
    splice records and shifts identical to the reference's fused lane."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ppm = zero_mean_ppm(8, 1.0)
    ctrl = rc.ControllerConfig(kp=2e-8)
    cfg = rc.SimConfig(dt=1e-3, steps=720, record_every=12)
    sc = rs.Scenario(events=(
        rs.DriftRamp(t=0.06, t_end=0.54, nodes=(0, 1, 2),
                     rate_ppm_per_s=7.5),
        rs.LatencyStep(t=0.6, edges=rs.edges_between(topo, 0, 2),
                       cable_m=1000.0)), name="fc8-drift-swap")
    pol = rc.ReframePolicy(depth=16, margin=4.0)
    ref = rs.run_scenario(topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="fused"),
                          telemetry=RefTelemetry(beta=True, guard=pol))
    res = _port(topo, links, ctrl, ppm, sc, cfg,
                telemetry=Telemetry(beta=True,
                                    guard=convert.reframe_policy(pol)))
    assert len(res.reframes) == len(ref.reframes) >= 3
    for a, b in zip(ref.reframes, res.reframes):
        assert a.record == b.record and b.guard_latency == 1
        np.testing.assert_array_equal(a.shift, b.shift)
    assert_freq_parity(res.freq_ppm, ref.freq_ppm, atol=GUARD_FREQ_ATOL_PPM)
    deg = np.bincount(topo.dst, minlength=8)
    assert np.abs(res.beta / deg).max() < 16


def test_chaos_linkdrop_rejected_and_campaign_replays():
    """Chaos on per-step: LinkDrop victims are rejected with the
    reference's redirect; a FreqStep campaign's rows equal single-draw
    replays."""
    camp = ts.ChaosCampaign(
        topo=tc.fully_connected(8), ctrl=tc.ControllerConfig(kp=2e-8),
        samplers=(ts.LinkDropSampler(t=0.12, t_restore=0.24),),
        num_draws=4, cfg=tc.SimConfig(dt=1e-3, steps=240, record_every=12),
        engine="per-step")
    with pytest.raises(ValueError, match="segment-sum or sparse"):
        camp.run(device="cpu")
    camp = ts.ChaosCampaign(
        topo=tc.fully_connected(8), ctrl=tc.ControllerConfig(kp=2e-8),
        samplers=(ts.FreqStepSampler(t=0.06, ppm_range=(0.05, 0.5)),),
        num_draws=3, cfg=tc.SimConfig(dt=1e-3, steps=120, record_every=12),
        engine="per-step")
    scenario, ppm = camp.build()
    res = camp.run(device="cpu").result
    assert res.engine == "per-step"
    single = ts.run_scenario(camp.topo, camp.links, camp.ctrl, ppm[1],
                             scenario.draw(1), camp.cfg,
                             options=tk.EngineOptions(engine="per-step"),
                             telemetry=Telemetry(beta=True), device="cpu")
    np.testing.assert_array_equal(res.freq_ppm[1], single.freq_ppm)


def test_compile_stats_per_step_and_flat_gain_sweep():
    """The per-step lane selects one instance per variant, and a gain
    sweep selects and builds nothing new (gains are kernel arguments,
    where the reference keys a compile on each gain); on the CPU nothing
    launches."""
    topo = tc.cube()
    links = tc.make_links(topo)
    ppm = np.random.default_rng(0).uniform(-8, 8, (2, 8))
    opts = tk.EngineOptions(engine="per-step")
    tk.simulate_ensemble_dense(topo, links, ppm, 24, 2e-9, record_every=12,
                               options=opts, device="cpu")
    assert compile_stats()["per-step"] >= 1
    before = launch_counts()
    with no_new_compiles():
        for kp in (1e-9, 3e-9, 7e-9):
            tk.simulate_ensemble_dense(topo, links, ppm, 24, kp,
                                       beta_off=kp * 1e9, record_every=12,
                                       options=opts, device="cpu")
    assert launch_counts() == before
    assert compile_stats()["builds"] == 0
    with no_new_compiles(**{"per-step": 1}):
        tk.simulate_ensemble_dense(topo, links, ppm, 24, 2e-9,
                                   record_every=12, options=opts,
                                   device="cpu",
                                   telemetry=Telemetry(watermarks=True))


def test_wrapper_validates_its_inputs():
    n = 4
    x = torch.zeros(n)
    a = torch.zeros(1, n, n)
    ok = (x, x, x, a, x, x, torch.zeros(1), 1e-9, 0.0, 1.0)
    kw = dict(num_records=1, record_every=1)
    bittide_perstep(*ok, **kw)
    with pytest.raises(ValueError, match="lamsum"):
        bittide_perstep(*ok[:5], torch.zeros(1, n), *ok[6:], **kw)
    with pytest.raises(TypeError, match="float32"):
        bittide_perstep(x.double(), *ok[1:], **kw)
    with pytest.raises(ValueError, match="guard_lo"):
        bittide_perstep(*ok, **kw, record_guard=True)
    with pytest.raises(ValueError, match="num_records"):
        bittide_perstep(*ok, num_records=0, record_every=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bittide_perstep(*ok, **kw, ctrl_mask=torch.ones(n))
