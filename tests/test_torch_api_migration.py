"""The legacy engine kwargs on the port, mirroring tests/test_api_migration.py.

``repro_torch`` takes the reference's one-release spellings beside the
typed ``options=`` / ``telemetry=`` objects:

  * every legacy boolean kwarg (``record_beta``, ``record_watermarks``,
    ``trace``, ``auto_reframe``, ``interpret``) warns EXACTLY once per
    process, keyed on the kwarg name, from one registry
    (``repro_torch._compat``) shared by options and telemetry;
  * ``interpret=`` warns and then, when truthy, raises: the port has no
    kernel interpreter;
  * ``engine=`` / ``chunk_records=`` migrate silently;
  * the shimmed and the typed spelling give bit-identical results on
    ``run_scenario``, ``simulate_ensemble_dense`` and ``simulate_fused``;
  * wrong types fail loudly (TypeError naming the typed object);
  * ``ChaosCampaign.run`` / ``BittideNetwork.run_scenario`` pass them
    through;
  * the legacy spelling on the port agrees with the same spelling on the
    reference (ν within ``FREQ_ATOL_PPM`` at the parity gain).

Everything runs with ``device="cpu"`` (the kernels' plain versions).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import FREQ_ATOL_PPM  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._compat import reset_deprecation_warnings  # noqa: E402
from repro_torch.kernels import (EngineOptions, EngineOutputs,  # noqa: E402
                                 simulate_ensemble_dense, simulate_fused)
from repro_torch.kernels.api import resolve_options  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402
from repro_torch.telemetry.api import resolve_telemetry  # noqa: E402

TOPO = tc.fully_connected(6)
LINKS = tc.make_links(TOPO, cable_m=2.0)
CTRL = tc.ControllerConfig(kp=2e-7)
CFG = tc.SimConfig(dt=1e-3, steps=96, record_every=12)
SC = ts.Scenario(events=(ts.FreqStep(t=0.03, nodes=(0,), delta_ppm=2.0),))
CPU = "cpu"


def _ppm(n=6, seed=3):
    ppm = np.random.default_rng(seed).uniform(-0.5, 0.5, n)
    return (ppm - ppm.mean()).astype(np.float32)


def _caught(fn):
    """Run ``fn`` with a re-armed registry; return the DeprecationWarnings."""
    reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    return [w for w in rec if issubclass(w.category, DeprecationWarning)]


def _quiet(fn):
    reset_deprecation_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn()


@pytest.mark.parametrize("kwargs,token", [
    (dict(record_beta=True), "record_beta"),
    (dict(record_watermarks=True), "record_watermarks"),
    (dict(trace=True), "trace"),
    (dict(auto_reframe=True), "auto_reframe"),
])
def test_legacy_kwargs_warn_exactly_once(kwargs, token):
    ppm = _ppm()

    def go():
        ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG, device=CPU, **kwargs)
        ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG, device=CPU,
                        **kwargs)  # 2nd call

    got = _caught(go)
    assert len(got) == 1, [str(w.message) for w in got]
    assert token in str(got[0].message)
    assert "Telemetry" in str(got[0].message)


@pytest.mark.parametrize("entry", ["simulate_fused", "simulate_ensemble_dense",
                                   "run_scenario"])
def test_interpret_kwarg_warns_once_then_raises_when_truthy(entry):
    ppm = _ppm()
    call = {
        "simulate_fused": lambda **kw: simulate_fused(
            TOPO, LINKS, ppm, steps=24, kp=2e-7, record_every=12,
            device=CPU, **kw),
        "simulate_ensemble_dense": lambda **kw: simulate_ensemble_dense(
            TOPO, LINKS, ppm[None], steps=24, kp=2e-7, record_every=12,
            device=CPU, **kw),
        "run_scenario": lambda **kw: ts.run_scenario(
            TOPO, LINKS, CTRL, ppm, SC, CFG, engine="fused", device=CPU,
            **kw),
    }[entry]

    def go():
        for _ in range(2):
            with pytest.raises(ValueError, match="interpreter"):
                call(interpret=True)

    got = _caught(go)
    assert len(got) == 1
    assert "interpret" in str(got[0].message)
    assert "EngineOptions" in str(got[0].message)
    # interpret=False still warns, and runs as the typed call does.
    got = _caught(lambda: call(interpret=False))
    assert len(got) == 1 and "interpret" in str(got[0].message)
    old = _quiet(lambda: call(interpret=False))
    new = call()
    freq = lambda r: r.freq_ppm if hasattr(r, "freq_ppm") else r[0]
    np.testing.assert_array_equal(freq(new), freq(old))


def test_engine_and_chunk_kwargs_are_silent():
    ppm = _ppm()
    got = _caught(lambda: ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG,
                                          engine="fused", chunk_records=2,
                                          device=CPU))
    assert got == []
    got = _caught(lambda: simulate_fused(TOPO, LINKS, ppm, steps=24, kp=2e-7,
                                         record_every=12, engine="tiled",
                                         device=CPU))
    assert got == []


def test_shimmed_and_typed_spellings_bit_identical():
    ppm = _ppm()
    old = _quiet(lambda: ts.run_scenario(
        TOPO, LINKS, CTRL, ppm, SC, CFG, engine="fused", chunk_records=2,
        record_beta=True, record_watermarks=True, device=CPU))
    new = ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG,
                          options=EngineOptions(engine="fused",
                                                chunk_records=2),
                          telemetry=Telemetry(beta=True, watermarks=True),
                          device=CPU)
    np.testing.assert_array_equal(new.freq_ppm, old.freq_ppm)
    np.testing.assert_array_equal(new.beta, old.beta)
    np.testing.assert_array_equal(new.psi, old.psi)
    np.testing.assert_array_equal(new.watermarks.beta_abs_max,
                                  old.watermarks.beta_abs_max)
    assert new.engine == old.engine == "fused"


@pytest.mark.parametrize("engine", ["fused", "tiled", "sparse", "per-step"])
def test_dense_entry_points_shimmed_and_typed_bit_identical(engine):
    ppm = np.stack([_ppm(seed=s) for s in range(3)])
    kw = dict(steps=48, kp=2e-7, record_every=12, device=CPU)
    old = _quiet(lambda: simulate_ensemble_dense(
        TOPO, LINKS, ppm, engine=engine, record_beta=True,
        record_watermarks=True, **kw))
    new = simulate_ensemble_dense(
        TOPO, LINKS, ppm, options=EngineOptions(engine=engine),
        telemetry=Telemetry(beta=True, watermarks=True), **kw)
    for a, b in ((new[0], old[0]), (new[1], old[1]),
                 (new.nu, old.nu), (new.beta, old.beta),
                 (new.watermarks.nu_max_ppm, old.watermarks.nu_max_ppm)):
        np.testing.assert_array_equal(a, b)
    assert new.engine == old.engine == engine
    one_old = _quiet(lambda: simulate_fused(
        TOPO, LINKS, ppm[1], engine=engine, record_beta=True, **kw))
    one_new = simulate_fused(TOPO, LINKS, ppm[1],
                             options=EngineOptions(engine=engine),
                             telemetry=Telemetry(beta=True), **kw)
    np.testing.assert_array_equal(one_new[0], one_old[0])
    np.testing.assert_array_equal(one_new.beta, one_old.beta)


def test_legacy_kwarg_wins_over_typed_field():
    opts = _quiet(lambda: resolve_options(
        EngineOptions(engine="tiled", chunk_records=4), "x", engine="fused",
        interpret=False))
    assert opts == EngineOptions(engine="fused", interpret=False,
                                 chunk_records=4)
    tel = _quiet(lambda: resolve_telemetry(
        Telemetry(beta=True, watermarks=True), "x", beta=False))
    assert tel == Telemetry(beta=False, watermarks=True)
    assert resolve_options(None, "x", default_engine="segment-sum") == \
        EngineOptions(engine="segment-sum")


def test_one_registry_for_options_and_telemetry():
    def go():
        resolve_options(None, "x", interpret=False)
        resolve_telemetry(None, "x", beta=True)
        resolve_options(None, "y", interpret=False)
        resolve_telemetry(None, "y", beta=True)

    got = _caught(go)
    assert sorted(str(w.message).split("=")[0] for w in got) == [
        "interpret", "record_beta"]
    # Without a reset, neither warns again.
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resolve_options(None, "x", interpret=False)
        resolve_telemetry(None, "x", beta=True)
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]


def test_wrong_types_fail_loudly():
    ppm = _ppm()
    with pytest.raises(TypeError, match="EngineOptions"):
        ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG, options="fused",
                        device=CPU)
    with pytest.raises(TypeError, match="Telemetry"):
        ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG, telemetry=True,
                        device=CPU)
    with pytest.raises(TypeError, match="EngineOptions"):
        simulate_ensemble_dense(TOPO, LINKS, ppm[None], 24, 2e-7,
                                record_every=12, options="fused", device=CPU)
    with pytest.raises(TypeError, match="Telemetry"):
        simulate_fused(TOPO, LINKS, ppm, 24, 2e-7, record_every=12,
                       telemetry=True, device=CPU)
    with pytest.raises(TypeError, match="EngineOptions"):
        _tiny_campaign().run(options="fused", device=CPU)


def test_legacy_auto_reframe_keeps_the_beta_record():
    ppm = _ppm()
    res = _quiet(lambda: ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG,
                                         engine="fused", auto_reframe=True,
                                         device=CPU))
    assert res.beta is not None and res.beta.size > 0
    typed = ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG,
                            options=EngineOptions(engine="fused"),
                            telemetry=Telemetry(guard=True), device=CPU)
    assert typed.beta is None or typed.beta.size == 0
    np.testing.assert_array_equal(typed.freq_ppm, res.freq_ppm)
    with pytest.raises(ValueError, match="contradictory"):
        _quiet(lambda: ts.run_scenario(TOPO, LINKS, CTRL, ppm, SC, CFG,
                                       auto_reframe=True, record_beta=False,
                                       device=CPU))


def _tiny_campaign(**kw):
    return ts.ChaosCampaign(
        topo=TOPO, ctrl=CTRL, num_draws=3, seed=1, ppm_range=0.05,
        cfg=tc.SimConfig(dt=1e-3, steps=96, record_every=12),
        samplers=(ts.FreqStepSampler(t=0.03, ppm_range=(0.5, 1.5)),), **kw)


def test_chaos_campaign_typed_api():
    camp = _tiny_campaign()
    got = _caught(lambda: camp.run(record_watermarks=True, device=CPU))
    assert len(got) == 1 and "record_watermarks" in str(got[0].message)
    got = _caught(lambda: camp.run(trace=True, device=CPU))
    assert len(got) == 1 and "trace" in str(got[0].message)

    out = camp.run(telemetry=Telemetry(watermarks=True),
                   options=EngineOptions(engine="fused"), device=CPU)
    assert out.result.engine == "fused"
    assert out.result.watermarks is not None
    # The campaign force-records β for triage even though the caller's
    # Telemetry left it off.
    assert out.result.beta.size > 0
    old = _quiet(lambda: camp.run(record_watermarks=True,
                                  options=EngineOptions(engine="fused"),
                                  device=CPU))
    np.testing.assert_array_equal(old.result.freq_ppm, out.result.freq_ppm)
    np.testing.assert_array_equal(old.result.watermarks.beta_abs_max,
                                  out.result.watermarks.beta_abs_max)
    assert list(old.verdicts) == list(out.verdicts)


def test_network_run_scenario_passthrough():
    net = tc.BittideNetwork(topo=TOPO, links=LINKS, ppm_u=_ppm(), device=CPU)
    res = net.run_scenario(SC, ctrl=CTRL, cfg=CFG,
                           options=EngineOptions(engine="tiled"),
                           telemetry=Telemetry(beta=True))
    assert res.engine == "tiled"
    assert res.beta.size > 0
    got = _caught(lambda: net.run_scenario(SC, ctrl=CTRL, cfg=CFG,
                                           engine="tiled", auto_reframe=True))
    assert len(got) == 1 and "auto_reframe" in str(got[0].message)
    old = _quiet(lambda: net.run_scenario(SC, ctrl=CTRL, cfg=CFG,
                                          engine="tiled", record_beta=True))
    assert old.engine == "tiled"
    np.testing.assert_array_equal(old.freq_ppm, res.freq_ppm)
    np.testing.assert_array_equal(old.beta, res.beta)


def test_engine_outputs_named_and_positional():
    assert EngineOutputs._fields[:5] == ("psi", "nu", "freq", "beta",
                                         "watermarks")
    out = EngineOutputs(psi=1, nu=2, freq=3)
    psi, nu, freq, beta, wm, guard = out
    assert (psi, nu, freq) == (1, 2, 3)
    assert beta is None and wm is None and guard is None

    ppm = np.atleast_2d(_ppm())
    res = simulate_ensemble_dense(TOPO, LINKS, ppm, steps=24, kp=2e-7,
                                  record_every=12,
                                  telemetry=Telemetry(beta=True), device=CPU)
    freq, psi = res
    assert freq.shape == (1, 2, TOPO.num_nodes)
    assert res.beta is not None and res.beta.shape[0] == 1
    assert res.watermarks is None


@pytest.mark.parametrize("engine", ["segment-sum", "fused"])
def test_legacy_spelling_agrees_with_the_reference(engine):
    ppm = _ppm()
    rtopo = rc.fully_connected(6)
    rlinks = rc.make_links(rtopo, cable_m=2.0)
    rsc = rs.Scenario(events=(rs.FreqStep(t=0.03, nodes=(0,),
                                          delta_ppm=2.0),))
    kw = dict(engine=engine, record_beta=True)
    ref = _quiet(lambda: rs.run_scenario(
        rtopo, rlinks, rc.ControllerConfig(kp=2e-7), ppm, rsc,
        rc.SimConfig(dt=1e-3, steps=96, record_every=12), **kw))
    got = _quiet(lambda: ts.run_scenario(
        convert.topology(rtopo), convert.links(rlinks), CTRL, ppm,
        convert.scenario(rsc), CFG, device=CPU, **kw))
    assert got.engine == ref.engine == engine
    np.testing.assert_allclose(got.freq_ppm, ref.freq_ppm, rtol=0,
                               atol=FREQ_ATOL_PPM)
    assert got.beta.shape == ref.beta.shape
