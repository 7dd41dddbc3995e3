"""repro_torch.core against repro.core: topology and the segment-sum lane.

Inputs are made with numpy from a seed and handed to both packages
(``repro_torch.convert`` carries the reference's topology, links and
configs across).  The JAX side runs on the CPU as its own tests run it.

Tolerances (``tests/engine_harness.py``): frequency at every record point
within ``FREQ_ATOL_PPM``.  XLA on the CPU contracts ``a + b·c`` into one
fused multiply-add where PyTorch rounds the product first, so the two
packages differ by an ulp here and there, and ψ = Σ ν·Δ accumulates those
differences period by period.  The frequency error that follows is kp
times the error of the per-node sum, so non-converged proportional and PI
runs (|β| up to ~10² frames) use the reference's own parity gain
``PARITY_KP``; the discrete controller rounds to whole pulses and runs at
the quickstart's 2e-8.  The per-edge β records and the final ψ are
compared at ``BETA_ATOL_CROSS_FRAMES`` or, where the values are large, at
√steps float32 ulps of the largest reference value (one ulp per period,
adding up like a random walk), whichever is larger.  The PI integrator is
such a running float32 sum too, added straight onto ν: its runs hold the
frequency to ``FREQ_ATOL_PPM`` or √steps ulps of max|integ|, whichever is
larger.
Observation noise is off (``telemetry_noise_ppm=0``): the
port's ``torch.Generator`` cannot reproduce ``jax.random``'s stream.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
from engine_harness import (BETA_ATOL_CROSS_FRAMES, FREQ_ATOL_PPM,  # noqa: E402
                            PARITY_KP, assert_freq_parity)

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.frame_model import _dst_slots, _segment_sum  # noqa: E402

BUILDERS = [
    ("fully_connected", (8,)), ("fully_connected", (5,)), ("hourglass", (4,)),
    ("cube", ()), ("ring", (7,)), ("line", (6,)), ("star", (5,)),
    ("torus3d", (3,)), ("mesh2d", (3, 4)), ("random_regular", (12, 3, 1)),
]


@pytest.mark.parametrize("name,args", BUILDERS,
                         ids=[f"{n}{a}" for n, a in BUILDERS])
def test_topology_builders_match_reference(name, args):
    ref = getattr(rc, name)(*args)
    port = getattr(tc, name)(*args)
    assert port.num_nodes == ref.num_nodes and port.name == ref.name
    np.testing.assert_array_equal(port.src, ref.src)
    np.testing.assert_array_equal(port.dst, ref.dst)
    np.testing.assert_array_equal(port.in_degree, ref.in_degree)
    np.testing.assert_array_equal(port.reverse_edge_index(),
                                  ref.reverse_edge_index())
    assert port.is_connected() == ref.is_connected()


def test_make_links_matches_reference():
    topo = rc.hourglass(4)
    cable = np.random.default_rng(1).uniform(1, 50, (3, topo.num_edges))
    ref = rc.make_links(topo, cable_m=cable, beta0=0.5)
    port = tc.make_links(convert.topology(topo), cable_m=cable, beta0=0.5)
    np.testing.assert_array_equal(port.latency_s, ref.latency_s)
    np.testing.assert_array_equal(port.beta0, ref.beta0)
    assert port.num_draws == 3


def test_segment_sum_is_destination_ordered():
    """The slot-table sum equals a sequential scatter-add in edge order."""
    topo = tc.random_regular(20, 4, 3)
    vals = np.random.default_rng(0).standard_normal(
        (3, topo.num_edges)).astype(np.float32)
    want = np.zeros((3, topo.num_nodes), np.float32)
    for e in range(topo.num_edges):
        want[:, topo.dst[e]] += vals[:, e]
    got = _segment_sum(torch.from_numpy(vals),
                       torch.from_numpy(_dst_slots(topo)))
    np.testing.assert_array_equal(got.numpy(), want)


CONTROLLERS = [
    rc.ControllerConfig(kind="proportional", kp=2e-8),
    rc.ControllerConfig(kind="discrete", kp=2e-8, fs=1e-7,
                        pulses_per_update=50),
    rc.ControllerConfig(kind="pi", kp=2e-8, ki=1e-10),
]


def _both(fn_name, topo, links, ctrl, ppm, cfg, **kw):
    ref = getattr(rc, fn_name)(topo, links, ctrl, ppm, cfg, **kw)
    port = getattr(tc, fn_name)(convert.topology(topo), convert.links(links),
                                convert.controller(ctrl), ppm,
                                convert.sim_config(cfg), device="cpu", **kw)
    return ref, port


def _frames_bar(ref, steps: int) -> float:
    """BETA_ATOL_CROSS_FRAMES, or √steps ulps of max|ref| where larger."""
    top = np.float32(np.abs(ref).max(initial=0.0))
    return max(BETA_ATOL_CROSS_FRAMES,
               np.sqrt(steps) * float(np.spacing(top)))


def _assert_run_parity(port, ref):
    assert port.freq_ppm.shape == ref.freq_ppm.shape
    steps = ref.cfg.steps
    integ = np.float32(np.abs(ref.c_state["integ"]).max(initial=0.0))
    assert_freq_parity(port.freq_ppm, ref.freq_ppm, atol=max(
        FREQ_ATOL_PPM, np.sqrt(steps) * float(np.spacing(integ)) * 1e6))
    np.testing.assert_allclose(port.beta, ref.beta, rtol=0,
                               atol=_frames_bar(ref.beta, steps))
    np.testing.assert_allclose(port.psi, ref.psi, rtol=0,
                               atol=_frames_bar(ref.psi, steps))
    assert_freq_parity(port.nu * 1e6, ref.nu * 1e6, atol=max(
        FREQ_ATOL_PPM, np.sqrt(steps) * float(np.spacing(integ)) * 1e6))
    np.testing.assert_array_equal(port.c_state["c_est"], ref.c_state["c_est"])
    np.testing.assert_allclose(port.c_state["integ"], ref.c_state["integ"],
                               rtol=0, atol=np.sqrt(steps) * float(
                                   np.spacing(integ)))
    np.testing.assert_array_equal(port.times, ref.times)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "quant"])
@pytest.mark.parametrize("ctrl", CONTROLLERS, ids=lambda c: c.kind)
def test_simulate_matches_reference(ctrl, quantize):
    topo = rc.cube()
    links = rc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(5).uniform(-8, 8, 8).astype(np.float32)
    cfg = rc.SimConfig(dt=5e-5, steps=400, record_every=20,
                       quantize_beta=quantize)
    ref, port = _both("simulate", topo, links, ctrl, ppm, cfg)
    assert port.engine == "segment-sum"
    _assert_run_parity(port, ref)


@pytest.mark.parametrize("ctrl", CONTROLLERS, ids=lambda c: c.kind)
def test_ensemble_matches_reference_per_draw_everything(ctrl):
    """Per-draw kp, per-draw (B, E) links, a dropped link in edge_w and a
    per-draw holdover mask, all in one batch."""
    topo = rc.hourglass(4)
    rng = np.random.default_rng(11)
    b, e, n = 4, topo.num_edges, topo.num_nodes
    links = rc.make_links(topo, cable_m=rng.uniform(1, 40, (b, e)),
                          beta0=rng.uniform(-2, 2, (b, e)))
    gain = 2e-8 if ctrl.kind == "discrete" else PARITY_KP
    kp = (gain * rng.uniform(0.5, 1.5, b)).astype(np.float32)
    ctrl = rc.ControllerConfig(kind=ctrl.kind, kp=kp, ki=ctrl.ki, fs=ctrl.fs,
                               pulses_per_update=ctrl.pulses_per_update)
    edge_w = np.ones(e, np.float32)
    edge_w[3] = 0.0
    mask = np.ones((b, n), np.float32)
    mask[1, 2] = mask[3, 6] = 0.0
    ppm = rng.uniform(-8, 8, (b, n)).astype(np.float32)
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12,
                       quantize_beta=ctrl.kind == "discrete")
    ref, port = _both("simulate_ensemble", topo, links, ctrl, ppm, cfg,
                      edge_w=edge_w, ctrl_mask=mask)
    _assert_run_parity(port, ref)
    # Held nodes keep ν_u (holdover from the cold start).
    np.testing.assert_array_equal(port.nu[1, 2],
                                  np.float32(ppm[1, 2] * np.float32(1e-6)))


def test_init_chaining_matches_reference_and_unsplit():
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ctrl = rc.ControllerConfig(kind="pi", kp=2e-8, ki=1e-10)
    ppm = np.random.default_rng(2).uniform(-8, 8, (3, 8)).astype(np.float32)
    half = rc.SimConfig(dt=5e-5, steps=200, record_every=20)
    ref1, port1 = _both("simulate_ensemble", topo, links, ctrl, ppm, half)
    ref2 = rc.simulate_ensemble(topo, links, ctrl, ppm, half, init=ref1)
    port2 = tc.simulate_ensemble(
        convert.topology(topo), convert.links(links),
        convert.controller(ctrl), ppm, convert.sim_config(half),
        init=convert.init_state(ref1), device="cpu")
    _assert_run_parity(port2, ref2)
    # Split == unsplit, bit for bit, inside the port.
    port_chained = tc.simulate_ensemble(
        convert.topology(topo), convert.links(links),
        convert.controller(ctrl), ppm, convert.sim_config(half),
        init=port1, device="cpu")
    full = tc.simulate_ensemble(
        convert.topology(topo), convert.links(links),
        convert.controller(ctrl), ppm,
        tc.SimConfig(dt=5e-5, steps=400, record_every=20), device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([port1.freq_ppm, port_chained.freq_ppm], axis=1),
        full.freq_ppm)
    np.testing.assert_array_equal(port_chained.psi, full.psi)


def test_batched_draw_bit_identical_to_single_run():
    topo = tc.cube()
    links = tc.make_links(topo, cable_m=np.linspace(2, 30, topo.num_edges))
    rng = np.random.default_rng(4)
    ppm = rng.uniform(-8, 8, (5, 8)).astype(np.float32)
    kp = np.float32([1e-8, 2e-8, 3e-8, 2e-8, 1e-8])
    cfg = tc.SimConfig(dt=5e-5, steps=300, record_every=15,
                       quantize_beta=True)
    batch = tc.simulate_ensemble(
        topo, links, tc.ControllerConfig(kind="discrete", kp=kp, fs=1e-7,
                                         pulses_per_update=50),
        ppm, cfg, device="cpu")
    for b in (0, 3):
        one = tc.simulate(
            topo, links, tc.ControllerConfig(kind="discrete", kp=float(kp[b]),
                                             fs=1e-7, pulses_per_update=50),
            ppm[b], cfg, device="cpu")
        np.testing.assert_array_equal(one.freq_ppm, batch.freq_ppm[b])
        np.testing.assert_array_equal(one.beta, batch.beta[b])
        np.testing.assert_array_equal(one.psi, batch.psi[b])


def test_noise_is_seeded_and_zero_noise_is_exact():
    topo = tc.fully_connected(4)
    links = tc.make_links(topo)
    ppm = np.float32([1, -1, 2, -2])
    ctrl = tc.ControllerConfig(kp=2e-8)
    base = tc.SimConfig(dt=1e-3, steps=40, record_every=10)
    quiet = tc.simulate(topo, links, ctrl, ppm, base, device="cpu")
    noisy = [tc.simulate(topo, links, ctrl, ppm,
                         tc.SimConfig(dt=1e-3, steps=40, record_every=10,
                                      telemetry_noise_ppm=0.1, seed=3),
                         device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(noisy[0].freq_ppm, noisy[1].freq_ppm)
    assert 0 < np.abs(noisy[0].freq_ppm - quiet.freq_ppm).max() < 1.0
    np.testing.assert_array_equal(noisy[0].psi, quiet.psi)


def test_input_validation_mirrors_reference():
    topo = tc.fully_connected(4)
    links = tc.make_links(topo)
    with pytest.raises(ValueError, match="ppm_u"):
        tc.simulate(topo, links, tc.ControllerConfig(), np.zeros(3),
                    device="cpu")
    with pytest.raises(ValueError, match="scalar gains"):
        tc.simulate(topo, links, tc.ControllerConfig(kp=np.ones(2) * 1e-8),
                    np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="per-draw"):
        tc.simulate(topo, tc.make_links(topo, cable_m=np.ones((2, 12))),
                    tc.ControllerConfig(), np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="links carry"):
        tc.simulate_ensemble(topo, tc.make_links(topo,
                                                 cable_m=np.ones((2, 12))),
                             tc.ControllerConfig(), np.zeros((3, 4)),
                             device="cpu")
    with pytest.raises(ValueError, match="steps"):
        tc.simulate(topo, links, tc.ControllerConfig(), np.zeros(4),
                    tc.SimConfig(steps=5, record_every=10), device="cpu")
