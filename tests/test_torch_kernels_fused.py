"""repro_torch's fused lane against repro's: kernel, runners, dispatch.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode (``interpret=True`` / ``EngineOptions(engine="fused",
interpret=True)``) or its plain oracle (``use_ref=True``).  The port runs
its kernel's plain version, ``bittide_fused_torch``, which the wrapper
takes for CPU tensors.  Inputs are made with numpy from a seed.

Tolerances (``tests/engine_harness.py``): ν at every record point within
``FREQ_ATOL_PPM``; β within ``BETA_ATOL_FRAMES`` on ``BETA_PARITY_CASES``
(converged, |β| = O(1) frames).  The kernel-level matrix runs at the
reference's parity gain with ±8 ppm draws, random λeff folds and setpoints,
so it does not converge and |β| reaches ~10³ frames; there β is held to
``BETA_ULPS`` float32 ulps of max|β|: the measure pass sums deg ≤ 6
centred phase terms of that size, and the two packages round those sums
in different orders (XLA also contracts products into fused multiply-adds
where PyTorch does not).  Watermark ``peak_record`` is exactly equal to
the reference's, and to the port's own full-record argmax; in a converged
run |β| plateaus, and a node whose two largest reference records lie
within the β bar of each other is a tie that float32 rounding decides —
there the port's record must reach the reference maximum within the bar.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
from engine_harness import (BETA_ATOL_FRAMES, BETA_PARITY_CASES,  # noqa: E402
                            FREQ_ATOL_PPM, PARITY_KP, PARITY_REC,
                            PARITY_STEPS, PARITY_TOPOS, assert_beta_parity,
                            assert_freq_parity, zero_mean_ppm)
from repro.kernels.bittide_step import bittide_fused_pallas  # noqa: E402
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bittide_step import (bittide_fused,  # noqa: E402
                                              bittide_fused_torch)
from repro_torch.telemetry import (Telemetry, compile_stats,  # noqa: E402
                                   launch_counts, no_new_compiles)

BETA_ULPS = 8
DT_FRAMES = 125000.0           # dt = 1e-3 s at 125 MHz
KERNEL_TOPOS = [t for t in PARITY_TOPOS
                if t.name in ("fully_connected_8", "hourglass_8", "cube",
                              "torus3d_4")]
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
VARIANT_IDS = ["nu", "beta", "wm", "beta+wm"]


def _ulp_bar(ref) -> float:
    return BETA_ULPS * float(np.spacing(np.float32(np.abs(ref).max())))


def _assert_peak_records(port, ref, atol: float):
    """peak_record: exact where the reference's peak is distinct, and
    within ``atol`` of the reference maximum where its top records tie."""
    wm = port.watermarks
    np.testing.assert_array_equal(wm.peak_record,
                                  np.abs(port.beta).argmax(axis=-2))
    babs = np.abs(ref.beta)
    top2 = np.sort(babs, axis=-2)[..., -2:, :]
    distinct = top2[..., 1, :] - top2[..., 0, :] > atol
    np.testing.assert_array_equal(wm.peak_record[distinct],
                                  ref.watermarks.peak_record[distinct])
    picked = np.take_along_axis(babs, wm.peak_record[..., None, :],
                                axis=-2)[..., 0, :]
    np.testing.assert_allclose(picked, babs.max(axis=-2), rtol=0, atol=atol)


def _two_class_links(topo):
    """2 m cables, plus 1000 m on both directions of the pair (0, 1)."""
    cable = np.full(topo.num_edges, 2.0)
    pair = ((topo.src == 0) & (topo.dst == 1)) | (
        (topo.src == 1) & (topo.dst == 0))
    cable[pair] = 1000.0
    return rc.make_links(topo, cable_m=cable)


def _kernel_inputs(topo, b: int = 5, seed: int = 0):
    """Per-draw kp, β_off, class latencies, λeff folds and holdover mask."""
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    links = _two_class_links(topo)
    a_t, _, classes, _ = tk.densify(convert.topology(topo),
                                    convert.links(links), device="cpu")
    assert a_t.shape[0] == 2
    mask = np.ones((b, n), np.float32)
    mask[1, [0, n - 1]] = 0.0
    mask[3, 2] = 0.0
    return dict(
        links=links, a_t=a_t.numpy(),
        nu_u=(rng.uniform(-8, 8, (b, n)).astype(np.float32)
              * np.float32(1e-6)),
        kp=(PARITY_KP * rng.uniform(0.5, 1.5, b)).astype(np.float32),
        beta_off=rng.uniform(-1, 1, b).astype(np.float32),
        lamsum=rng.uniform(-2, 2, (b, n)).astype(np.float32),
        lat=(classes.numpy()[None, :]
             * rng.uniform(0.99, 1.01, (b, 1))).astype(np.float32),
        mask=mask)


_REF_CACHE: dict = {}


def _reference_kernel(topo):
    """bittide_fused_pallas (interpret) on padded inputs, all outputs on."""
    if topo.name not in _REF_CACHE:
        x = _kernel_inputs(topo)
        b, n = x["nu_u"].shape
        a, _, _, n_pad = rk.densify(topo, x["links"])
        b_pad = 8
        pad = lambda v, fill=0.0: np.pad(
            v, ((0, b_pad - b), (0, n_pad - n)), constant_values=fill)
        out = bittide_fused_pallas(
            np.zeros((b_pad, n_pad), np.float32), pad(x["nu_u"]),
            pad(x["nu_u"]), np.asarray(a), np.asarray(a).sum(axis=(0, 2)),
            pad(x["lamsum"]), np.pad(x["lat"], ((0, b_pad - b), (0, 0)),
                                     mode="edge"),
            np.pad(x["kp"], (0, b_pad - b)),
            np.pad(x["beta_off"], (0, b_pad - b)), DT_FRAMES,
            num_records=PARITY_STEPS // PARITY_REC, record_every=PARITY_REC,
            ctrl_mask=pad(x["mask"], 1.0), record_beta=True,
            record_watermarks=True, interpret=True)
        cut = lambda v: np.asarray(v)[..., :b, :n]
        _REF_CACHE[topo.name] = (x, dict(
            psi=cut(out.psi), nu=cut(out.nu), freq=cut(out.freq),
            beta=cut(out.beta), wm=[cut(w) for w in out.watermarks]))
    return _REF_CACHE[topo.name]


def _port_kernel(x, record_beta, record_watermarks):
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    a_t = t(x["a_t"])
    b, n = x["nu_u"].shape
    return bittide_fused(torch.zeros(b, n), t(x["nu_u"]), t(x["nu_u"]), a_t,
              a_t.sum(dim=(0, 1)), t(x["lamsum"]), t(x["lat"]), t(x["kp"]),
              t(x["beta_off"]), DT_FRAMES,
              num_records=PARITY_STEPS // PARITY_REC,
              record_every=PARITY_REC, ctrl_mask=t(x["mask"]),
              record_beta=record_beta, record_watermarks=record_watermarks)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("topo", KERNEL_TOPOS, ids=lambda t: t.name)
def test_plain_version_matches_pallas_kernel(topo, variant):
    """bittide_fused (CPU: the plain version) vs bittide_fused_pallas in
    interpret mode: two classes, per-draw kp / β_off / lat / lamsum /
    holdover mask, every variant."""
    record_beta, record_wm = variant
    x, ref = _reference_kernel(topo)
    out = _port_kernel(x, record_beta, record_wm)
    assert_freq_parity(out.freq.numpy() * 1e6, ref["freq"] * 1e6)
    assert_freq_parity(out.nu.numpy() * 1e6, ref["nu"] * 1e6)
    np.testing.assert_allclose(out.psi.numpy(), ref["psi"], rtol=0,
                               atol=_ulp_bar(ref["psi"]))
    assert (out.beta is not None) == record_beta
    if record_beta:
        np.testing.assert_allclose(out.beta.numpy(), ref["beta"], rtol=0,
                                   atol=_ulp_bar(ref["beta"]))
    assert (out.watermarks is not None) == record_wm
    if record_wm:
        bmax, idx, lo, hi = (w.numpy() for w in out.watermarks)
        np.testing.assert_array_equal(idx, ref["wm"][1])
        np.testing.assert_allclose(bmax, ref["wm"][0], rtol=0,
                                   atol=_ulp_bar(ref["wm"][0]))
        assert_freq_parity(lo * 1e6, ref["wm"][2] * 1e6)
        assert_freq_parity(hi * 1e6, ref["wm"][3] * 1e6)
    # Held nodes keep their ν: draw 1's nodes 0 and N-1 never move.
    np.testing.assert_array_equal(out.nu.numpy()[1, 0], x["nu_u"][1, 0])


def test_variants_do_not_change_the_state():
    """β and watermarks observe: ν records and final state are the same
    bits with every variant."""
    x, _ = _reference_kernel(KERNEL_TOPOS[0])
    outs = [_port_kernel(x, *v) for v in VARIANTS]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.freq.numpy(), outs[0].freq.numpy())
        np.testing.assert_array_equal(o.psi.numpy(), outs[0].psi.numpy())


def _dense_pair(topo, ppm, steps, rec, kp, telemetry, dt=1e-3, **kw):
    """The reference's and the port's simulate_ensemble_dense, fused lane."""
    links = kw.pop("links", rc.make_links(topo, cable_m=2.0))
    ref = rk.simulate_ensemble_dense(
        topo, links, ppm, steps, kp, dt=dt, record_every=rec,
        options=rk.EngineOptions(engine="fused", interpret=True),
        telemetry=RefTelemetry(beta=telemetry.beta,
                               watermarks=telemetry.watermarks), **kw)
    port = tk.simulate_ensemble_dense(
        convert.topology(topo), convert.links(links), ppm, steps, kp,
        dt=dt, record_every=rec,
        options=tk.EngineOptions(engine="fused"), telemetry=telemetry,
        device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("topo", [rc.fully_connected(8), rc.torus3d(4)],
                         ids=lambda t: t.name)
def test_ensemble_dense_matches_reference_and_segment_sum(topo):
    rng = np.random.default_rng(3)
    b, n = 3, topo.num_nodes
    ppm = rng.uniform(-8, 8, (b, n)).astype(np.float32)
    kp = (PARITY_KP * np.float32([0.5, 1.0, 1.5])).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[2] = 0.0
    links = _two_class_links(topo)
    ref, port = _dense_pair(topo, ppm, PARITY_STEPS, PARITY_REC, kp,
                            Telemetry(watermarks=True), links=links,
                            ctrl_mask=mask)
    assert port.engine == "fused" and port[0].shape == ref[0].shape
    assert_freq_parity(port[0], ref[0])
    assert_freq_parity(port.nu * 1e6, ref.nu * 1e6)
    np.testing.assert_array_equal(port.watermarks.peak_record,
                                  ref.watermarks.peak_record)
    segsum = rc.simulate_ensemble(
        topo, links, rc.ControllerConfig(kp=kp), ppm,
        rc.SimConfig(dt=1e-3, steps=PARITY_STEPS, record_every=PARITY_REC,
                     record_beta=False), ctrl_mask=mask)
    assert_freq_parity(port[0], segsum.freq_ppm)


@pytest.mark.parametrize("case", BETA_PARITY_CASES,
                         ids=lambda c: c[0].name)
def test_beta_parity_cases(case):
    """Converged regime: β within BETA_ATOL_FRAMES of the reference's fused
    kernel at every record, ν within FREQ_ATOL_PPM."""
    topo, kp, scale, steps, rec = case
    ppm = zero_mean_ppm(topo.num_nodes, scale)[None]
    ref, port = _dense_pair(topo, ppm, steps, rec, kp,
                            Telemetry(beta=True, watermarks=True))
    assert_freq_parity(port[0], ref[0])
    assert_beta_parity(port.beta, ref.beta)
    _assert_peak_records(port, ref, BETA_ATOL_FRAMES)
    np.testing.assert_allclose(port.watermarks.beta_abs_max,
                               ref.watermarks.beta_abs_max, rtol=0,
                               atol=BETA_ATOL_FRAMES)


def test_simulate_fused_and_use_ref_match_reference():
    topo = rc.hourglass(4)
    links = rc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(8).uniform(-8, 8, 8).astype(np.float32)
    kw = dict(steps=PARITY_STEPS, kp=PARITY_KP, dt=1e-3,
              record_every=PARITY_REC)
    ref = rk.simulate_fused(topo, links, ppm, use_ref=True, **kw)
    port = tk.simulate_fused(convert.topology(topo), convert.links(links),
                             ppm, use_ref=True, device="cpu", **kw)
    assert port.engine == "ref" and port[0].shape == ref[0].shape
    assert_freq_parity(port[0], ref[0])
    fused = tk.simulate_fused(convert.topology(topo), convert.links(links),
                              ppm, device="cpu", **kw)
    assert_freq_parity(fused[0], ref[0])
    # Per-period telemetry.
    dense = tk.simulate_dense(convert.topology(topo), convert.links(links),
                              ppm, 24, PARITY_KP, device="cpu")
    assert dense[0].shape == (24, 8)
    np.testing.assert_array_equal(dense[0][11], fused[0][0])


def test_init_chaining_split_equals_unsplit():
    topo = tc.fully_connected(8)
    links = tc.make_links(topo)
    ppm = np.random.default_rng(1).uniform(-8, 8, (2, 8)).astype(np.float32)
    tel = Telemetry(beta=True)
    kw = dict(kp=2e-8, dt=5e-5, record_every=20, telemetry=tel,
              device="cpu")
    full = tk.simulate_ensemble_dense(topo, links, ppm, 400, **kw)
    first = tk.simulate_ensemble_dense(topo, links, ppm, 200, **kw)
    second = tk.simulate_ensemble_dense(topo, links, ppm, 200, init=first,
                                        **kw)
    np.testing.assert_array_equal(
        np.concatenate([first[0], second[0]], axis=1), full[0])
    np.testing.assert_array_equal(
        np.concatenate([first.beta, second.beta], axis=1), full.beta)
    np.testing.assert_array_equal(second.nu, full.nu)


def test_watermarks_peak_record_with_ties():
    """kp = 0 and ν_u = 0 hold every state still: β is the same at every
    record, each node's peak ties across all records, and the first
    record (0) must win — exactly as the reference and np.argmax say."""
    topo = rc.cube()
    beta0 = np.random.default_rng(2).uniform(-3, 3, topo.num_edges)
    links = rc.make_links(topo, cable_m=2.0, beta0=beta0)
    ppm = np.zeros((2, 8), np.float32)
    ref, port = _dense_pair(topo, ppm, 60, 12, 0.0,
                            Telemetry(beta=True, watermarks=True),
                            links=links)
    np.testing.assert_array_equal(port.watermarks.peak_record, 0)
    np.testing.assert_array_equal(port.watermarks.peak_record,
                                  ref.watermarks.peak_record)
    np.testing.assert_array_equal(
        port.watermarks.peak_record,
        np.abs(port.beta).argmax(axis=1))
    assert_beta_parity(port.watermarks.beta_abs_max,
                       ref.watermarks.beta_abs_max)


def test_padding_nodes_and_draws_are_inert():
    """Nodes of degree 0 and draws at rest, padded onto the kernel's
    inputs by hand (the reference pads to 128-node tiles and 8-draw
    quanta; the port pads nothing), leave the real slice's bits unchanged
    and never move themselves."""
    topo = tc.hourglass(4)
    links = convert.links(_two_class_links(topo))
    ppm = np.random.default_rng(6).uniform(-8, 8, (3, 8)).astype(np.float32)
    a_t8, _, classes, n = tops.densify(topo, links, device="cpu")
    assert n == 8
    c = a_t8.shape[0]
    a_t = torch.zeros(c, 16, 16)
    a_t[:, :8, :8] = a_t8
    nu_u = np.zeros((4, 16), np.float32)
    nu_u[:3, :8] = ppm * np.float32(1e-6)
    lat = torch.from_numpy(np.broadcast_to(classes.numpy(), (4, c)).copy())
    kp = torch.tensor([2e-8, 2e-8, 2e-8, 0.0])
    lamsum = torch.zeros(4, 16)
    lamsum[:3, :8] = torch.from_numpy(tops._lamsum_host(
        topo, np.ones((1, topo.num_edges)), None, 1))
    mask = torch.ones(1, 16)
    kw = dict(num_records=5, record_every=10, record_beta=True,
              record_watermarks=True)
    nu_t = torch.from_numpy(nu_u)
    padded = bittide_fused_torch(
        torch.zeros_like(nu_t), nu_t, nu_t, a_t, a_t.sum(dim=(0, 1)),
        lamsum, lat, kp, torch.zeros(4), DT_FRAMES, ctrl_mask=mask, **kw)
    sl = (slice(0, 3), slice(0, 8))
    plain = bittide_fused_torch(
        torch.zeros(3, 8), nu_t[sl].contiguous(), nu_t[sl].contiguous(),
        a_t8, a_t8.sum(dim=(0, 1)), lamsum[sl].contiguous(),
        lat[:3].contiguous(), kp[:3].contiguous(), torch.zeros(3),
        DT_FRAMES, ctrl_mask=mask[:, :8].contiguous(), **kw)
    np.testing.assert_array_equal(padded.freq[:, :3, :8].numpy(),
                                  plain.freq.numpy())
    np.testing.assert_array_equal(padded.psi[:3, :8].numpy(),
                                  plain.psi.numpy())
    np.testing.assert_array_equal(padded.watermarks[1][:3, :8].numpy(),
                                  plain.watermarks[1].numpy())
    # Padded nodes and the padded draw stay at rest.
    assert not padded.psi[:, 8:].any() and not padded.nu[:, 8:].any()
    assert not padded.psi[3].any() and not padded.beta[:, :, 8:].any()
    # The β record is ψ-centred over all 16 columns here, over 8 in the
    # unpadded run.  β is invariant to that shift up to the rounding of
    # ψ − mean, an ulp of |ψ| for each summed term.
    np.testing.assert_allclose(padded.beta[:, :3, :8].numpy(),
                               plain.beta.numpy(), rtol=0,
                               atol=_ulp_bar(plain.psi.numpy()))


def test_gain_lamsum_and_mask_sweeps_build_nothing_new():
    topo = tc.fully_connected(8)
    links = tc.make_links(topo)
    ppm = np.random.default_rng(0).uniform(-8, 8, (4, 8)).astype(np.float32)
    tel = Telemetry(beta=True)
    kw = dict(dt=1e-3, record_every=12, telemetry=tel, device="cpu")
    tk.simulate_ensemble_dense(topo, links, ppm, 24, 2e-9, **kw)
    before = launch_counts()["fused"]
    with no_new_compiles():
        for kp in (1e-9, 3e-9, np.float32([1e-9, 2e-9, 3e-9, 4e-9])):
            tk.simulate_ensemble_dense(topo, links, ppm, 24, kp, **kw)
        for b0 in (0.5, -1.0):   # lamsum sweep (λeff fold)
            tk.simulate_ensemble_dense(
                topo, tc.make_links(topo, beta0=b0), ppm, 24, 2e-9, **kw)
        mask = np.ones(8, np.float32)
        mask[3] = 0
        tk.simulate_ensemble_dense(topo, links, ppm, 24, 2e-9,
                                   ctrl_mask=mask, **kw)
    assert launch_counts()["fused"] == before   # CPU: plain version only
    with no_new_compiles(fused=1):   # a new variant is a new instance
        tk.simulate_ensemble_dense(topo, links, ppm, 24, 2e-9, dt=1e-3,
                                   record_every=12, device="cpu",
                                   telemetry=Telemetry(beta=True,
                                                       watermarks=True))
    assert compile_stats()["builds"] == 0


@pytest.mark.parametrize("engine", ["per-step"])
def test_unported_lanes_raise(engine):
    """The lanes that raised until their kernel was ported now run (at one
    draw with the fused lane's bits); an unknown lane name raises."""
    topo = tc.fully_connected(8)
    ppm = np.random.default_rng(0).uniform(-8, 8, (1, 8))
    kw = dict(record_every=10, device="cpu")
    res = tk.simulate_ensemble_dense(
        topo, tc.make_links(topo), ppm, 20, 2e-9,
        options=tk.EngineOptions(engine=engine), **kw)
    fused = tk.simulate_ensemble_dense(
        topo, tc.make_links(topo), ppm, 20, 2e-9,
        options=tk.EngineOptions(engine="fused"), **kw)
    assert res.engine == engine
    np.testing.assert_array_equal(res[0], fused[0])
    with pytest.raises(ValueError, match="unknown engine"):
        tk.simulate_ensemble_dense(
            topo, tc.make_links(topo), ppm, 20, 2e-9,
            options=tk.EngineOptions(engine=engine + "-x"), **kw)


def test_auto_outside_fused_regime_and_per_draw_edge_w_raise():
    """Above the fused regime "auto" takes the tiled lane (it raised until
    the tiled kernel was ported); per-draw edge weights on a dense lane
    raise the reference's redirect to the sparse or segment-sum engine,
    and the interpreter switch raises."""
    topo = tc.random_regular(300, 3, 0)
    res = tk.simulate_ensemble_dense(topo, tc.make_links(topo),
                                     np.zeros((1, 300)), 10, 2e-9,
                                     record_every=10, device="cpu")
    assert res.engine == "tiled" and res.tile_j == tk.TILE_J
    assert tk.select_engine(1, 2**17 + 1, 1)[0] == "per-step"
    small = tc.fully_connected(4)
    with pytest.raises(ValueError, match="sparse or segment-sum"):
        tk.simulate_ensemble_dense(small, tc.make_links(small),
                                   np.zeros((2, 4)), 10, 2e-9,
                                   record_every=10, device="cpu",
                                   edge_w=np.ones((2, 12)))
    with pytest.raises(ValueError, match="interpreter"):
        tk.simulate_ensemble_dense(
            small, tc.make_links(small), np.zeros((1, 4)), 10, 2e-9,
            record_every=10, device="cpu",
            options=tk.EngineOptions(interpret=True))


@pytest.mark.parametrize("b,n,c,want", [
    (4096, 8, 1, "fused"), (256, 216, 2, "fused"), (1, 256, 8, "fused"),
    (1, 257, 1, "tiled"), (8, 64, 9, "tiled")])
def test_h100_regime_table(b, n, c, want):
    assert tk.select_engine(b, n, c)[0] == want


def test_draws_per_cta_fills_the_card():
    from repro_torch.kernels.bittide_step import draws_per_cta
    assert draws_per_cta(4096, 8, 132) == 7      # 586 CTAs of 56 threads
    assert draws_per_cta(64, 8, 132) == 1
    assert draws_per_cta(256, 216, 132) == 1


def test_wrapper_checks_inputs():
    x, _ = _reference_kernel(KERNEL_TOPOS[0])
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    a_t = t(x["a_t"])
    args = [torch.zeros(5, 8), t(x["nu_u"]), t(x["nu_u"]), a_t,
            a_t.sum(dim=(0, 1)), t(x["lamsum"]), t(x["lat"]), t(x["kp"]),
            t(x["beta_off"]), DT_FRAMES]
    kw = dict(num_records=2, record_every=3)
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].double()
    with pytest.raises(TypeError, match="float32"):
        bittide_fused(*bad_dtype, **kw)
    bad_shape = list(args)
    bad_shape[7] = bad_shape[7][:4]
    with pytest.raises(ValueError, match="kp"):
        bittide_fused(*bad_shape, **kw)
    strided = list(args)
    strided[5] = torch.zeros(8, 5).t()
    with pytest.raises(ValueError, match="contiguous"):
        bittide_fused(*strided, **kw)
    with pytest.raises(ValueError, match="ctrl_mask"):
        bittide_fused(*args, ctrl_mask=torch.ones(8), **kw)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_float32_floor_at_the_quickstart_gain_is_the_reference_s():
    """At the quickstart's gain and period (kp = 2e-8, dt = 5e-5) with
    ±8 ppm draws, |ψ| reaches ~10² frames and an ulp of ψ moves ν by
    kp·ulp(deg·|ψ|) ≈ 1e-12: FREQ_ATOL_PPM no longer separates float32
    implementations.  The reference's own fused lane leaves it against the
    reference's segment-sum lane (its err cancels sums of size deg·|ψ|),
    and the two packages' segment-sum lanes round ψ differently (XLA
    fuses ψ + ν·Δ into one multiply-add).  Every pair stays inside
    chip_smoke's float32 floor."""
    topo = rc.fully_connected(8)
    links = rc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (4096, 8)).astype(
        np.float32)[:4]
    steps, rec, kp, dt = 2000, 20, 2e-8, 5e-5
    cfg = rc.SimConfig(dt=dt, steps=steps, record_every=rec,
                       record_beta=False)
    ref_ss = rc.simulate_ensemble(topo, links, rc.ControllerConfig(kp=kp),
                                  ppm, cfg)
    port_ss = tc.simulate_ensemble(
        convert.topology(topo), convert.links(links),
        tc.ControllerConfig(kp=kp), ppm, convert.sim_config(cfg),
        device="cpu")
    ref_f, port_f = _dense_pair(topo, ppm, steps, rec, kp, Telemetry(),
                                dt=dt, links=links)
    floor = _chip_smoke().float32_floor_ppm(
        kp, 7, float(np.abs(ref_f[1]).max()))
    ref_dev = np.abs(ref_f[0] - ref_ss.freq_ppm).max()
    assert ref_dev > FREQ_ATOL_PPM          # the reference's own floor
    for got, want in ((ref_f[0], ref_ss.freq_ppm),
                      (port_f[0], port_ss.freq_ppm),
                      (port_ss.freq_ppm, ref_ss.freq_ppm),
                      (port_f[0], ref_f[0])):
        assert_freq_parity(got, want, atol=floor)
