"""The port's sparse ELL lane against the reference's.

The same numpy-seeded inputs go through ``repro.kernels`` (the Pallas
sparse kernel in interpret mode, as the reference's own tests run it on
the CPU, and its segment-sum simulator) and ``repro_torch`` with
``device="cpu"`` (the kernel's plain version, ``bittide_sparse_torch``).
Mirrors ``tests/test_sparse_engine.py``: the ELL table layout and its
errors, always-padded slots bit for bit, random bounded-degree graphs
(isolated nodes, leaves, a node at max degree), isolated nodes holding
ν_u, per-draw edge weights equal to per-draw single runs, the error
contracts; plus the sparse regime of ``select_engine`` and ``"auto"``,
the sparse rows of the β and watermark matrices, and ``run_scenario``
on the sparse lane (cable swap, guarded torus).

Tolerances (``tests/engine_harness.py``): ν at every record point within
``FREQ_ATOL_PPM`` at the parity gain; β within ``BETA_ATOL_CROSS_FRAMES``
of segment-sum (the reference's own bar for its sparse lane).  Against
the reference's sparse kernel, β is held to ``BETA_ULPS`` float32 ulps of
the largest value (or ``BETA_ATOL_FRAMES`` in the converged cases): the
reference centres ψ by the mean of its padded row (N rounded up to 128,
padded nodes at ψ = 0), the port by a two-level ordered mean over the N
real nodes (ROADMAP §3).  The port's own bit-identity claims (padded
slots, batched vs single, shared vs per-draw tables) are held exactly.
"""
import importlib.util
import random
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
import repro.scenarios as rs  # noqa: E402
from engine_harness import (BETA_ATOL_CROSS_FRAMES,  # noqa: E402
                            BETA_ATOL_FRAMES, BETA_PARITY_CASES,
                            FREQ_ATOL_PPM, PARITY_KP, bounded_degree_topo,
                            guard_case, node_recon, parity_ppm,
                            random_latency_links, zero_mean_ppm)
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.bittide_sparse import (MEAN_CHUNK,  # noqa: E402
                                                bittide_sparse,
                                                bittide_sparse_torch, ellify,
                                                max_in_degree)
from repro_torch.telemetry import (Telemetry, compile_stats,  # noqa: E402
                                   launch_counts, no_new_compiles)

BETA_ULPS = 8
SPARSE = tk.EngineOptions(engine="sparse")


def _topo(ref_topo):
    return convert.topology(ref_topo)


def _port_dense(topo, links, ppm, steps, kp, rec, engine="sparse", **kw):
    return tk.simulate_ensemble_dense(
        _topo(topo), convert.links(links), np.atleast_2d(ppm), steps, kp,
        dt=1e-3, record_every=rec, options=tk.EngineOptions(engine=engine),
        device="cpu", **kw)


def _ulps(x, count=BETA_ULPS):
    return count * float(np.spacing(np.float32(np.abs(x).max())))


def _beta_bar(ref_beta, psi):
    """β bar against the reference or segment-sum outside the converged
    regime: the measure pass sums deg centred phase terms of size |ψ|,
    which the packages round in different orders."""
    return max(BETA_ATOL_CROSS_FRAMES, _ulps(ref_beta), _ulps(psi))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ ellify layout

def test_ellify_matches_reference_tables():
    """The port's tables are the reference's without its node padding:
    same slot of every edge, same latencies and weights, padding slots
    self-indexed at weight 0, slot degree = in-degree."""
    ref_topo = bounded_degree_topo(24, 4, 1, isolated=2, leaves=2)
    lat = np.arange(ref_topo.num_edges, dtype=np.float64) + 1.0
    nbr, latf, w = ellify(_topo(ref_topo), lat)
    r_nbr, r_latf, r_w = (np.asarray(x) for x in rk.ellify(ref_topo, lat))
    n = ref_topo.num_nodes
    k = max_in_degree(_topo(ref_topo))
    assert k == rk.max_in_degree(ref_topo)
    assert nbr.shape == (k, n) and latf.shape == (1, k, n) \
        and w.shape == (1, k, n)
    assert nbr.dtype == np.int32 and latf.dtype == np.float32
    np.testing.assert_array_equal(nbr, r_nbr[:, :n])
    np.testing.assert_array_equal(latf, r_latf[:, :, :n])
    np.testing.assert_array_equal(w, r_w[:, :, :n])
    live = w[0] == 1.0
    got = sorted(zip(nbr[live].tolist(), np.nonzero(live)[1].tolist(),
                     latf[0][live].tolist()))
    want = sorted(zip(np.asarray(ref_topo.src).tolist(),
                      np.asarray(ref_topo.dst).tolist(), lat.tolist()))
    assert got == want
    pad = ~live
    np.testing.assert_array_equal(nbr[pad], np.nonzero(pad)[1])
    np.testing.assert_array_equal(latf[0][pad], 0.0)
    np.testing.assert_array_equal(w[0].sum(axis=0), ref_topo.in_degree)


def test_ellify_per_draw_tables_and_errors():
    ref_topo = rc.fully_connected(4)
    topo = _topo(ref_topo)
    e = topo.num_edges
    lat_b = np.tile(np.arange(e, dtype=np.float64), (3, 1))
    w_b = np.ones((3, e))
    w_b[1, 0] = 0.0
    nbr, latf, w = ellify(topo, lat_b, edge_w=w_b)
    assert latf.shape == (3, 3, 4) and w.shape == (3, 3, 4)
    assert float(w[1].sum()) == e - 1
    np.testing.assert_array_equal(
        w, np.asarray(rk.ellify(ref_topo, lat_b, edge_w=w_b)[2])[..., :4])
    for call, match in (
            (lambda f: f(np.zeros(e + 1)), "lat_frames"),
            (lambda f: f(np.zeros(e), edge_w=np.zeros(e - 1)), "edge_w"),
            (lambda f: f(np.zeros(e), max_deg=max_in_degree(topo) - 1),
             "max_deg")):
        with pytest.raises(ValueError, match=match) as got:
            call(lambda *a, **k: ellify(topo, *a, **k))
        with pytest.raises(ValueError, match=match) as want:
            call(lambda *a, **k: rk.ellify(ref_topo, *a, **k))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------- kernel bit-exactness

def _kernel_args(topo, b=8, seed=0, tables=None, per_draw=False):
    """Plain-version arguments: ν_u in ±8 ppm, ψ = 0, cables of 1..50 m
    (every edge its own latency), per-draw gains near the parity gain and
    λeff folds in ±2 frames."""
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    lat_f = tc.make_links(topo, cable_m=rng.uniform(
        1.0, 50.0, topo.num_edges)).latency_s * tc.OMEGA_NOM
    if tables is None:
        tables = ellify(topo, np.tile(lat_f, (b, 1)) if per_draw else lat_f)
    nbr, latf, w = (torch.as_tensor(x) for x in tables)
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    nu_u = put(rng.uniform(-8e-6, 8e-6, (b, n)))
    return (torch.zeros_like(nu_u), nu_u.clone(), nu_u, nbr, latf, w,
            put(rng.uniform(-2, 2, (b, n))), put(PARITY_KP * rng.uniform(
                0.5, 1.5, b)), put(rng.uniform(-1, 1, b)), 125e3), lat_f


def _variants(args, kw):
    """ν only, β, watermarks, β + watermarks, and the guard with bands
    that trip at records 1..2 and that never trip."""
    base = bittide_sparse_torch(*args, **kw, record_beta=True)
    deg = args[5].sum(dim=1).clamp(min=1.0)
    peak = (base.beta.abs() / deg).amax(dim=2)                  # (R, B)
    b = args[0].shape[0]
    trips = torch.stack([peak[1 + i % 2, i] * 0.999 for i in range(b)])
    quiet = torch.full((b,), float(peak.max()) * 10)
    out = [dict(record_beta=x, record_watermarks=y)
           for x, y in ((False, False), (True, False), (False, True),
                        (True, True))]
    for band in (trips, quiet):
        out.append(dict(record_beta=True, record_watermarks=True,
                        record_guard=True, guard_lo=-band.contiguous(),
                        guard_hi=band.contiguous(),
                        guard_stop=kw["num_records"] - 1))
    return out


def _assert_outputs_equal(a, b):
    """Bit for bit, NaN records (after a guard freeze) included."""
    same = lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy())
    same(a.freq, b.freq)
    same(a.psi, b.psi)
    same(a.nu, b.nu)
    for x, y in ((a.beta, b.beta), (a.guard_state, b.guard_state)):
        assert (x is None) == (y is None)
        if x is not None:
            same(x, y)
    if a.watermarks is not None:
        for x, y in zip(a.watermarks, b.watermarks):
            same(x, y)


@pytest.mark.parametrize("variant", range(6), ids=[
    "nu", "beta", "wm", "beta+wm", "guard_trips", "guard_quiet"])
def test_extra_padded_slots_are_bit_exact(variant):
    """K = max_deg + 2 always-padded slots give bit-identical results in
    every variant: a padding slot gathers a valid address and adds 0.0."""
    topo = _topo(bounded_degree_topo(32, 3, 2))
    args, lat_f = _kernel_args(topo)
    loose, _ = _kernel_args(topo, tables=ellify(
        topo, lat_f, max_deg=max_in_degree(topo) + 2))
    kw = dict(num_records=4, record_every=3)
    v = _variants(args, kw)[variant]
    a = bittide_sparse(*args, **kw, **v)
    b = bittide_sparse(*loose, **kw, **v)
    assert loose[3].shape[0] == args[3].shape[0] + 2
    _assert_outputs_equal(a, b)
    if variant == 4:
        assert int(a.guard_state.min()) < 3
        assert torch.isnan(a.freq[int(a.guard_state.min()) + 1:]).all()
    if variant == 5:
        assert (a.guard_state == 4).all()


def test_shared_and_per_draw_tables_equal():
    """Shared (1, K, N) tables and the same tables repeated per draw give
    bit-identical draws; a draw run alone equals its row of the batch."""
    topo = _topo(rc.random_regular(300, 3, 0))
    args, lat_f = _kernel_args(topo, b=9)
    per_draw, _ = _kernel_args(topo, b=9, per_draw=True)
    kw = dict(num_records=3, record_every=2, record_beta=True,
              record_watermarks=True)
    a = bittide_sparse(*args, **kw)
    _assert_outputs_equal(a, bittide_sparse(*per_draw, **kw))
    one = [x[4:5].contiguous() if i in (0, 1, 2, 6, 7, 8) else x
           for i, x in enumerate(args)]
    solo = bittide_sparse(*one, **kw)
    assert torch.equal(a.freq[:, 4:5], solo.freq)
    assert torch.equal(a.beta[:, 4:5], solo.beta)


def test_row_mean_order_is_two_level():
    """Above MEAN_CHUNK nodes the measure pass centres ψ by the ordered
    chunk sums; the ν stream does not depend on it, β only in rounding."""
    from repro_torch.kernels.bittide_sparse import _row_mean
    rng = np.random.default_rng(3)
    n = 2 * MEAN_CHUNK + 77
    psi = torch.as_tensor(rng.uniform(-500, 500, (2, n)).astype(np.float32))
    want = torch.zeros(2)
    for c in range(0, n, MEAN_CHUNK):
        part = torch.zeros(2)
        for j in range(c, min(n, c + MEAN_CHUNK)):
            part = part + psi[:, j]
        want = want + part
    got = _row_mean(psi, torch.tensor(float(n)))
    assert torch.equal(got, want / torch.tensor(float(n)))


@pytest.mark.parametrize("ref_topo", [rc.random_regular(300, 3, 0),
                                      bounded_degree_topo(96, 4, 3)],
                         ids=["random_regular_300", "bounded_degree_96"])
def test_plain_version_matches_reference_sparse_kernel(ref_topo):
    """One call of the plain version against ``bittide_sparse_pallas``
    (interpret mode) on the reference's padded inputs, β and watermarks
    on: ν within FREQ_ATOL_PPM, β within the centring bar."""
    topo = _topo(ref_topo)
    args, lat_f = _kernel_args(topo)
    b, n = args[0].shape
    n_pad = -(-n // 128) * 128
    pad = lambda x: np.pad(x.numpy(), ((0, 0), (0, n_pad - n)))
    nbr_r, latf_r, w_r = rk.ellify(ref_topo, lat_f)
    ref = rk.bittide_sparse_pallas(
        pad(args[0]), pad(args[1]), pad(args[2]), nbr_r, latf_r, w_r,
        pad(args[6]), args[7].numpy(), args[8].numpy(), 125e3,
        num_records=4, record_every=3, record_beta=True,
        record_watermarks=True, interpret=True)
    got = bittide_sparse(*args, num_records=4, record_every=3,
                         record_beta=True, record_watermarks=True)
    ref_freq = np.asarray(ref.freq)[:, :, :n] * 1e6
    np.testing.assert_allclose(got.freq.numpy() * 1e6, ref_freq, rtol=0,
                               atol=max(FREQ_ATOL_PPM, _ulps(ref_freq, 2)))
    ref_beta = np.asarray(ref.beta)[:, :, :n]
    ref_psi = np.asarray(ref.psi)[:, :n]
    np.testing.assert_allclose(got.beta.numpy(), ref_beta, rtol=0,
                               atol=_beta_bar(ref_beta, ref_psi))
    np.testing.assert_allclose(got.psi.numpy(), ref_psi, rtol=0,
                               atol=_ulps(ref_psi))


# ------------------------------------------------ random-graph parity

def _reference_property_draws(name, examples=3):
    """The draws hypcompat's fallback runner replays for the reference's
    property test ``name`` (its seed is the test's name), in its keyword
    order, so the port runs on the same random graphs as the reference."""
    rng = random.Random(zlib.crc32(name.encode()))
    return [(rng.randint(12, 40), rng.randint(1, 5), rng.randint(0, 2**16),
             rng.randint(0, 2**16), rng.random() < 0.5)
            for _ in range(examples)]


# Examples on which the reference's own property test has failed (its β
# 2.1–2.3e-5 frames from segment-sum, against BETA_ATOL_CROSS_FRAMES):
# (n, max_deg, gseed, lseed), each with both latency kinds.  The third
# failed with heterogeneous latencies at 2.2888e-5 frames, and hypothesis
# replayed it from its example database on every later run; the fourth
# failed with few-class latencies at 2.098e-5 frames, replayed so too, as
# was the sixth (few-class latencies, 2.0981e-5 frames).
REFERENCE_FAILING_EXAMPLES = ((36, 4, 31405, 55738), (34, 5, 1, 0),
                              (17, 4, 36449, 13), (22, 5, 0, 188),
                              (12, 5, 0, 1), (22, 5, 8645, 35885))


@pytest.mark.parametrize(
    "n,max_deg,gseed,lseed,heterogeneous", _reference_property_draws(
        "test_sparse_matches_segment_sum_on_random_graphs")
    + [ex + (het,) for ex in REFERENCE_FAILING_EXAMPLES
       for het in (False, True)])
def test_sparse_matches_reference_on_random_graphs(n, max_deg, gseed, lseed,
                                                   heterogeneous):
    """Random bounded-degree digraphs with an isolated node, a leaf and a
    node at max_deg, few-class and fully heterogeneous latencies: the
    port's sparse lane against the reference's sparse lane and its
    segment-sum simulator at every record point — ν to FREQ_ATOL_PPM, β
    to ``_beta_bar`` of segment-sum.  Besides hypcompat's three draws, the
    examples on which the reference's own test has failed."""
    ref_topo = bounded_degree_topo(max(n, max_deg + 4), max_deg, gseed,
                                   isolated=1, leaves=1)
    links = random_latency_links(ref_topo, lseed,
                                 heterogeneous=heterogeneous)
    ppm = parity_ppm(ref_topo, seed=gseed % 97)
    kp, steps, rec = PARITY_KP, 48, 12
    seg = rc.simulate(ref_topo, links, rc.ControllerConfig(kp=kp), ppm,
                      rc.SimConfig(dt=1e-3, steps=steps, record_every=rec,
                                   record_beta=True))
    ref = rk.simulate_fused(ref_topo, links, ppm, steps=steps, kp=kp,
                            dt=1e-3, record_every=rec,
                            options=rk.EngineOptions(engine="sparse"))
    port = _port_dense(ref_topo, links, ppm, steps, kp, rec,
                       telemetry=Telemetry(beta=True))
    assert port.engine == "sparse" and ref.engine == "sparse"
    for want in (np.asarray(ref[0]), np.asarray(seg.freq_ppm)):
        np.testing.assert_allclose(port[0][0], want, rtol=0,
                                   atol=FREQ_ATOL_PPM)
    recon = node_recon(ref_topo, seg.beta)
    np.testing.assert_allclose(port.beta[0], recon, rtol=0,
                               atol=_beta_bar(recon, seg.psi))


def test_isolated_nodes_hold_their_oscillator():
    ref_topo = bounded_degree_topo(16, 3, 0, isolated=2, leaves=2)
    links = rc.make_links(ref_topo, cable_m=2.0)
    ppm = parity_ppm(ref_topo, seed=3)
    seg = rc.simulate(ref_topo, links, rc.ControllerConfig(kp=PARITY_KP), ppm,
                      rc.SimConfig(dt=1e-3, steps=48, record_every=12))
    res = _port_dense(ref_topo, links, ppm, 48, PARITY_KP, 12)
    np.testing.assert_allclose(res[0][0], seg.freq_ppm, rtol=0,
                               atol=FREQ_ATOL_PPM)
    np.testing.assert_allclose(res[0][0][:, -2:],
                               np.broadcast_to(ppm[-2:], (4, 2)), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------ per-draw edge data

def test_per_draw_edge_weights_match_per_draw_singles():
    """A (B, E) edge_w batch (each draw dropping a different link) equals
    B single runs with that draw's (E,) weights — bit for bit on the port,
    within the bars against the reference's sparse lane."""
    ref_topo = rc.fully_connected(6)
    links = rc.make_links(ref_topo, cable_m=2.0)
    b, e = 4, ref_topo.num_edges
    ppm = np.stack([parity_ppm(ref_topo, seed=s) for s in range(b)])
    w_b = np.ones((b, e))
    for d in range(b):
        w_b[d, d * 3] = 0.0
    kw = dict(telemetry=Telemetry(beta=True))
    batch = _port_dense(ref_topo, links, ppm, 48, PARITY_KP, 12, edge_w=w_b,
                        **kw)
    ref = rk.simulate_ensemble_dense(
        ref_topo, links, ppm, 48, PARITY_KP, dt=1e-3, record_every=12,
        edge_w=w_b, options=rk.EngineOptions(engine="sparse"),
        telemetry=RefTelemetry(beta=True))
    assert batch.engine == "sparse"
    np.testing.assert_allclose(batch[0], np.asarray(ref[0]), rtol=0,
                               atol=FREQ_ATOL_PPM)
    np.testing.assert_allclose(batch.beta, np.asarray(ref.beta), rtol=0,
                               atol=_beta_bar(ref.beta, ref[1]))
    for d in range(b):
        single = _port_dense(ref_topo, links, ppm[d], 48, PARITY_KP, 12,
                             edge_w=w_b[d], **kw)
        np.testing.assert_array_equal(batch[0][d], single[0][0])
        np.testing.assert_array_equal(batch.beta[d], single.beta[0])


def test_per_draw_heterogeneous_latencies_on_sparse():
    """Fully heterogeneous per-draw (B, E) latencies run on the sparse lane
    (the dense lanes refuse them) and match the segment-sum lane."""
    ref_topo = rc.cube()
    rng = np.random.default_rng(4)
    cables = rng.uniform(1.0, 60.0, (3, ref_topo.num_edges))
    lat = np.stack([rc.make_links(ref_topo, cable_m=c).latency_s
                    for c in cables])
    links = tc.LinkParams(latency_s=lat,
                          beta0=np.zeros(ref_topo.num_edges))
    ppm = np.stack([parity_ppm(ref_topo, seed=s) for s in range(3)])
    res = tk.simulate_ensemble_dense(_topo(ref_topo), links, ppm, 48,
                                     PARITY_KP, dt=1e-3, record_every=12,
                                     options=SPARSE, device="cpu")
    seg = tc.simulate_ensemble(_topo(ref_topo), links,
                               tc.ControllerConfig(kp=PARITY_KP), ppm,
                               tc.SimConfig(dt=1e-3, steps=48,
                                            record_every=12), device="cpu")
    np.testing.assert_allclose(res[0], seg.freq_ppm, rtol=0,
                               atol=FREQ_ATOL_PPM)
    with pytest.warns(UserWarning, match="merging"), \
            pytest.raises(ValueError, match="class structure"):
        tk.simulate_ensemble_dense(_topo(ref_topo), links, ppm, 48,
                                   PARITY_KP, record_every=12,
                                   options=tk.EngineOptions(engine="fused"),
                                   device="cpu")


def test_sparse_lane_error_contracts():
    """use_ref has no sparse oracle; per-draw edge_w on a dense lane raises
    the reference's segment-sum/sparse redirect; the wrapper checks its
    tables."""
    topo = tc.fully_connected(4)
    links = tc.make_links(topo, cable_m=2.0)
    ppm = np.zeros((2, 4), np.float32)
    w_b = np.ones((2, topo.num_edges))
    with pytest.raises(ValueError, match="use_ref"):
        tk.simulate_ensemble_dense(topo, links, ppm, 12, 2e-9,
                                   options=SPARSE, use_ref=True,
                                   device="cpu")
    for engine in ("fused", "tiled"):
        with pytest.raises(ValueError, match="segment-sum"):
            tk.simulate_ensemble_dense(
                topo, links, ppm, 12, 2e-9, edge_w=w_b, device="cpu",
                options=tk.EngineOptions(engine=engine))
    with pytest.raises(ValueError, match=r"\(B, E\)"):
        tk.simulate_ensemble_dense(topo, links, ppm, 12, 2e-9,
                                   edge_w=np.ones((3, 12)), options=SPARSE,
                                   device="cpu")
    args, _ = _kernel_args(topo, b=2)
    kw = dict(num_records=1, record_every=1)
    with pytest.raises(ValueError, match="nbr"):
        bittide_sparse(*args[:3], args[3][:, :2].contiguous(), *args[4:],
                       **kw)
    with pytest.raises(ValueError, match="latf"):
        bittide_sparse(*args[:4], args[4][0], *args[5:], **kw)
    with pytest.raises(ValueError, match="w must be"):
        bittide_sparse(*args[:5], args[5].repeat(3, 1, 1), *args[6:], **kw)
    with pytest.raises(TypeError, match="int32"):
        bittide_sparse(*args[:3], args[3].long(), *args[4:], **kw)
    with pytest.raises(ValueError, match="guard_lo"):
        bittide_sparse(*args, **kw, record_guard=True)


# ------------------------------------------------------------- dispatch

@pytest.mark.parametrize("b,n,c,max_deg,want", [
    (8, 128, 1, 6, "fused"), (8, 256, 2, 6, "fused"),
    (8, 512, 1, 6, "tiled"), (8, 2**17, 1, 6, "tiled"),
    (8, 2**17 + 1, 1, 6, "sparse"), (8, 2**17 + 1, 1, None, "per-step"),
    (8, 10**6, 1, 6, "sparse"), (4096, 10**6, 1, 6, "per-step"),
    (8, 10**6, 1, 10**5, "per-step")])
def test_select_engine_sparse_regime(b, n, c, max_deg, want):
    """The degree bound never reroutes a network a dense lane holds; past
    the tiled budget (N > 131,072 at C = 1) a bounded-degree network goes
    sparse while its tables and state fit, and without the bound (or when
    they do not fit) to the per-step lane."""
    engine, tile = tk.select_engine(b, n, c, max_deg=max_deg)
    assert engine == want
    if engine == "sparse":
        assert tile == 256


def test_auto_dispatch_routes_bounded_degree_to_sparse():
    """End to end: a ring of 131,073 nodes is past the tiled regime, so
    "auto" runs it on the sparse lane (no stack is built) in
    simulate_ensemble_dense and in run_scenario, and matches the
    segment-sum lane."""
    n = 2**17 + 1
    ring = np.arange(n, dtype=np.int32)
    topo = tc.Topology(n, np.concatenate([ring, (ring + 1) % n]),
                       np.concatenate([(ring + 1) % n, ring]), name="ring")
    links = tc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(5).uniform(-8, 8, (1, n))
    res = tk.simulate_ensemble_dense(topo, links, ppm, 4, PARITY_KP,
                                     record_every=2, device="cpu")
    assert res.engine == "sparse" and res.tile_j == 256
    cfg = tc.SimConfig(dt=1e-3, steps=4, record_every=2)
    seg = tc.simulate_ensemble(topo, links, tc.ControllerConfig(kp=PARITY_KP),
                               ppm, cfg, device="cpu")
    np.testing.assert_allclose(res[0], seg.freq_ppm, rtol=0,
                               atol=FREQ_ATOL_PPM)
    scen = ts.run_scenario(topo, links, tc.ControllerConfig(kp=PARITY_KP),
                           ppm, ts.Scenario(events=()), cfg,
                           options=tk.EngineOptions(engine="auto"),
                           device="cpu")
    assert scen.engine == "sparse"
    np.testing.assert_array_equal(scen.freq_ppm, res[0])


# ------------------------------------------------ β and watermark rows

@pytest.mark.parametrize("ref_topo,kp,ppm_scale,steps,rec", BETA_PARITY_CASES,
                         ids=["fc8", "torus3d_8"])
def test_beta_parity_sparse_row(ref_topo, kp, ppm_scale, steps, rec):
    """The sparse row of the converged β matrix: against the reference's
    sparse lane and against segment-sum at BETA_ATOL_FRAMES, ν at
    FREQ_ATOL_PPM."""
    links = rc.make_links(ref_topo, cable_m=2.0)
    ppm = zero_mean_ppm(ref_topo.num_nodes, ppm_scale)
    seg = rc.simulate(ref_topo, links, rc.ControllerConfig(kp=kp), ppm,
                      rc.SimConfig(dt=1e-3, steps=steps, record_every=rec,
                                   record_beta=True))
    ref = rk.simulate_fused(ref_topo, links, ppm, steps=steps, kp=kp,
                            dt=1e-3, record_every=rec,
                            options=rk.EngineOptions(engine="sparse"),
                            telemetry=RefTelemetry(beta=True))
    port = _port_dense(ref_topo, links, ppm, steps, kp, rec,
                       telemetry=Telemetry(beta=True))
    np.testing.assert_allclose(port[0][0], np.asarray(ref[0]), rtol=0,
                               atol=FREQ_ATOL_PPM)
    np.testing.assert_allclose(port.beta[0], np.asarray(ref.beta), rtol=0,
                               atol=BETA_ATOL_FRAMES)
    np.testing.assert_allclose(port.beta[0], node_recon(ref_topo, seg.beta),
                               rtol=0, atol=BETA_ATOL_FRAMES)


def test_run_scenario_watermarks_sparse_row():
    """tests/test_telemetry_watermarks.py's scenario on the sparse lane:
    the watermarks equal a fold of the run's own β record, and agree with
    the reference's sparse lane and the port's segment-sum lane."""
    ref_topo = rc.fully_connected(8)
    links = rc.make_links(ref_topo, cable_m=2.0)
    ctrl = rc.ControllerConfig(kp=2e-7)
    ppm = zero_mean_ppm(8, 0.5, seed=5)
    sc = rs.Scenario(events=(rs.FreqStep(t=0.048, nodes=(2,),
                                         delta_ppm=0.02),))
    cfg = rc.SimConfig(dt=1e-3, steps=144, record_every=12)
    tel = Telemetry(beta=True, watermarks=True)
    runs = {eng: ts.run_scenario(
        _topo(ref_topo), convert.links(links), convert.controller(ctrl), ppm,
        convert.scenario(sc), convert.sim_config(cfg),
        options=tk.EngineOptions(engine=eng), telemetry=tel, device="cpu")
        for eng in ("sparse", "segment-sum")}
    ref = rs.run_scenario(ref_topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="sparse"),
                          telemetry=RefTelemetry(beta=True, watermarks=True))
    sp = runs["sparse"]
    assert sp.engine == "sparse"
    from repro_torch.telemetry import Watermarks
    own = Watermarks.from_record(sp.beta, sp.freq_ppm)
    np.testing.assert_array_equal(sp.watermarks.peak_record, own.peak_record)
    np.testing.assert_allclose(sp.watermarks.beta_abs_max, own.beta_abs_max,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(sp.watermarks.beta_abs_max,
                               ref.watermarks.beta_abs_max, rtol=0,
                               atol=BETA_ATOL_FRAMES)
    np.testing.assert_allclose(sp.watermarks.beta_abs_max,
                               runs["segment-sum"].watermarks.beta_abs_max,
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(sp.watermarks.nu_spread_ppm,
                               runs["segment-sum"].watermarks.nu_spread_ppm,
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------ run_scenario

def test_run_scenario_sparse_cable_swap_matches_reference():
    """The FC8 cable swap with re-establishment on the sparse lane: ν
    within FREQ_ATOL_PPM of the reference's sparse lane at the parity
    gain, β within the centring bar, λ tables and the λeff fold equal;
    split at the swap equals one run bit for bit; a gain sweep builds
    nothing new."""
    ref_topo = rc.fully_connected(8)
    links = rc.make_links(ref_topo, cable_m=2.0)
    ctrl = rc.ControllerConfig(kp=PARITY_KP)
    ppm = np.random.default_rng(7).uniform(-8, 8, (3, 8)).astype(np.float32)
    sc = rs.Scenario(events=(rs.LatencyStep(
        t=0.12, edges=rs.edges_between(ref_topo, 0, 2), cable_m=1000.0,
        reestablish=True),))
    cfg = rc.SimConfig(dt=1e-3, steps=240, record_every=12)
    ref = rs.run_scenario(ref_topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="sparse"),
                          telemetry=RefTelemetry(beta=True))
    args = (_topo(ref_topo), convert.links(links), convert.controller(ctrl),
            ppm, convert.scenario(sc), convert.sim_config(cfg))
    port = ts.run_scenario(*args, options=SPARSE,
                           telemetry=Telemetry(beta=True), device="cpu")
    assert port.engine == "sparse" and port.tile_j == 32
    np.testing.assert_allclose(port.freq_ppm, np.asarray(ref.freq_ppm),
                               rtol=0, atol=FREQ_ATOL_PPM)
    np.testing.assert_allclose(port.beta, np.asarray(ref.beta), rtol=0,
                               atol=_beta_bar(ref.beta, ref.psi))
    np.testing.assert_array_equal(port.lam, np.asarray(ref.lam))
    # Re-establishment reads λeff off the live ψ, which the packages round
    # apart by ulps (XLA contracts ψ + ν·Δ).
    np.testing.assert_allclose(port.lam_eff, np.asarray(ref.lam_eff),
                               rtol=0, atol=_ulps(ref.psi))
    split = ts.run_scenario(*args, options=tk.EngineOptions(
        engine="sparse", chunk_records=2), telemetry=Telemetry(beta=True),
        device="cpu")
    assert split.num_launches > port.num_launches
    np.testing.assert_array_equal(split.freq_ppm, port.freq_ppm)
    np.testing.assert_array_equal(split.beta, port.beta)
    with no_new_compiles():
        ts.run_scenario(*args[:2], tc.ControllerConfig(kp=3e-9), *args[3:],
                        options=SPARSE, telemetry=Telemetry(beta=True),
                        device="cpu")


def test_run_scenario_sparse_guard_matches_reference():
    """The harness's guard case (FC8 drift ramp across a 16-deep band) on
    the sparse lane: the same splice records and shifts as the reference's
    sparse lane and as the port's fused lane, ``guard_latency == 1``,
    records within the bars; the trace names the sparse dispatch."""
    ref_topo, links, ctrl, ppm, sc, cfg, pol = guard_case()
    ref = rs.run_scenario(ref_topo, links, ctrl, ppm, sc, cfg,
                          options=rk.EngineOptions(engine="sparse"),
                          telemetry=RefTelemetry(beta=True, guard=pol))
    runs = {}
    for engine in ("sparse", "fused"):
        runs[engine] = ts.run_scenario(
            _topo(ref_topo), convert.links(links), convert.controller(ctrl),
            ppm, convert.scenario(sc), convert.sim_config(cfg),
            options=tk.EngineOptions(engine=engine),
            telemetry=Telemetry(beta=True, trace=True,
                                guard=convert.reframe_policy(pol)),
            device="cpu")
    port = runs["sparse"]
    splices = lambda r: [(x.record, np.asarray(x.shift).tolist())
                         for x in r.reframes]
    assert len(port.reframes) >= 1
    assert splices(port) == splices(ref) == splices(runs["fused"])
    assert all(x.guard_latency == 1 for x in port.reframes)
    # kp = 2e-8: the float32 floor of ROADMAP §3 is the frequency bar.
    floor = _chip_smoke().float32_floor_ppm(
        float(ctrl.kp), 7, float(np.abs(port.psi).max()))
    for other in (np.asarray(ref.freq_ppm), runs["fused"].freq_ppm):
        np.testing.assert_allclose(port.freq_ppm, other, rtol=0,
                                   atol=max(floor, FREQ_ATOL_PPM))
    dispatch = port.trace.by_kind("engine_dispatch")
    assert dispatch and all(e.data["engine"] == "sparse" for e in dispatch)


def test_run_scenario_sparse_counts_and_validation():
    """The sparse variants count in compile_stats; on the CPU nothing is
    built or launched; the sparse lane keeps the dense lanes' controller
    and feature checks."""
    topo = tc.fully_connected(8)
    links = tc.make_links(topo, cable_m=2.0)
    sc = ts.Scenario(events=())
    cfg = tc.SimConfig(dt=1e-3, steps=24, record_every=12)
    before = launch_counts()["sparse"]
    ts.run_scenario(topo, links, tc.ControllerConfig(kp=2e-9), np.zeros(8),
                    sc, cfg, options=SPARSE, device="cpu")
    assert compile_stats()["sparse"] >= 1 and compile_stats()["builds"] == 0
    assert launch_counts()["sparse"] == before
    with pytest.raises(ValueError, match="proportional"):
        ts.run_scenario(topo, links, tc.ControllerConfig(kind="pi", kp=2e-8,
                                                         ki=1e-9),
                        np.zeros(8), sc, cfg, options=SPARSE, device="cpu")
    with pytest.raises(ValueError, match="segment-sum features"):
        ts.run_scenario(topo, links, tc.ControllerConfig(kp=2e-8),
                        np.zeros(8), sc, tc.SimConfig(
                            dt=1e-3, steps=24, record_every=12,
                            quantize_beta=True), options=SPARSE,
                        device="cpu")
