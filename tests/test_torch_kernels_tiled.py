"""repro_torch's tiled lane and the guard variant against repro's.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode (``bittide_tiled_fused_pallas`` / ``bittide_fused_pallas``
with ``interpret=True``, ``EngineOptions(engine=..., interpret=True)``).
The port runs its kernels' plain version, which the wrappers take for CPU
tensors.  Inputs are made with numpy from a seed: two latency classes
whose second class is ONE direction of one link (so the stack is not
symmetric and a transposed layout would show), per-draw kp / β_off /
class latencies / λeff folds / holdover masks.

Tolerances (``tests/engine_harness.py``): ν at every record point within
``FREQ_ATOL_PPM``; β within ``BETA_ATOL_FRAMES`` on ``BETA_PARITY_CASES``
(converged).  The kernel-level cases run at the reference's parity gain
with ±8 ppm draws and random λeff folds, so they do not converge and
|β| reaches ~10³ frames; there β and ψ are held to ``BETA_ULPS`` float32
ulps of the largest |β| or |ψ|: the measure pass sums deg ≤ 6 centred
phase terms of that size, the two packages round them in different
orders (XLA contracts multiply-adds), and the reference centres ψ over
its 128-node padded row where the port centres over the N real nodes.
Watermark ``peak_record`` and the guard's trip records are exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.kernels as rk  # noqa: E402
from engine_harness import (BETA_ATOL_FRAMES, BETA_PARITY_CASES,  # noqa: E402
                            PARITY_KP, assert_beta_parity,
                            assert_freq_parity, zero_mean_ppm)
from repro.kernels.bittide_step import (bittide_fused_pallas,  # noqa: E402
                                        bittide_tiled_fused_pallas)
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.bittide_step import (bittide_fused,  # noqa: E402
                                              bittide_fused_torch,
                                              bittide_tiled)
from repro_torch.telemetry import (Telemetry, compile_stats,  # noqa: E402
                                   launch_counts, no_new_compiles)

BETA_ULPS = 8
DT_FRAMES = 125000.0           # dt = 1e-3 s at 125 MHz
STEPS, REC = 72, 12            # 6 records
B = 5
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
VARIANT_IDS = ["nu", "beta", "wm", "beta+wm"]
TOPOS = [rc.torus3d(8), rc.torus3d(7)]        # N = 512 and a ragged 343


def _one_way_links(topo):
    """2 m cables, plus 1000 m on the single directed edge 0 → 1."""
    cable = np.full(topo.num_edges, 2.0)
    cable[(topo.src == 0) & (topo.dst == 1)] = 1000.0
    return rc.make_links(topo, cable_m=cable)


def _inputs(topo, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    links = _one_way_links(topo)
    a_t, _, classes, _ = tk.densify(convert.topology(topo),
                                    convert.links(links), device="cpu")
    assert a_t.shape[0] == 2 and not torch.equal(a_t, a_t.transpose(1, 2))
    mask = np.ones((B, n), np.float32)
    mask[1, [0, n - 1]] = 0.0
    mask[3, 2] = 0.0
    return dict(
        links=links, a_t=a_t.numpy(),
        nu_u=(rng.uniform(-8, 8, (B, n)).astype(np.float32)
              * np.float32(1e-6)),
        kp=(PARITY_KP * rng.uniform(0.5, 1.5, B)).astype(np.float32),
        beta_off=rng.uniform(-1, 1, B).astype(np.float32),
        lamsum=rng.uniform(-2, 2, (B, n)).astype(np.float32),
        lat=(classes.numpy()[None, :]
             * rng.uniform(0.99, 1.01, (B, 1))).astype(np.float32),
        mask=mask)


def _reference(topo, kernel: str, x, guard=None):
    """The reference's Pallas kernel (interpret) on padded inputs, every
    output on; ``guard`` = (lo (B,), hi (B,), stop)."""
    b, n = x["nu_u"].shape
    a, _, _, n_pad = rk.densify(topo, x["links"])
    b_pad = 8
    pad = lambda v, fill=0.0: np.pad(
        v, ((0, b_pad - b), (0, n_pad - n)), constant_values=fill)
    kw = dict(num_records=STEPS // REC, record_every=REC,
              ctrl_mask=pad(x["mask"], 1.0), record_beta=True,
              record_watermarks=True, interpret=True)
    if guard is not None:
        lo, hi, stop = guard
        kw.update(record_guard=True, guard_stop=stop,
                  guard_lo=np.pad(lo, (0, b_pad - b), constant_values=-1e30),
                  guard_hi=np.pad(hi, (0, b_pad - b), constant_values=1e30))
    if kernel == "tiled":
        kw["tile_j"] = rk.select_engine(b_pad, n_pad, 2)[1]
        fn = bittide_tiled_fused_pallas
    else:
        fn = bittide_fused_pallas
    out = fn(np.zeros((b_pad, n_pad), np.float32), pad(x["nu_u"]),
             pad(x["nu_u"]), np.asarray(a), np.asarray(a).sum(axis=(0, 2)),
             pad(x["lamsum"]), np.pad(x["lat"], ((0, b_pad - b), (0, 0)),
                                      mode="edge"),
             np.pad(x["kp"], (0, b_pad - b)),
             np.pad(x["beta_off"], (0, b_pad - b)), DT_FRAMES, **kw)
    cut = lambda v: np.asarray(v)[..., :b, :n]
    return dict(psi=cut(out.psi), nu=cut(out.nu), freq=cut(out.freq),
                beta=cut(out.beta), wm=[cut(w) for w in out.watermarks],
                trip=(None if out.guard_state is None
                      else np.asarray(out.guard_state)[:b, 0]))


def _port(kernel, x, record_beta=True, record_watermarks=True, guard=None):
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    a_t = t(x["a_t"])
    b, n = x["nu_u"].shape
    kw = dict(num_records=STEPS // REC, record_every=REC,
              ctrl_mask=t(x["mask"]), record_beta=record_beta,
              record_watermarks=record_watermarks)
    if guard is not None:
        lo, hi, stop = guard
        kw.update(record_guard=True, guard_lo=t(lo), guard_hi=t(hi),
                  guard_stop=stop)
    return kernel(torch.zeros(b, n), t(x["nu_u"]), t(x["nu_u"]), a_t,
                  a_t.sum(dim=(0, 1)), t(x["lamsum"]), t(x["lat"]),
                  t(x["kp"]), t(x["beta_off"]), DT_FRAMES, **kw)


def _bar(*refs) -> float:
    big = max(float(np.abs(r).max()) for r in refs)
    return BETA_ULPS * float(np.spacing(np.float32(big)))


_CACHE: dict = {}


def _case(topo):
    if topo.name not in _CACHE:
        x = _inputs(topo)
        _CACHE[topo.name] = (x, _reference(topo, "tiled", x))
    return _CACHE[topo.name]


def _assert_matches(out, ref, records=None):
    r = slice(None) if records is None else slice(0, records)
    assert_freq_parity(out.freq.numpy()[r] * 1e6, ref["freq"][r] * 1e6)
    assert_freq_parity(out.nu.numpy() * 1e6, ref["nu"] * 1e6)
    bar = _bar(ref["beta"][r], ref["psi"])
    np.testing.assert_allclose(out.psi.numpy(), ref["psi"], rtol=0, atol=bar)
    if out.beta is not None:
        np.testing.assert_allclose(out.beta.numpy()[r], ref["beta"][r],
                                   rtol=0, atol=bar)
    if out.watermarks is not None:
        bmax, idx, lo, hi = (w.numpy() for w in out.watermarks)
        np.testing.assert_array_equal(idx, ref["wm"][1])
        np.testing.assert_allclose(bmax, ref["wm"][0], rtol=0, atol=bar)
        assert_freq_parity(lo * 1e6, ref["wm"][2] * 1e6)
        assert_freq_parity(hi * 1e6, ref["wm"][3] * 1e6)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: t.name)
def test_tiled_matches_reference_tiled_kernel(topo, variant):
    """bittide_tiled (CPU: the plain version) vs bittide_tiled_fused_pallas
    in interpret mode, every variant, on a multi-panel and a ragged N."""
    x, ref = _case(topo)
    out = _port(bittide_tiled, x, *variant)
    assert (out.beta is not None) == variant[0]
    assert (out.watermarks is not None) == variant[1]
    _assert_matches(out, ref)
    # Held nodes keep their ν: draw 1's nodes 0 and N-1 never move.
    np.testing.assert_array_equal(out.nu.numpy()[1, 0], x["nu_u"][1, 0])


def _trip_bands(x, recs):
    """Per-draw bands (frames per degree) that trip draw b near record
    recs[b] of the guard-off run; recs[b] = None never trips."""
    base = _port(bittide_fused_torch, x, True, False)
    deg = np.maximum(x["a_t"].sum(axis=(0, 1)), 1.0)
    peak = (np.abs(base.beta.numpy()) / deg).max(axis=2)        # (R, B)
    band = np.array([peak[r, i] * 0.999 if r is not None
                     else 10 * peak.max() for i, r in enumerate(recs)],
                    np.float32)
    return -band, band


@pytest.mark.parametrize("trips", [True, False], ids=["trips", "quiet"])
@pytest.mark.parametrize("kernel", ["tiled", "fused"])
def test_guard_matches_reference(kernel, trips):
    """The guard variant against the reference's: draws whose bands trip
    at different records (the batch freezes at the earliest) or never.
    Trip records equal; the state at t* and the records up to it within
    the bars; later records unrun (NaN)."""
    topo = rc.torus3d(7) if kernel == "tiled" else rc.hourglass(4)
    x = _inputs(topo, seed=1)
    recs = [2, 4, 3, None, 5] if trips else [None] * B
    lo, hi = _trip_bands(x, recs)
    stop = STEPS // REC - 1
    ref = _reference(topo, kernel, x, guard=(lo, hi, stop))
    port_kernel = bittide_tiled if kernel == "tiled" else bittide_fused
    out = _port(port_kernel, x, guard=(lo, hi, stop))
    trip = out.guard_state.numpy()[:, 0]
    np.testing.assert_array_equal(trip, ref["trip"])
    tstar = int(trip.min())
    if trips:
        assert tstar < stop and len(set(trip.tolist())) == 2
        assert np.isnan(out.freq.numpy()[tstar + 1:]).all()
    else:
        assert tstar == STEPS // REC
    _assert_matches(out, ref, records=min(tstar, stop) + 1)


def test_guard_off_band_and_stop_cap_are_observation_free():
    """A band that never trips leaves every output bit-identical to the
    guard-off run; a stop cap runs exactly the records up to it."""
    x, _ = _case(rc.torus3d(7))
    off = _port(bittide_tiled, x)
    big = np.full(B, 1e9, np.float32)
    on = _port(bittide_tiled, x, guard=(-big, big, STEPS // REC - 1))
    for a, b in ((on.freq, off.freq), (on.beta, off.beta), (on.psi, off.psi),
                 (on.nu, off.nu)):
        assert torch.equal(a, b)
    for a, b in zip(on.watermarks, off.watermarks):
        assert torch.equal(a, b)
    capped = _port(bittide_tiled, x, guard=(-big, big, 2))
    assert torch.equal(capped.freq[:3], off.freq[:3])
    assert torch.isnan(capped.freq[3:]).all()


def test_forced_tiled_equals_fused_bit_for_bit():
    """The two kernels sum in one order: the tiled lane forced at FC8
    equals the fused lane bit for bit, records, state and watermarks."""
    topo = tc.fully_connected(8)
    links = convert.links(_one_way_links(rc.fully_connected(8)))
    ppm = np.random.default_rng(4).uniform(-8, 8, (3, 8)).astype(np.float32)
    kw = dict(dt=5e-5, record_every=20, device="cpu",
              telemetry=Telemetry(beta=True, watermarks=True))
    fused = tk.simulate_ensemble_dense(
        topo, links, ppm, 400, 2e-8,
        options=tk.EngineOptions(engine="fused"), **kw)
    tiled = tk.simulate_ensemble_dense(
        topo, links, ppm, 400, 2e-8,
        options=tk.EngineOptions(engine="tiled"), **kw)
    assert fused.engine == "fused" and tiled.engine == "tiled"
    assert tiled.tile_j == 8
    for a, b in ((fused[0], tiled[0]), (fused[1], tiled[1]),
                 (fused.beta, tiled.beta), (fused.nu, tiled.nu),
                 (fused.watermarks.peak_record, tiled.watermarks.peak_record),
                 (fused.watermarks.beta_abs_max,
                  tiled.watermarks.beta_abs_max)):
        np.testing.assert_array_equal(a, b)


def test_draw_bits_do_not_depend_on_the_batch():
    """Draw b alone equals draw b inside the batch, bit for bit."""
    x, _ = _case(rc.torus3d(7))
    full = _port(bittide_tiled, x)
    one = {k: (v[2:3] if k in ("nu_u", "kp", "beta_off", "lamsum", "lat",
                               "mask") else v) for k, v in x.items()}
    part = _port(bittide_tiled, one)
    assert torch.equal(full.freq[:, 2:3], part.freq)
    assert torch.equal(full.beta[:, 2:3], part.beta)
    assert torch.equal(full.psi[2:3], part.psi)
    for a, b in zip(full.watermarks, part.watermarks):
        assert torch.equal(a[2:3], b)


def test_tiled_lane_matches_reference_and_segment_sum():
    """simulate_ensemble_dense on the tiled lane — "auto" above 256 nodes
    in both packages — against the reference's tiled lane and the port's
    segment-sum lane, per-draw gains and a shared holdover mask."""
    topo = rc.torus3d(7)
    rng = np.random.default_rng(3)
    ppm = rng.uniform(-8, 8, (2, topo.num_nodes)).astype(np.float32)
    kp = (PARITY_KP * np.float32([0.5, 1.5])).astype(np.float32)
    mask = np.ones(topo.num_nodes, np.float32)
    mask[5] = 0.0
    links = _one_way_links(topo)
    ref = rk.simulate_ensemble_dense(
        topo, links, ppm, STEPS, kp, dt=1e-3, record_every=REC,
        ctrl_mask=mask, options=rk.EngineOptions(interpret=True),
        telemetry=RefTelemetry(watermarks=True))
    port = tk.simulate_ensemble_dense(
        convert.topology(topo), convert.links(links), ppm, STEPS, kp,
        dt=1e-3, record_every=REC, ctrl_mask=mask, device="cpu",
        telemetry=Telemetry(watermarks=True))
    assert ref.engine == port.engine == "tiled"
    assert_freq_parity(port[0], ref[0])
    assert_freq_parity(port.nu * 1e6, ref.nu * 1e6)
    np.testing.assert_array_equal(port.watermarks.peak_record,
                                  ref.watermarks.peak_record)
    segsum = tc.simulate_ensemble(
        convert.topology(topo), convert.links(links),
        tc.ControllerConfig(kp=kp), ppm,
        tc.SimConfig(dt=1e-3, steps=STEPS, record_every=REC,
                     record_beta=False), ctrl_mask=mask, device="cpu")
    assert_freq_parity(port[0], segsum.freq_ppm)


@pytest.mark.parametrize("case", BETA_PARITY_CASES,
                         ids=lambda c: c[0].name)
def test_tiled_beta_parity_cases(case):
    """Converged regime: the tiled lane's β within BETA_ATOL_FRAMES of the
    reference's tiled lane at every record, ν within FREQ_ATOL_PPM, equal
    watermark peaks."""
    topo, kp, scale, steps, rec = case
    ppm = zero_mean_ppm(topo.num_nodes, scale)[None]
    links = rc.make_links(topo, cable_m=2.0)
    ref = rk.simulate_ensemble_dense(
        topo, links, ppm, steps, kp, dt=1e-3, record_every=rec,
        options=rk.EngineOptions(engine="tiled", interpret=True),
        telemetry=RefTelemetry(beta=True, watermarks=True))
    port = tk.simulate_ensemble_dense(
        convert.topology(topo), convert.links(links), ppm, steps, kp,
        dt=1e-3, record_every=rec, device="cpu",
        options=tk.EngineOptions(engine="tiled"),
        telemetry=Telemetry(beta=True, watermarks=True))
    assert port.engine == "tiled"
    assert_freq_parity(port[0], ref[0])
    assert_beta_parity(port.beta, ref.beta)
    np.testing.assert_allclose(port.watermarks.beta_abs_max,
                               ref.watermarks.beta_abs_max, rtol=0,
                               atol=BETA_ATOL_FRAMES)


def test_tiled_variants_are_counted_and_sweeps_build_nothing():
    """The tiled variants are keyed like the fused ones; a gain sweep
    selects nothing new, and on the CPU nothing launches or builds."""
    topo = tc.torus3d(7)
    ppm = np.zeros((1, topo.num_nodes), np.float32)
    kw = dict(record_every=12, device="cpu",
              options=tk.EngineOptions(engine="tiled"))
    tk.simulate_ensemble_dense(topo, tc.make_links(topo), ppm, 12, 2e-9, **kw)
    before = launch_counts()
    with no_new_compiles():
        for kp in (1e-9, 3e-9):
            tk.simulate_ensemble_dense(topo, tc.make_links(topo), ppm, 12,
                                       kp, **kw)
    assert launch_counts() == before
    assert compile_stats()["tiled"] >= 1 and compile_stats()["builds"] == 0
