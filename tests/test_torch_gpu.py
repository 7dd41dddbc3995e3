"""Card tests: the kernels against their plain version on an NVIDIA card.

Marked ``gpu``; run on the machine with the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
Whether a card is present is decided in the ``cuda`` fixture, never at
import, so every pytest-xdist worker collects the same tests.  Inputs and
bars come from ``chip_smoke.py`` (the card machine has no jax, so
``tests/engine_harness.py`` cannot be imported there;
``test_torch_package_rules`` checks that the bars agree): its
``PARITY_CASES`` — FC8 at B=64 and at 4·SMs·3 + 5 draws (the warp path:
several warps per CTA, a partial last CTA) with two latency classes (row
lists) and with one (the dense loop), torus3d(6) at B=16 with two
classes and with one (the block path's row lists), fully_connected(64)
(the block path's dense loop, A in shared memory), fully_connected(16)
with two classes (the warp path's), torus3d(3) with one
class and with two (lanes past a warp's draw) — with per-draw kp /
lat / lamsum / holdover mask, 400 periods recorded every 20; the
library reports the plan Python computed; one ψ seeded inf
(``NONFINITE_CASES``) gives the plain version's inf / NaN pattern bit
for bit, watermarks included.  The kernel
performs the plain version's float32 operations in the same order, so
the results are held to ``FREQ_ATOL_PPM`` / ``BETA_ATOL_FRAMES`` and
watermark indices exactly.  The tiled kernel runs ``TILED_PARITY_CASES``
(torus3d(8) at B=9, torus3d(7) at B=5, one class and a one-way second
class; the ring's edges: torus3d(6) with fewer panels than ring stages,
torus3d(6) with three classes, torus3d(8) at B=17) in every variant and
with guard bands that trip at different records and that never trip, at
0.0 error; the fused guard runs ``FUSED_GUARD_CASES``
(FC8, and torus3d(8) with two classes: 512 threads per CTA, A from L2),
whose draws trip at different records so that the wrapper replays the
chunk.  Guard runs are compared over the records up to the earliest trip,
with trip records exactly equal.  The sparse kernel runs
``SPARSE_PARITY_CASES`` (FC8, random_regular(300, 3, 0) at B=9, the
ragged bounded_degree_topo(96, 4, 3), the same with K + 2 padded slots,
per-draw tables with dropped links — the direct pass — and torus3d(21)
at B=235, the grouped pass) in every variant and with the guard, at 0.0
error, the library reporting the plan Python computed and refusing one
it cannot run (the fused library too); a draw's bits do
not depend on the batch nor on the pass (alone, and in a direct batch of
1,024 and a grouped batch of 235) nor on whether its tables are shared
or per-draw; the guard freezes the whole batch at the earliest trip.  The per-step kernel
runs ``PERSTEP_PARITY_CASES`` (FC8, FC8 with two classes, the ragged
torus3d(7) with holdover, torus3d(6) with one class and with three) in
every variant and with the guard, at 0.0
error; its bits do not depend on how the periods are cut into calls nor
on the kernel (the fused kernel at B = 1 gives the same bits); after a
trip or the stop cap its records are frozen.  The tiled, sparse (direct
and grouped) and per-step kernels on a diverged draw
(``STREAM_NONFINITE_CASES``: ψ seeded inf, or a gain that overflows
after a record) give the plain version's inf / NaN pattern bit for bit,
all four watermark arrays included.  The serving simulator's pacing
ensemble (``pace_workers(engine="fused")``) holds every engine call at
0.0 error to the plain version.  The model stack serves every
architecture at ``.reduced()`` on the card as on the CPU (phase 12), and
trains them so (phase 13: the loss, its gradients and one AdamW update
at the CPU training tests' bars); a checkpoint written on the CPU
restores on the card bit for bit, and the synthetic stream gives the
same tokens on both.  On a one-rank NCCL group (phase 14) the mesh step
equals the plain step bit for bit and a save from the mesh restores
through ``remesh`` bit for bit; ``compress`` and ``ef_roundtrip`` on the
card equal the CPU's bit for bit.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
from repro_torch.kernels.bittide_sparse import (  # noqa: E402
    bittide_sparse, bittide_sparse_torch)
from repro_torch.kernels.bittide_step import (  # noqa: E402
    bittide_fused, bittide_fused_torch, bittide_tiled, fused_device_plan,
    sparse_device_plan, sparse_launch_plan)
from repro_torch.scenarios import (LatencyStep, Scenario,  # noqa: E402
                                   edges_between, run_scenario)
from repro_torch.telemetry import Telemetry  # noqa: E402

pytestmark = pytest.mark.gpu

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FREQ_ATOL_PPM = chip_smoke.FREQ_ATOL_PPM
BETA_ATOL_FRAMES = chip_smoke.BETA_ATOL_FRAMES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the chip)")
    return torch.device("cuda")


# Per-draw kernel arguments: psi, nu, nu_u, lamsum, lat, kp, beta_off.
_PER_DRAW = (0, 1, 2, 5, 6, 7, 8)


@pytest.mark.parametrize("variant", [(False, False), (True, False),
                                     (False, True), (True, True)],
                         ids=["nu", "beta", "wm", "beta+wm"])
@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES,
                         ids=list(chip_smoke.PARITY_IDS))
def test_kernel_matches_plain_version(cuda, case, variant):
    _, args, mask = chip_smoke.parity_inputs(case, cuda)
    kw = dict(num_records=20, record_every=20, ctrl_mask=mask,
              record_beta=variant[0], record_watermarks=variant[1])
    before = bittide_fused.launches
    got = bittide_fused(*args, **kw)
    torch.cuda.synchronize()
    assert bittide_fused.launches == before + 1
    want = bittide_fused_torch(*args, **kw)
    torch.testing.assert_close(got.freq * 1e6, want.freq * 1e6, rtol=0,
                               atol=FREQ_ATOL_PPM)
    torch.testing.assert_close(got.psi, want.psi, rtol=0,
                               atol=BETA_ATOL_FRAMES)
    if variant[0]:
        torch.testing.assert_close(got.beta, want.beta, rtol=0,
                                   atol=BETA_ATOL_FRAMES)
    if variant[1]:
        assert torch.equal(got.watermarks[1], want.watermarks[1])
        torch.testing.assert_close(got.watermarks[0], want.watermarks[0],
                                   rtol=0, atol=BETA_ATOL_FRAMES)


def test_draw_result_independent_of_batch(cuda):
    """Draw b's bits do not depend on B or on the CTA and warp lanes that
    ran it: draws 5-8 (two warps' lanes) and the two live draws of the
    partial last CTA equal the same draws run alone, one per launch."""
    _, args, mask = chip_smoke.parity_inputs(("fully_connected_8", "waves",
                                              2), cuda)
    b = args[0].shape[0]
    plan = chip_smoke.fused_plan_of(args, cuda)
    assert plan["path"] == "warp", plan
    assert plan["draws_per_cta"] > 1 and b % plan["draws_per_cta"], plan
    kw = dict(num_records=5, record_every=20, record_beta=True,
              record_watermarks=True)
    full = bittide_fused(*args, ctrl_mask=mask, **kw)
    for d in (5, 6, 7, 8, b - 2, b - 1):
        sub = [x[d:d + 1].contiguous() if k in _PER_DRAW else x
               for k, x in enumerate(args)]
        one = bittide_fused(*sub, ctrl_mask=mask[d:d + 1].contiguous(),
                            **kw)
        assert torch.equal(full.freq[:, d:d + 1], one.freq)
        assert torch.equal(full.beta[:, d:d + 1], one.beta)
        assert torch.equal(full.psi[d:d + 1], one.psi)
        for got, want in zip(full.watermarks, one.watermarks):
            assert torch.equal(got[d:d + 1], want)


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard"])
@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES,
                         ids=list(chip_smoke.PARITY_IDS))
def test_fused_library_reports_the_launch_plan(cuda, case, guard):
    """The built library launched the plan Python computed (path, row
    lists or dense loop, draws per CTA, CTAs, threads, shared bytes)."""
    _, args, mask = chip_smoke.parity_inputs(case, cuda)
    b = args[0].shape[0]
    kw = dict(num_records=2, record_every=3, ctrl_mask=mask)
    if guard:
        band = torch.full((b,), 1e9, device=cuda)
        kw.update(record_guard=True, guard_lo=-band, guard_hi=band,
                  guard_stop=1)
    bittide_fused(*args, **kw)
    torch.cuda.synchronize()
    assert fused_device_plan() == chip_smoke.fused_plan_of(args, cuda,
                                                           guard=guard)


@pytest.mark.parametrize("bad", [
    ("fully_connected_8", 64, 2, dict(draws_per_warp=3)),
    ("fully_connected_8", 64, 2, dict(registers=True, list_slots=9)),
    ("fully_connected_8", 64, 2, dict(registers=False)),
    ("fully_connected_64", 16, 1, dict(path="warp"))],
    ids=["draws_per_warp", "too_many_terms", "lists_outside_registers",
         "warp_beyond_32_nodes"])
def test_fused_library_refuses_a_plan_it_cannot_run(cuda, monkeypatch, bad):
    """The C entry point checks the plan it is handed and launches nothing
    on one it cannot run."""
    import repro_torch.kernels.bittide_step as bs
    *case, change = bad
    _, args, mask = chip_smoke.parity_inputs(tuple(case), cuda)
    real = bs.launch_plan
    monkeypatch.setattr(bs, "launch_plan",
                        lambda *a, **k: dict(real(*a, **k), **change))
    before = bittide_fused.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        bittide_fused(*args, num_records=2, record_every=3, ctrl_mask=mask)
    assert bittide_fused.launches == before


@pytest.mark.parametrize("case", chip_smoke.NONFINITE_CASES,
                         ids=list(chip_smoke.NONFINITE_IDS))
def test_fused_nonfinite_state_matches_plain_version(cuda, case):
    """A draw whose ψ starts at +inf: its period votes send the kernel to
    the dense loop, so ν, β, ψ, ν', the watermarks and the guard's trips
    equal the plain version's bit for bit, inf and NaN at the same
    places; the other draws stay finite."""
    rows = chip_smoke.fused_nonfinite_rows(case, cuda)
    assert len(rows) == 4
    assert all(r["nonfinite_values"] > 0 for r in rows)


@pytest.mark.parametrize("seed", ["inf", "diverging"])
@pytest.mark.parametrize("kernel,case", chip_smoke.STREAM_NONFINITE_CASES,
                         ids=list(chip_smoke.STREAM_NONFINITE_IDS))
def test_stream_kernel_nonfinite_state_matches_plain_version(cuda, kernel,
                                                             case, seed):
    """The tiled, sparse (direct and grouped) and per-step kernels on a
    diverged draw — ψ seeded inf, or a gain that overflows after a record
    or more: ν, β, ψ, ν', all four watermark arrays and the guard's trips
    equal the plain version's bit for bit, inf and NaN at the same
    places; the other draws stay finite.  The diverging rows' records
    tell a NaN-dropping fold (fmaxf / fminf) from the plain version's."""
    rows = chip_smoke.stream_nonfinite_rows(kernel, case, seed, cuda)
    assert len(rows) == 5
    assert all(r["nonfinite_values"] > 0 for r in rows[:4])


def test_main_path_runs_on_the_card(cuda):
    topo = tc.fully_connected(8)
    ppm = np.random.default_rng(0).uniform(-8, 8, (32, 8))
    before = bittide_fused.launches
    res = tk.simulate_ensemble_dense(topo, tc.make_links(topo), ppm, 400,
                                     2e-8, dt=5e-5, record_every=20,
                                     telemetry=Telemetry(beta=True))
    assert bittide_fused.launches == before + 1
    assert res.engine == "fused" and np.isfinite(res[0]).all()


def test_pace_workers_fused_on_the_card(cuda):
    """The serving simulator's pacing ensemble on the card:
    ``pace_workers(engine="fused")`` (ring(8), B = 2, the serving_goodput
    lane's events) launches the fused kernel once per engine call, and
    every call equals the plain version on its own inputs at 0.0 error;
    "auto" picks the fused lane and gives the same bits; the same pace on
    the CPU (the plain version) gives the same records."""
    from repro_torch.serve import pace_workers
    speed = np.random.default_rng(7).uniform(-50_000, 50_000, 8)
    kw = dict(kp=5e-3, duration_s=30.0, record_every=5)
    before = bittide_fused.launches
    with chip_smoke.recorded_engine_calls() as calls:
        pe = pace_workers(tc.ring(8), speed,
                          chip_smoke.serving_bench_scenario(),
                          engine="fused", **kw)
    launched = bittide_fused.launches - before
    assert launched == pe.result.num_launches == len(calls) >= 1
    held = chip_smoke.hold_engine_calls(calls, 10**9, exact=True)
    assert held["bittide_fused"]["calls"] == len(calls)
    auto = pace_workers(tc.ring(8), speed,
                        chip_smoke.serving_bench_scenario(), engine="auto",
                        **kw)
    assert auto.result.engine == "fused"
    np.testing.assert_array_equal(auto.result.freq_ppm, pe.result.freq_ppm)
    cpu = pace_workers(tc.ring(8), speed,
                       chip_smoke.serving_bench_scenario(), engine="fused",
                       device="cpu", **kw)
    np.testing.assert_array_equal(cpu.result.freq_ppm, pe.result.freq_ppm)
    np.testing.assert_array_equal(cpu.result.beta, pe.result.beta)


def _tiled_variants(args, kw, b):
    """The four variants, then the guard with bands that trip at records
    1..3 and with bands that never trip."""
    out = [dict(record_beta=beta, record_watermarks=wm)
           for beta, wm in ((False, False), (True, False), (False, True),
                            (True, True))]
    for trips in (True, False):
        band = chip_smoke.trip_bands(
            args, kw, [1 + i % 3 if trips else None for i in range(b)])
        out.append(dict(record_beta=True, record_watermarks=True,
                        record_guard=True, guard_lo=-band, guard_hi=band,
                        guard_stop=chip_smoke.TILED_RECORDS - 1))
    return out


@pytest.mark.parametrize("variant", range(6),
                         ids=["nu", "beta", "wm", "beta+wm", "guard_trips",
                              "guard_quiet"])
@pytest.mark.parametrize("case", chip_smoke.TILED_PARITY_CASES,
                         ids=list(chip_smoke.TILED_PARITY_IDS))
def test_tiled_kernel_matches_plain_version(cuda, case, variant):
    _, args, mask = chip_smoke.parity_inputs(case, cuda, one_way=True)
    b = args[0].shape[0]
    kw = dict(num_records=chip_smoke.TILED_RECORDS,
              record_every=chip_smoke.TILED_EVERY, ctrl_mask=mask)
    v = _tiled_variants(args, kw, b)[variant]
    before = bittide_tiled.launches
    got = bittide_tiled(*args, **kw, **v)
    torch.cuda.synchronize()
    assert bittide_tiled.launches == before + 1
    want = bittide_fused_torch(*args, **kw, **v)
    records = chip_smoke.TILED_RECORDS
    if v.get("record_guard"):
        assert torch.equal(got.guard_state, want.guard_state)
        tstar = int(want.guard_state.min())
        assert (tstar < records - 1) == (variant == 4)
        records = min(tstar, records - 1) + 1
    chip_smoke.kernel_vs_plain(got, want, records=records, exact=True)


@pytest.mark.parametrize("guard_case", chip_smoke.FUSED_GUARD_CASES,
                         ids=["fc8", "torus3d_8_two_classes"])
def test_fused_guard_replays_at_the_earliest_trip(cuda, guard_case):
    """Draws trip at different records: the wrapper launches the chunk a
    second time, capped at the earliest trip, and then equals the plain
    version's batch-wide freeze (trip records exactly)."""
    case, records, every, stops = guard_case
    _, args, mask = chip_smoke.parity_inputs(case, cuda)
    b = args[0].shape[0]
    kw = dict(num_records=records, record_every=every, ctrl_mask=mask)
    recs = np.random.default_rng(5).integers(1, records, b).tolist()
    band = chip_smoke.trip_bands(args, kw, recs)
    gkw = dict(kw, record_beta=True, record_watermarks=True,
               record_guard=True, guard_lo=-band, guard_hi=band,
               guard_stop=stops[0])
    before = bittide_fused.launches
    got = bittide_fused(*args, **gkw)
    torch.cuda.synchronize()
    assert bittide_fused.launches == before + 2
    want = bittide_fused_torch(*args, **gkw)
    tstar = int(want.guard_state.min())
    assert 0 < tstar < stops[0]
    chip_smoke.kernel_vs_plain(got, want, records=tstar + 1)
    assert torch.isnan(got.freq[tstar + 1:]).all()


def test_tiled_draw_result_independent_of_batch(cuda):
    """Draws of the second, partial draw group equal the same draws run
    alone in a group of their own, bit for bit."""
    _, args, mask = chip_smoke.parity_inputs(("torus3d_8", 9, 2), cuda,
                                             one_way=True)
    kw = dict(num_records=3, record_every=3, record_beta=True,
              record_watermarks=True)
    full = bittide_tiled(*args, ctrl_mask=mask, **kw)
    idx = torch.tensor([3, 8], device=cuda)
    sub = [x[idx].contiguous() if k in _PER_DRAW else x
           for k, x in enumerate(args)]
    part = bittide_tiled(*sub, ctrl_mask=mask[idx].contiguous(), **kw)
    assert torch.equal(full.freq[:, idx], part.freq)
    assert torch.equal(full.beta[:, idx], part.beta)
    assert torch.equal(full.psi[idx], part.psi)
    for got, want in zip(full.watermarks, part.watermarks):
        assert torch.equal(got[idx], want)


def test_run_scenario_on_the_card(cuda):
    """The cable swap (smoke length) through run_scenario with the device
    default: the fused and the forced tiled lane launch their kernels and
    agree bit for bit; the segment-sum lane agrees within the float32
    floor; the RTT shifts by ≈1231 frames."""
    topo = tc.fully_connected(8)
    links = tc.make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (8, 8)).astype(np.float32)
    swap = edges_between(topo, 0, 2)
    sc = Scenario(events=(LatencyStep(t=0.2, edges=swap, cable_m=1000.0,
                                      reestablish=True),))
    cfg = tc.SimConfig(dt=1e-4, steps=4000, record_every=20)
    ctrl = tc.ControllerConfig(kp=2e-8)
    runs = {}
    for engine, kernel in (("fused", bittide_fused), ("tiled", bittide_tiled),
                           ("segment-sum", None)):
        before = kernel.launches if kernel else 0
        runs[engine] = run_scenario(topo, links, ctrl, ppm, sc, cfg,
                                    options=tk.EngineOptions(engine=engine),
                                    telemetry=Telemetry(beta=True))
        if kernel:
            assert kernel.launches > before
    fus, til, seg = runs["fused"], runs["tiled"], runs["segment-sum"]
    np.testing.assert_array_equal(fus.freq_ppm, til.freq_ppm)
    np.testing.assert_array_equal(fus.beta, til.beta)
    floor = chip_smoke.float32_floor_ppm(2e-8, 7, float(np.abs(fus.psi).max()))
    np.testing.assert_allclose(fus.freq_ppm, seg.freq_ppm, rtol=0,
                               atol=max(floor, FREQ_ATOL_PPM))
    shift = int((fus.rtt(1) - fus.rtt(0))[swap[0]])
    assert abs(shift - 1231) <= 3
    assert shift == int((seg.rtt(1) - seg.rtt(0))[swap[0]])


# Per-draw arguments of the sparse kernel: psi, nu, nu_u, lamsum, kp,
# beta_off (the tables are shared in these cases).
_SPARSE_PER_DRAW = (0, 1, 2, 6, 7, 8)
_SPARSE_KW = dict(num_records=chip_smoke.SPARSE_RECORDS,
                  record_every=chip_smoke.SPARSE_EVERY)


@pytest.mark.parametrize("variant", range(6),
                         ids=["nu", "beta", "wm", "beta+wm", "guard_trips",
                              "guard_quiet"])
@pytest.mark.parametrize("case", chip_smoke.SPARSE_PARITY_CASES,
                         ids=list(chip_smoke.SPARSE_PARITY_IDS))
def test_sparse_kernel_matches_plain_version(cuda, case, variant):
    _, args, mask = chip_smoke.sparse_parity_inputs(case, cuda)
    b = args[0].shape[0]
    kw = dict(_SPARSE_KW, ctrl_mask=mask)
    v = chip_smoke.sparse_variants(args, kw, b)[variant]
    before = bittide_sparse.launches
    got = bittide_sparse(*args, **kw, **v)
    torch.cuda.synchronize()
    assert bittide_sparse.launches == before + 1
    want = bittide_sparse_torch(*args, **kw, **v)
    records = chip_smoke.SPARSE_RECORDS
    if v.get("record_guard"):
        assert torch.equal(got.guard_state, want.guard_state)
        tstar = int(want.guard_state.min())
        assert (tstar < records - 1) == (variant == 4)
        records = min(tstar, records - 1) + 1
    chip_smoke.kernel_vs_plain(got, want, records=records, exact=True)


@pytest.mark.parametrize("case,grouped", [
    (("random_regular_300", 1024, "shared"), False),
    (("torus3d_21", 235, "shared"), True)], ids=["direct", "grouped"])
def test_sparse_draw_bits_independent_of_batch(cuda, case, grouped):
    """Draws run alone (the direct pass) equal their rows of a batch, bit
    for bit, every variant on: a direct batch of 1,024 and a grouped batch
    of 235 (8 draws per thread, the last group of 3)."""
    _, args, mask = chip_smoke.sparse_parity_inputs(case, cuda)
    b = args[0].shape[0]
    kw = dict(_SPARSE_KW, record_beta=True, record_watermarks=True)
    full = bittide_sparse(*args, ctrl_mask=mask, **kw)
    assert sparse_device_plan()["grouped"] == grouped
    for d in (0, b // 2, b - 1):
        sub = [x[d:d + 1].contiguous() if k in _SPARSE_PER_DRAW else x
               for k, x in enumerate(args)]
        one = bittide_sparse(*sub, ctrl_mask=mask[d:d + 1].contiguous(),
                             **kw)
        assert torch.equal(full.freq[:, d:d + 1], one.freq)
        assert torch.equal(full.beta[:, d:d + 1], one.beta)
        assert torch.equal(full.psi[d:d + 1], one.psi)
        for got, want in zip(full.watermarks, one.watermarks):
            assert torch.equal(got[d:d + 1], want)


@pytest.mark.parametrize("case", chip_smoke.SPARSE_PARITY_CASES,
                         ids=list(chip_smoke.SPARSE_PARITY_IDS))
def test_sparse_library_reports_the_launch_plan(cuda, case):
    """The built library ran the plan Python computed: grouped for the
    shared torus3d(21) x 235 tables, direct for the rest."""
    _, args, mask = chip_smoke.sparse_parity_inputs(case, cuda)
    b, n = args[0].shape
    bittide_sparse(*args, ctrl_mask=mask, **_SPARSE_KW)
    torch.cuda.synchronize()
    plan = sparse_launch_plan(b, n, int(args[3].shape[0]),
                              args[4].shape[0] == args[5].shape[0] == 1)
    assert sparse_device_plan() == plan
    assert plan["grouped"] == (case[0] == "torus3d_21")


@pytest.mark.parametrize("bad", [
    ("per_draw_dropped", dict(grouped=True, draws_per_thread=3,
                              grid=(2, 3))),
    ("shared", dict(draws_per_thread=2)),
    ("shared", dict(nodes_per_cta=48, threads=48))],
    ids=["grouped_per_draw_tables", "direct_two_draws", "ragged_tile"])
def test_sparse_library_refuses_a_plan_it_cannot_run(cuda, monkeypatch, bad):
    """The C entry point checks the plan it is handed and launches nothing
    on one it cannot run."""
    import repro_torch.kernels.bittide_sparse as mod
    tables, change = bad
    _, args, mask = chip_smoke.sparse_parity_inputs(
        ("random_regular_300", 9, tables), cuda)
    monkeypatch.setattr(mod, "sparse_launch_plan",
                        lambda *a: dict(sparse_launch_plan(*a), **change))
    before = bittide_sparse.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        bittide_sparse(*args, ctrl_mask=mask, **_SPARSE_KW)
    assert bittide_sparse.launches == before


def test_sparse_shared_and_per_draw_tables_equal(cuda):
    """Shared (1, K, N) tables and the same tables repeated per draw (row
    stride K·N instead of 0) give equal rows, bit for bit."""
    _, args, mask = chip_smoke.sparse_parity_inputs(
        ("bounded_degree_96", 16, "shared"), cuda)
    b = args[0].shape[0]
    rep = list(args)
    rep[4] = args[4].expand(b, -1, -1).contiguous()
    rep[5] = args[5].expand(b, -1, -1).contiguous()
    kw = dict(_SPARSE_KW, ctrl_mask=mask, record_beta=True,
              record_watermarks=True)
    a = bittide_sparse(*args, **kw)
    c = bittide_sparse(*rep, **kw)
    assert torch.equal(a.freq, c.freq) and torch.equal(a.beta, c.beta)
    assert torch.equal(a.psi, c.psi) and torch.equal(a.nu, c.nu)


def test_sparse_guard_freezes_the_batch_at_the_earliest_trip(cuda):
    """Draws whose bands trip at different records: every draw stops at the
    batch's earliest trip t* — records after t* are NaN and the final state
    is the state at t*, the plain version's, bit for bit."""
    _, args, mask = chip_smoke.sparse_parity_inputs(
        ("random_regular_300", 9, "shared"), cuda)
    kw = dict(_SPARSE_KW, ctrl_mask=mask)
    v = chip_smoke.sparse_variants(args, kw, args[0].shape[0])[4]
    got = bittide_sparse(*args, **kw, **v)
    want = bittide_sparse_torch(*args, **kw, **v)
    trips = got.guard_state[:, 0]
    tstar = int(trips.min())
    assert torch.equal(trips, want.guard_state[:, 0])
    assert 0 < tstar < chip_smoke.SPARSE_RECORDS - 1
    assert bool((trips > tstar).any())
    assert torch.isnan(got.freq[tstar + 1:]).all()
    assert torch.equal(got.psi, want.psi) and torch.equal(got.nu, want.nu)
    stop = bittide_sparse_torch(*args, **dict(kw, num_records=tstar + 1))
    assert torch.equal(got.freq[:tstar + 1], stop.freq)


def test_sparse_lane_runs_on_the_card(cuda):
    """simulate_ensemble_dense and run_scenario with engine="sparse" and the
    device default launch the sparse kernel; a LinkDrop campaign's per-draw
    weights run on it within LINKDROP_ATOL_PPM of the segment-sum lane."""
    from repro_torch.scenarios import (ChaosCampaign, FreqStepSampler,
                                       LinkDropSampler)
    topo = tc.torus3d(4)
    ppm = np.random.default_rng(0).uniform(-8, 8, (16, topo.num_nodes))
    before = bittide_sparse.launches
    res = tk.simulate_ensemble_dense(
        topo, tc.make_links(topo), ppm, 400, 2e-8, dt=1e-3,
        record_every=20, options=tk.EngineOptions(engine="sparse"),
        telemetry=Telemetry(beta=True, watermarks=True))
    assert bittide_sparse.launches == before + 1
    assert res.engine == "sparse" and np.isfinite(res[0]).all()
    camp = ChaosCampaign(
        topo=topo, ctrl=tc.ControllerConfig(kp=2e-8),
        samplers=(FreqStepSampler(t=0.06, ppm_range=(1.0, 4.0)),
                  LinkDropSampler(t=0.1, t_restore=0.16)),
        num_draws=16, seed=5, ppm_range=8.0,
        cfg=tc.SimConfig(dt=1e-3, steps=240, record_every=12),
        engine="sparse")
    result = camp.run()
    assert bittide_sparse.launches > before + 1
    seg = run_scenario(topo, camp.links, camp.ctrl, result.ppm_u,
                       result.scenario, camp.cfg,
                       options=tk.EngineOptions(engine="segment-sum"),
                       telemetry=Telemetry(beta=True))
    np.testing.assert_allclose(result.result.freq_ppm, seg.freq_ppm, rtol=0,
                               atol=chip_smoke.LINKDROP_ATOL_PPM)


@pytest.mark.parametrize("case", chip_smoke.PERSTEP_PARITY_CASES)
def test_perstep_kernel_matches_plain_version(cuda, case):
    """bittide_perstep against its plain version at 0.0 error on
    ``PERSTEP_PARITY_CASES``, every variant and the guard tripping at a
    mid record and never; the C loop launches one kernel per period and
    two per measure pass."""
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    _, args, mask = chip_smoke.perstep_inputs(case, cuda)
    kw = dict(num_records=chip_smoke.PERSTEP_RECORDS,
              record_every=chip_smoke.PERSTEP_EVERY, ctrl_mask=mask)
    for v in chip_smoke.perstep_variants(args, kw):
        before = bittide_perstep.launches
        got = bittide_perstep(*args, **kw, **v)
        torch.cuda.synchronize()
        measure = v["record_beta"] or v["record_watermarks"]
        assert bittide_perstep.launches - before == \
            kw["num_records"] * (kw["record_every"] + 2 * measure)
        want = bittide_perstep_torch(*args, **kw, **v)
        assert torch.equal(got.freq, want.freq)
        assert torch.equal(got.psi, want.psi)
        assert torch.equal(got.nu, want.nu)
        if v["record_beta"]:
            assert torch.equal(got.beta, want.beta)
        if v["record_watermarks"]:
            for g, w in zip(got.watermarks, want.watermarks):
                assert torch.equal(g, w)
        if v.get("record_guard"):
            assert torch.equal(got.guard_state, want.guard_state)


def test_perstep_alone_equals_chunk_and_fused(cuda):
    """A draw's bits on the card do not depend on how its periods are cut
    into calls (one record per call, threaded, equals one call of all
    records) nor on the kernel (the fused kernel at B = 1 gives the same
    bits)."""
    from repro_torch.kernels.bittide_step import bittide_perstep
    _, args, mask = chip_smoke.perstep_inputs("fc8_spool", cuda)
    kw = dict(record_every=5, ctrl_mask=mask, record_beta=True)
    whole = bittide_perstep(*args, num_records=4, **kw)
    psi, nu = args[0], args[1]
    for t in range(4):
        one = bittide_perstep(psi, nu, *args[2:], num_records=1, **kw)
        assert torch.equal(one.freq[0], whole.freq[t])
        assert torch.equal(one.beta[0], whole.beta[t])
        psi, nu = one.psi.clone(), one.nu.clone()
    assert torch.equal(psi, whole.psi) and torch.equal(nu, whole.nu)
    b1 = lambda x: x[None].contiguous()
    gain = lambda x: torch.tensor([x], dtype=torch.float32, device=cuda)
    fused = bittide_fused(b1(args[0]), b1(args[1]), b1(args[2]), args[3],
                          args[4], b1(args[5]), b1(args[6]), gain(args[7]),
                          gain(args[8]), args[9], num_records=4,
                          ctrl_mask=b1(mask), record_every=5,
                          record_beta=True)
    assert torch.equal(fused.freq[:, 0], whole.freq)
    assert torch.equal(fused.beta[:, 0], whole.beta)


def test_perstep_guard_freezes_on_the_card(cuda):
    """After the trip (and after the stop cap) the card's launches are
    no-ops: the frozen records re-emit the trip record's ν with zero β,
    and the state stays at the freeze."""
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    _, args, mask = chip_smoke.perstep_inputs("torus3d_7", cuda)
    kw = dict(num_records=chip_smoke.PERSTEP_RECORDS,
              record_every=chip_smoke.PERSTEP_EVERY, ctrl_mask=mask)
    trip_v = chip_smoke.perstep_variants(args, kw)[4]
    for stop in (kw["num_records"] - 1, 1):
        v = dict(trip_v, guard_stop=stop)
        got = bittide_perstep(*args, **kw, **v)
        want = bittide_perstep_torch(*args, **kw, **v)
        trip = int(got.guard_state)
        last = min(trip, stop)
        assert trip == int(want.guard_state)
        assert torch.equal(got.freq, want.freq)
        assert torch.equal(got.freq[last + 1:],
                           got.nu.expand(kw["num_records"] - last - 1, -1))
        assert not got.beta[last + 1:].any()
        assert torch.equal(got.psi, want.psi)


# Phase 12 (d): the model stack at ``.reduced()``, the same weights on the
# card and on the CPU, at the reference's decode-vs-forward bar; and
# decode == forward on the card for one dense and one ssm architecture.
MODEL_ARCHS = ["arctic-480b", "internlm2-1.8b", "llama3-8b", "mamba2-370m",
               "phi3-medium-14b", "pixtral-12b", "qwen2-moe-a2.7b",
               "seamless-m4t-large-v2", "smollm-135m", "zamba2-7b"]


@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_model_serving_card_matches_cpu(cuda, name):
    row = chip_smoke.card_vs_cpu(name, cuda)
    assert row["excess"] <= 0.0, row
    assert row["tokens_equal"] == row["sure"], row


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-370m"])
def test_model_decode_consistent_with_forward_on_the_card(cuda, name):
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo, materialize
    cfg = get_config(name).reduced()
    zoo = ModelZoo(cfg)
    params = materialize(zoo.param_defs(),
                         torch.Generator(device=cuda).manual_seed(0),
                         torch.float32, device=cuda)
    tokens = chip_smoke.model_batch(cfg, 2, 32, 3, cuda)["tokens"]
    with torch.inference_mode():
        check = chip_smoke.decode_vs_forward(zoo, params, tokens)
    assert check["excess"] <= 0.0, check
    assert check["sure_equal"] == check["sure"], check


# Phase 13 (c): the training path at ``.reduced()`` on the card against the
# CPU, at the CPU tests' bars (chip_smoke.py restates them;
# tests/test_torch_package_rules.py ties the copies together).
@pytest.mark.parametrize("name", MODEL_ARCHS)
def test_train_step_card_matches_cpu(cuda, name):
    row = chip_smoke.train_card_vs_cpu(name, cuda)
    assert row["loss_rel"] <= chip_smoke.TRAIN_LOSS_REL, row
    assert row["grad_excess"] <= 0.0, row
    assert row["adamw_excess"] <= 0.0, row


def test_checkpoint_from_the_cpu_restores_on_the_card(cuda, tmp_path):
    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint import restore, save
    tree = {"params": {"w": torch.linspace(-2, 2, 12).reshape(3, 4),
                       "b": torch.linspace(-1, 1, 5).to(torch.bfloat16)},
            "opt": {"count": torch.tensor(3, dtype=torch.int32)}}
    save(str(tmp_path), 3, tree)
    out = restore(str(tmp_path), 3, tree)
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.device.type == "cuda"
        assert chip_smoke.bit_equal(a.cpu(), b)


def test_synthetic_batches_equal_on_card_and_cpu(cuda):
    from repro_torch.data import DataConfig, SyntheticPipeline
    data = SyntheticPipeline(DataConfig(49_152, 256, 8, seed=0))
    for step in (0, 50):
        got, want = data.batch(step), data.batch(step, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), want[k])
        np.testing.assert_array_equal(want["tokens"].numpy(),
                                      data.batch_numpy(step)["tokens"])


# Phase 14: the distributed training path on a one-rank NCCL mesh.
def test_mesh_step_on_one_rank_nccl_equals_plain_step(cuda):
    """A (1, 1) mesh on a one-rank NCCL group: ``init_train_state`` on the
    mesh, three mesh steps against three plain steps from the same
    seed and batches, the loss and every leaf bit for bit; a save from
    the mesh restored through ``remesh`` bit for bit."""
    import tempfile
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.ft import remesh
    from repro_torch.launch import (init_train_state, make_train_step,
                                    state_shardings)
    cfg = get_config("smollm-135m").reduced()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = remesh([0], model_size=1)
        p_m, o_m = init_train_state(
            cfg, mesh, torch.Generator(device=cuda).manual_seed(0))
        p, o = init_train_state(
            cfg, None, torch.Generator(device=cuda).manual_seed(0))
        step = make_train_step(cfg)
        data = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 4, seed=3))
        for n in range(3):
            batch = data.batch(n)
            p_m, o_m, mm = step(p_m, o_m, batch, n)
            p, o, m = step(p, o, batch, n)
            assert chip_smoke.bit_equal(mm["loss"], m["loss"]), n
            assert mm["all_reduces"] == len(tree_leaves(p)) + 1
            diff = chip_smoke.mesh_state_bits({"p": p_m, "o": o_m},
                                              {"p": p, "o": o})
            assert not diff, (n, diff)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(3, {"params": p_m, "opt": o_m})
            n, got = mgr.restore_latest(
                {"params": p, "opt": o},
                shardings=state_shardings(cfg, remesh([0], model_size=1)))
        assert n == 3
        assert not chip_smoke.mesh_state_bits(got, {"params": p, "opt": o})
    finally:
        dist.destroy_process_group()


def test_compression_on_the_card_equals_the_cpu(cuda):
    """``compress`` and ``ef_roundtrip`` on the card bit for bit with the
    CPU over ten decades of scale, ties of the int8 grid included."""
    from repro_torch.optim.compression import compress, ef_roundtrip
    rng = np.random.default_rng(0)
    for scale in (1e-6, 1e-3, 1.0, 1e4):
        g = torch.tensor(rng.normal(0, scale, (64, 576)),
                         dtype=torch.float32)
        g[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5]) * scale
        e = torch.tensor(rng.normal(0, scale / 100, (64, 576)),
                         dtype=torch.float32)
        q, s = compress(g.to(cuda))
        q_c, s_c = compress(g)
        assert torch.equal(q.cpu(), q_c)
        assert chip_smoke.bit_equal(s.cpu(), s_c)
        for a, b in zip(ef_roundtrip(g.to(cuda), e.to(cuda)),
                        ef_roundtrip(g, e)):
            assert chip_smoke.bit_equal(a.cpu(), b)
