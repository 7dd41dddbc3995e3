#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line:

1. build    — nvcc builds ``csrc/bittide_fused.cu`` and
              ``csrc/bittide_tiled.cu`` in parallel; their ptxas reports
              (registers, shared memory, spills) and the card's
              ``nvidia-smi`` name and power limit are printed.
2. parity   — each kernel against its plain PyTorch version on the card.
              Fused (``PARITY_CASES``): FC8 at B=64 and at 4·SMs·3 + 5
              draws (three draws per CTA, a partial last CTA), torus3d(6)
              at B=16 with two latency classes (A read from L2) and with
              one (A in shared memory); per-draw kp / lat / lamsum /
              holdover mask, 400 periods recorded every 20, all four
              variants.  Tiled (``TILED_PARITY_CASES``): torus3d(8) at
              B=9 (two draw groups, the second partial) and torus3d(7)
              (ragged tiles) at B=5, one class and two (the second a
              single directed edge, so the stack is not symmetric), every
              variant plus the guard with bands that trip at different
              records and with bands that never trip.  The fused guard
              (``FUSED_GUARD_CASES``) with draws tripping at different
              records, so that the wrapper's replay runs: FC8 at B=64, and
              torus3d(8) at B=9 with two classes (N=512 > 256: 512 threads
              per CTA, A read from L2).
3. fc8      — the main path at users' size: ``simulate_ensemble_dense`` on
              fully_connected(8), B=4096 draws in ±8 ppm, kp=2e-8,
              dt=5e-5, 10,000 steps recorded every 20, β + watermarks;
              256 draws held against the segment-sum lane on the card.
4. torus    — torus3d(6), B=256, kp=2e-8, dt=1e-3, 2,000 steps,
              watermarks; 16 draws held against the segment-sum lane.
5. segsum   — the segment-sum lane: cube, B=64, the quickstart's discrete
              controller with quantized β, dt=1e-3, 2,000 steps; every
              draw must converge into the 1 ppm band.
6. tiled    — the tiled lane at Fig-18 size: ``simulate_ensemble_dense``
              on torus3d(22) (10,648 nodes, A = 453.5 MB), B=8 draws in
              ±8 ppm, 2 m cables, kp=2e-8, dt=5e-3, 2,000 periods recorded
              every 100, watermarks; ν against the segment-sum lane, and
              every draw converged.  A ``torch.matmul`` of the same shapes
              per pass is timed as a yardstick for the aggregation alone,
              and the kernel's 16-byte panel copies against its 4-byte ones
              (the same stack one float past a 16-byte boundary).

Phases 3, 4 and 6 (``run_main_path``) also time the kernel with CUDA events
on the main path's own inputs, check that one more launch reproduces the
main path's records bit for bit, hold it against the plain version over
every draw (phase 6: over 2 records × 2 periods with the measure pass at
the main path's launch layout), and time the host side of the call piece
by piece: the stack scatter, its copy to the card, the record copies back.

7. scenario — ``run_scenario`` (device default) on examples/cable_swap.py's
              scenario at its full 40,000 periods (FC8, dt=1e-4, records
              every 20, a re-establishing LatencyStep half way, β) over
              256 draws on the fused lane: launches, wall, memory, the
              RTT shift, and ν against the segment-sum lane at the smoke
              length (4,000 periods).  Then tests/test_reframing.py's
              torus case (torus3d(8), DriftRamp + LatencyStep,
              ReframePolicy(depth=16, margin=5.0)) on the tiled (auto) and
              the forced fused lane: identical splices and shifts,
              ``guard_latency == 1``, at least 3 splices.  Every engine
              call of these runs is held against the plain version on the
              call's own inputs (``hold_engine_calls``; the cable swap's
              1,000-record calls over their first 50 records).

Then the kernels line, the card's ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and ends the
run with a non-zero exit; without a CUDA card it exits 2 and prints no
result.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The bars of tests/engine_harness.py (tests/test_torch_package_rules.py
# checks that they agree).
FREQ_ATOL_PPM = 1e-6
BETA_ATOL_FRAMES = 1e-6

# H100 SXM peaks (NVIDIA data sheet): float32 without tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def two_class_links(topo):
    """2 m cables, plus 1000 m on both directions of the pair (0, 1)."""
    import numpy as np
    from repro_torch.core import make_links
    cable = np.full(topo.num_edges, 2.0)
    pair = ((topo.src == 0) & (topo.dst == 1)) | (
        (topo.src == 1) & (topo.dst == 0))
    cable[pair] = 1000.0
    return make_links(topo, cable_m=cable)


# Kernel-vs-plain cases of phase 2 and of the card tests: (topology,
# draws, latency classes).  "waves" stands for 4·SMs·3 + 5 draws of FC8:
# three draws per CTA and a partial last CTA.  torus3d(6) with two classes
# (2·216²·4 B = 373 KB) reads A from L2; with one class (187 KB) A sits in
# shared memory, as on phase 4's main path.
PARITY_CASES = (("fully_connected_8", 64, 2),
                ("fully_connected_8", "waves", 2),
                ("torus3d_6", 16, 2),
                ("torus3d_6", 16, 1))


def waves_draws(dev) -> int:
    """FC8 draws that give three draws per CTA and a partial last CTA."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 4 * sms * 3 + 5


# Tiled kernel-vs-plain cases of phase 2 and of the card tests:
# (topology, draws, latency classes).  Two classes here means one long
# directed edge 0 → 1, so the stack is not symmetric.
TILED_PARITY_CASES = (("torus3d_8", 9, 1), ("torus3d_8", 9, 2),
                      ("torus3d_7", 5, 1), ("torus3d_7", 5, 2))
TILED_RECORDS, TILED_EVERY = 4, 3
# The fused guard cases: (case, records, record_every, stop caps).  Each
# draw's band trips near a record drawn from 1..records-1, so that draws
# run past the batch's earliest trip and the wrapper replays the chunk.
# FC8 at B=64, and torus3d(8) at B=9 with two classes: N=512 is beyond the
# fused regime, so one CTA of 512 threads per draw reads A from L2.
FUSED_GUARD_CASES = ((("fully_connected_8", 64, 2), 20, 20, (19, 7)),
                     (("torus3d_8", 9, 2), 6, 3, (5, 3)))


def one_way_links(topo):
    """2 m cables, plus 1000 m on the single directed edge 0 → 1."""
    import numpy as np
    from repro_torch.core import make_links
    cable = np.full(topo.num_edges, 2.0)
    cable[(topo.src == 0) & (topo.dst == 1)] = 1000.0
    return make_links(topo, cable_m=cable)


def parity_inputs(case, dev, one_way=False):
    """(topology, kernel args ending in Δ = 125,000 frames, per-draw mask)
    of one of ``PARITY_CASES`` / ``TILED_PARITY_CASES``."""
    import numpy as np
    from repro_torch.core import fully_connected, make_links, torus3d
    name, b, classes = case
    topo = {"fully_connected_8": lambda: fully_connected(8),
            "torus3d_6": lambda: torus3d(6), "torus3d_7": lambda: torus3d(7),
            "torus3d_8": lambda: torus3d(8)}[name]()
    b = waves_draws(dev) if b == "waves" else b
    links = ((one_way_links(topo) if one_way else two_class_links(topo))
             if classes == 2 else make_links(topo, cable_m=2.0))
    ppm = np.random.default_rng(1).uniform(-8, 8, (b, topo.num_nodes))
    args, mask = fused_inputs(topo, links, ppm, 2e-8, dev, seed=2)
    assert args[3].shape[0] == classes, args[3].shape
    return topo, args + (125000.0,), mask


def kernel_vs_plain(got, want, records=None) -> dict:
    """The kernel's errors against the plain version's outputs over the
    first ``records`` records (all by default; a guard freeze leaves the
    later ones unrun); raises when one leaves its bar (ν at
    FREQ_ATOL_PPM, β and max |β| at BETA_ATOL_FRAMES, watermark and trip
    indices exactly)."""
    import torch
    r = slice(None) if records is None else slice(0, records)
    err = dict(freq_err_ppm=float(
        (got.freq[r] - want.freq[r]).abs().max() * 1e6),
        psi_err_frames=float((got.psi - want.psi).abs().max()))
    if got.beta is not None:
        err["beta_err_frames"] = float(
            (got.beta[r] - want.beta[r]).abs().max())
    if got.watermarks is not None:
        err["peak_record_equal"] = bool(torch.equal(got.watermarks[1],
                                                    want.watermarks[1]))
        err["beta_abs_max_err_frames"] = float(
            (got.watermarks[0] - want.watermarks[0]).abs().max())
    if got.guard_state is not None:
        err["trip_equal"] = bool(torch.equal(got.guard_state,
                                             want.guard_state))
        assert err["trip_equal"], err
    assert err["freq_err_ppm"] <= FREQ_ATOL_PPM, err
    assert err.get("beta_err_frames", 0.0) <= BETA_ATOL_FRAMES, err
    assert err.get("beta_abs_max_err_frames", 0.0) <= BETA_ATOL_FRAMES, err
    assert err.get("peak_record_equal", True), err
    return err


def fused_inputs(topo, links, ppm, kp, dev, seed=None):
    """The fused kernel's arguments for a cold start.

    With ``seed`` the scenario knobs vary per draw (kp jitter, class
    latencies ±1 %, λeff folds in ±2 frames, setpoints in ±1 frame,
    holdover on nodes 0 and 1 for about half the draws); without it the
    arguments are those ``simulate_ensemble_dense`` builds.
    """
    import numpy as np
    import torch
    from repro_torch.kernels import densify
    a_t, _, classes, _ = densify(topo, links, device=dev)
    b, n = ppm.shape
    c = a_t.shape[0]
    put = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev)
    nu_u = put(ppm.astype(np.float32) * np.float32(1e-6))
    lat = np.broadcast_to(classes.cpu().numpy(), (b, c))
    kp_v = np.full(b, kp, np.float32)
    boff = np.zeros(b, np.float32)
    lamsum = np.zeros((b, n), np.float32)
    mask = np.ones((1, n), np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        lat = lat * rng.uniform(0.99, 1.01, (b, 1))
        kp_v = kp * rng.uniform(0.5, 1.5, b)
        boff = rng.uniform(-1, 1, b)
        lamsum = rng.uniform(-2, 2, (b, n))
        mask = np.ones((b, n), np.float32)
        mask[:, :2] = np.where(rng.random((b, 1)) < 0.5, 0.0, 1.0)
    args = (torch.zeros_like(nu_u), nu_u, nu_u.clone(), a_t,
            a_t.sum(dim=(0, 1)), put(lamsum), put(lat), put(kp_v), put(boff))
    return args, put(mask)


def bound(b, n, c, nnz, steps, records, beta, wm):
    """(bound_ms, bound_by) for one call of a dense kernel.

    Bytes: every input read once, every output written once.  Operations:
    what this run's data needs — 2 per nonzero of the stack per period
    plus the per-node update (x_c: 2C, err/ν'/ψ': 10), and at records
    with β or watermarks the row mean (N + 1 per draw) and the measure
    pass (2 per nonzero + 3C per node + 4).
    """
    nodes = b * n
    in_bytes = 4 * (4 * nodes + c * n * n + n + b * c + 2 * b + n)
    out_bytes = 4 * (2 * nodes + records * nodes * (1 + beta) + 4 * wm * nodes)
    ops = b * steps * (2 * nnz + n * (2 * c + 10))
    if beta or wm:
        ops += b * records * (n + 1 + 2 * nnz + n * (3 * c + 4))
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def float32_floor_ppm(kp, deg_max, psi_max):
    """Float32 floor between two implementations of the period loop, ppm.

    The fused lane forms err = Σ_j A_ij (ψ_j − ν_j·lat) − ψ_i·deg_i + …,
    sums of size deg·|ψ| that cancel to O(1) frames, where the segment-sum
    lane sums the per-edge β directly; and two implementations that round
    ψ + ν·Δ differently (a fused multiply-add or not) hold ψ apart by ulps
    of |ψ|.  Each of the deg + 2 roundings at that size is at most an ulp
    of deg·max|ψ|, and ν follows err through kp.
    """
    import numpy as np
    return float(kp * (deg_max + 2)
                 * np.spacing(np.float32(deg_max * psi_max)) * 1e6)


def summary(freq_ppm, times):
    import numpy as np
    from repro_torch.core.frame_model import _convergence_time
    band = freq_ppm[:, -1].max(axis=1) - freq_ppm[:, -1].min(axis=1)
    spread = freq_ppm.max(axis=2) - freq_ppm.min(axis=2)
    conv = np.array([_convergence_time(s, times, 1.0) for s in spread])
    return dict(final_band_ppm_max=float(band.max()),
                final_band_ppm_p50=float(np.median(band)),
                convergence_s_p50=float(np.percentile(conv, 50)),
                convergence_s_p95=float(np.percentile(conv, 95)),
                converged_draws=int(np.isfinite(conv).sum()))


def trip_bands(args, kw, recs):
    """(B,) guard band half-widths (frames per unit degree) that trip draw
    b near record ``recs[b]`` of the guard-off plain run, or never where
    ``recs[b]`` is None."""
    import torch
    from repro_torch.kernels.bittide_step import bittide_fused_torch
    base = bittide_fused_torch(*args, **dict(kw, record_beta=True,
                                             record_watermarks=False))
    deg = args[4].clamp(min=1.0)
    peak = (base.beta.abs() / deg).amax(dim=2)               # (R, B)
    return torch.stack([peak[r, i] * 0.999 if r is not None
                        else 10 * peak.max()
                        for i, r in enumerate(recs)]).contiguous()


def phase_parity(dev):
    """Each kernel vs its plain version on the card; returns the max
    errors per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  bittide_tiled,
                                                  launch_plan,
                                                  tiled_launch_plan)
    worst = {k: dict(freq_ppm=0.0, beta_frames=0.0)
             for k in ("bittide_fused", "bittide_tiled")}

    def note(kernel, row):
        emit(row)
        w = worst[kernel]
        w["freq_ppm"] = max(w["freq_ppm"], row["freq_err_ppm"])
        w["beta_frames"] = max(w["beta_frames"],
                               row.get("beta_err_frames", 0.0))

    plans = []
    for case in PARITY_CASES:
        topo, args, mask = parity_inputs(case, dev)
        b, n = args[0].shape
        plan = launch_plan(b, n, args[3].shape[0], dev)
        plans.append((plan, b))
        for beta, wm in ((False, False), (True, False), (False, True),
                         (True, True)):
            kw = dict(num_records=20, record_every=20, ctrl_mask=mask,
                      record_beta=beta, record_watermarks=wm)
            got = bittide_fused(*args, **kw)
            torch.cuda.synchronize()
            want = bittide_fused_torch(*args, **kw)
            row = dict(phase="parity", kernel="bittide_fused",
                       topology=topo.name, draws=b,
                       classes=args[3].shape[0], beta=beta, watermarks=wm,
                       launch_plan=plan)
            row.update(kernel_vs_plain(got, want))
            note("bittide_fused", row)
    # The cases reach A in shared memory and in L2, and several draws per
    # CTA with a partial last CTA.
    assert {p["a_in_smem"] for p, _ in plans} == {True, False}, plans
    assert any(p["draws_per_cta"] > 1 and b % p["draws_per_cta"]
               for p, b in plans), plans

    # The fused guard: draws trip at different records, so the wrapper
    # launches the chunk twice (the second time capped at the earliest
    # trip).
    for case, records, every, stops in FUSED_GUARD_CASES:
        topo, args, mask = parity_inputs(case, dev)
        b, n = args[0].shape
        kw = dict(num_records=records, record_every=every, ctrl_mask=mask)
        recs = np.random.default_rng(5).integers(1, records, b).tolist()
        band = trip_bands(args, kw, recs)
        for stop in stops:
            gkw = dict(kw, record_beta=True, record_watermarks=True,
                       record_guard=True, guard_lo=-band, guard_hi=band,
                       guard_stop=stop)
            before = bittide_fused.launches
            got = bittide_fused(*args, **gkw)
            torch.cuda.synchronize()
            launches = bittide_fused.launches - before
            want = bittide_fused_torch(*args, **gkw)
            trips = want.guard_state[:, 0]
            valid = min(int(trips.min()), stop) + 1
            row = dict(phase="parity", kernel="bittide_fused", guard=True,
                       topology=topo.name, draws=b,
                       classes=args[3].shape[0], stop=stop,
                       earliest_trip=int(trips.min()),
                       tripped_draws=int((trips == trips.min()).sum()),
                       launches=launches, valid_records=valid,
                       launch_plan=launch_plan(b, n, args[3].shape[0], dev,
                                               guard=True))
            row.update(kernel_vs_plain(got, want, records=valid))
            # Draws ran past the earliest trip, so the chunk was replayed.
            assert launches == 2 and row["earliest_trip"] < stop, row
            note("bittide_fused", row)

    for case in TILED_PARITY_CASES:
        topo, args, mask = parity_inputs(case, dev, one_way=True)
        b, n = args[0].shape
        kw = dict(num_records=TILED_RECORDS, record_every=TILED_EVERY,
                  ctrl_mask=mask)
        variants = [dict(record_beta=beta, record_watermarks=wm)
                    for beta, wm in ((False, False), (True, False),
                                     (False, True), (True, True))]
        for trips in (True, False):
            recs = [1 + i % 3 if trips else None for i in range(b)]
            band = trip_bands(args, kw, recs)
            variants.append(dict(record_beta=True, record_watermarks=True,
                                 record_guard=True, guard_lo=-band,
                                 guard_hi=band,
                                 guard_stop=TILED_RECORDS - 1))
        trip_rows = []
        for v in variants:
            got = bittide_tiled(*args, **kw, **v)
            torch.cuda.synchronize()
            want = bittide_fused_torch(*args, **kw, **v)
            valid = TILED_RECORDS
            row = dict(phase="parity", kernel="bittide_tiled",
                       topology=topo.name, draws=b,
                       classes=args[3].shape[0], beta=v["record_beta"],
                       watermarks=v["record_watermarks"],
                       guard=v.get("record_guard", False),
                       launch_plan=tiled_launch_plan(b, n))
            if row["guard"]:
                valid = min(int(want.guard_state.min()), TILED_RECORDS) + 1
                row["earliest_trip"] = int(want.guard_state.min())
                trip_rows.append(row["earliest_trip"])
            row.update(kernel_vs_plain(got, want, records=valid))
            note("bittide_tiled", row)
        # One band set trips inside the chunk, the other never.
        assert trip_rows[0] < TILED_RECORDS - 1 and \
            trip_rows[1] == TILED_RECORDS, trip_rows
    return worst


def timed(fn):
    """(result, host seconds) of ``fn()``, synchronized with the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_split(topo, links, out, tel, dev, reps: int = 3) -> dict:
    """The host side of one ``simulate_ensemble_dense`` call, timed piece
    by piece as that call does it (median of ``reps``): the stack's
    scatter on the host, its copy to the card, and the copies of the
    records and state back."""
    import numpy as np
    import torch
    from repro_torch.core.frame_model import OMEGA_NOM
    from repro_torch.kernels.ops import _scatter, latency_classes
    classes, inv = latency_classes(
        np.asarray(links.latency_s, np.float64) * OMEGA_NOM)
    scatter = lambda: _scatter(topo, inv, len(classes),
                               np.ones(topo.num_edges))
    stack = scatter()
    rec = lambda x: x.transpose(0, 1).contiguous().cpu().numpy()

    def back():
        rec(out.freq * 1e6)
        out.psi.cpu(), out.nu.cpu()
        if tel.beta:
            rec(out.beta)
        if tel.watermarks:
            [w.cpu() for w in out.watermarks]
    median = lambda fn: float(np.median([timed(fn)[1] for _ in range(reps)]))
    return dict(host_stack_scatter_s=median(scatter),
                stack_to_card_s=median(
                    lambda: torch.as_tensor(stack, device=dev)),
                records_to_host_s=median(back))


def run_main_path(name, topo, b, kp, dt, steps, rec, tel, dev, engine,
                  subset, reps, plain_depth=None):
    """One main-path run of a dense lane plus its measurements.

    ``simulate_ensemble_dense`` runs with the kernel's count set to 0 just
    before and read just after.  Then the segment-sum lane on ``subset``
    draws; the kernel's CUDA-event time over ``reps`` launches on the main
    path's inputs; one more launch that must reproduce the main path's
    records bit for bit; the call's wall again (median of 3) beside its
    host side (``host_split``); and the plain version on the same inputs
    over every draw — at the main path's depth, or over ``plain_depth`` =
    (records, record_every) with the kernel timed on the same work.
    """
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  simulate_ensemble)
    from repro_torch.kernels import simulate_ensemble_dense
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  bittide_tiled, launch_plan,
                                                  tiled_launch_plan)
    from repro_torch.telemetry import Watermarks
    kernel = {"fused": bittide_fused, "tiled": bittide_tiled}[engine]
    n = topo.num_nodes
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, n))
    records = steps // rec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    res = simulate_ensemble_dense(topo, links, ppm, steps, kp, dt=dt,
                                  record_every=rec, telemetry=tel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, f"{name}: the main path launched no {engine} kernel"

    freq, psi = res
    assert res.engine == engine, res.engine
    assert freq.shape == (b, records, n), freq.shape
    assert np.isfinite(freq).all() and np.isfinite(psi).all()
    if tel.beta:
        assert res.beta.shape == freq.shape and np.isfinite(res.beta).all()
    if tel.watermarks:
        assert np.isfinite(res.watermarks.beta_abs_max).all()
    if tel.beta and tel.watermarks:
        full = Watermarks.from_record(res.beta, freq)
        assert np.array_equal(res.watermarks.peak_record, full.peak_record)
        assert np.array_equal(res.watermarks.beta_abs_max,
                              full.beta_abs_max)
        assert np.array_equal(res.watermarks.nu_min_ppm, full.nu_min_ppm)

    times = (np.arange(1, records + 1) * rec) * dt
    ss = simulate_ensemble(topo, links, ControllerConfig(kp=kp),
                           ppm[:subset],
                           SimConfig(dt=dt, steps=steps, record_every=rec,
                                     record_beta=False))
    err_ss = float(np.abs(freq[:subset] - ss.freq_ppm).max())
    bar = max(FREQ_ATOL_PPM, float32_floor_ppm(
        kp, int(topo.in_degree.max()), float(np.abs(psi).max())))

    args, mask = fused_inputs(topo, links, ppm, kp, dev)
    c = args[3].shape[0]
    dt_frames = float(125e6 * dt)
    kw = dict(num_records=records, record_every=rec, ctrl_mask=mask,
              record_beta=tel.beta, record_watermarks=tel.watermarks)
    kernel_ms = cuda_ms(lambda: kernel(*args, dt_frames, **kw), reps)
    got = kernel(*args, dt_frames, **kw)
    host = lambda x: x.transpose(0, 1).cpu().numpy()
    assert np.array_equal(host(got.freq * 1e6), freq), \
        f"{name}: the compared launch differs from the main path's"
    if tel.beta:
        assert np.array_equal(host(got.beta), res.beta)
    # The call's wall again (median of 3; host times vary from call to
    # call) beside its pieces.
    walls = [timed(lambda: simulate_ensemble_dense(
        topo, links, ppm, steps, kp, dt=dt, record_every=rec,
        telemetry=tel))[1] for _ in range(3)]
    split = host_split(topo, links, got, tel, dev)
    split["wall_s_median3"] = float(np.median(walls))
    split["rest_of_call_s"] = (split["wall_s_median3"] - kernel_ms * 1e-3
                               - split["host_stack_scatter_s"]
                               - split["stack_to_card_s"]
                               - split["records_to_host_s"])

    if plain_depth is None:
        pkw, same_ms = kw, kernel_ms
    else:
        pkw = dict(kw, num_records=plain_depth[0],
                   record_every=plain_depth[1])
        got = kernel(*args, dt_frames, **pkw)
        same_ms = cuda_ms(lambda: kernel(*args, dt_frames, **pkw), 3)
    want, plain_s = timed(lambda: bittide_fused_torch(*args, dt_frames,
                                                      **pkw))
    err = kernel_vs_plain(got, want)
    nnz = float((args[3] != 0).sum())
    bound_ms, bound_by = bound(b, n, c, nnz, records * rec, records,
                               tel.beta, tel.watermarks)
    plan = (launch_plan(b, n, c, dev) if engine == "fused"
            else tiled_launch_plan(b, n))
    summ = summary(freq, times)
    out = dict(phase=name, topology=topo.name, nodes=n, draws=b,
               steps=steps, record_every=rec, dt=dt, kp=kp, engine=engine,
               stack_bytes=4 * c * n * n, launches=launches,
               launch_plan=plan, wall_s=wall, kernel_ms=kernel_ms,
               node_steps_per_s_kernel=b * n * steps / (kernel_ms * 1e-3),
               node_steps_per_s_wall=b * n * steps / wall,
               max_memory_allocated=mem, **split,
               segment_sum_draws=subset,
               freq_err_vs_segment_sum_ppm=err_ss,
               holds_freq_atol_ppm=err_ss <= FREQ_ATOL_PPM,
               segment_sum_bar_ppm=bar, plain_ms=plain_s * 1e3,
               plain_work=("the main path's" if plain_depth is None else
                           f"{plain_depth[0]} records x {plain_depth[1]} "
                           "periods" + (" + measure passes"
                                        if tel.beta or tel.watermarks
                                        else "")),
               kernel_ms_same_work=same_ms, kernel_vs_plain_draws=b,
               **{f"kernel_vs_plain_{k}": v for k, v in err.items()},
               bound_ms=bound_ms, bound_by=bound_by, **summ)
    assert err_ss <= bar, out
    assert summ["converged_draws"] == b, out
    return out, args, kw


def run_tiled(dev, k=22, b=8, steps=2_000, rec=100):
    """Phase 6: the tiled lane at Fig-18 size (see the module docstring)."""
    import torch
    from repro_torch.core import torus3d
    from repro_torch.kernels.bittide_step import bittide_tiled
    from repro_torch.telemetry import Telemetry
    out, args, kw = run_main_path(
        "tiled", torus3d(k), b, 2e-8, 5e-3, steps, rec,
        Telemetry(watermarks=True), dev, "tiled", subset=b, reps=1,
        plain_depth=(2, 2))
    n = out["nodes"]
    records = steps // rec
    passes = steps + records
    dt_frames = float(125e6 * out["dt"])
    out.update(kernel_passes=passes,
               kernel_ms_per_pass=out["kernel_ms"] / passes,
               dense_stream_bound_ms=passes * 4 * n * n / PEAK_BYTES_PER_S
               * 1e3)

    # Yardstick (not used by the port): one fp32 torch.matmul of the
    # per-pass aggregation's shapes, (B, N) x (N, N), times the passes.
    x = torch.randn(b, n, device=dev)
    mm_ms = cuda_ms(lambda: torch.matmul(x, args[3][0]), 5)
    emit(dict(phase="tiled", yardstick="torch.matmul (B,N)x(N,N) fp32 per "
              "pass, not used by the port", matmul_ms_per_pass=mm_ms,
              matmul_ms_all_passes=mm_ms * passes, passes=passes))

    # The stack's panels copied 16 bytes at a time (the main path) against
    # 4 bytes at a time: the same stack stored one float past a 16-byte
    # boundary takes the kernel's 4-byte path.  Same work, same bits.
    buf = torch.empty(args[3].numel() + 1, device=dev)
    a_off = buf[1:].view_as(args[3])
    a_off.copy_(args[3])
    off_args = args[:3] + (a_off,) + args[4:]
    ab = dict(kw, num_records=2, record_every=50)
    g16 = bittide_tiled(*args, dt_frames, **ab)
    g4 = bittide_tiled(*off_args, dt_frames, **ab)
    assert torch.equal(g16.freq, g4.freq) and torch.equal(g16.psi, g4.psi)
    ms = dict(b16=[], b4=[])
    for key in ("b16", "b4", "b4", "b16"):
        ms[key].append(cuda_ms(lambda: bittide_tiled(
            *(args if key == "b16" else off_args), dt_frames, **ab), 2))
    ab_passes = 2 * 50 + 2
    out.update(panel_copy_ms_per_pass_16B=[t / ab_passes for t in ms["b16"]],
               panel_copy_ms_per_pass_4B=[t / ab_passes for t in ms["b4"]])
    del buf, a_off, off_args
    return out


@contextlib.contextmanager
def recorded_engine_calls():
    """Record every dense-engine call that ``run_scenario`` makes, as
    (its arguments by name, its outputs)."""
    import inspect
    from repro_torch.scenarios import runner
    inner = runner._fused_engine
    sig = inspect.signature(inner)
    calls = []

    def record(*args, **kw):
        out = inner(*args, **kw)
        bound_args = sig.bind(*args, **kw)
        bound_args.apply_defaults()
        calls.append((dict(bound_args.arguments), out))
        return out
    runner._fused_engine = record
    try:
        yield calls
    finally:
        runner._fused_engine = inner


def hold_engine_calls(calls, max_records: int) -> dict:
    """Hold each recorded engine call against the plain version on the
    call's own inputs (B, N, C, variant, guard band and stop cap): the
    call's own outputs when it ran at most ``max_records`` records, else
    the kernel launched again on its inputs for its first ``max_records``
    records.  Raises when one leaves its bar (``kernel_vs_plain``);
    returns per kernel the worst errors and the number of calls held."""
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  bittide_tiled)
    worst = {}
    for a, out in calls:
        name = "bittide_" + a["engine"]
        args = (a["psi"], a["nu"], a["nu_u"], a["a_t"], a["deg"],
                a["lamsum"], a["lat"], a["kp"], a["beta_off"],
                a["dt_frames"])
        kw = dict(num_records=a["num_records"],
                  record_every=a["record_every"], ctrl_mask=a["ctrl_mask"],
                  record_beta=a["record_beta"],
                  record_watermarks=a["record_watermarks"],
                  record_guard=a["record_guard"], guard_lo=a["guard_lo"],
                  guard_hi=a["guard_hi"], guard_stop=a["guard_stop"])
        if kw["num_records"] > max_records:
            kw["num_records"] = max_records
            if kw["record_guard"]:
                kw["guard_stop"] = min(kw["guard_stop"], max_records - 1)
            kernel = {"bittide_fused": bittide_fused,
                      "bittide_tiled": bittide_tiled}[name]
            out = kernel(*args, **kw)
        want = bittide_fused_torch(*args, **kw)
        valid = kw["num_records"]
        if kw["record_guard"]:
            valid = min(int(want.guard_state.min()), kw["guard_stop"]) + 1
        err = kernel_vs_plain(out, want, records=valid)
        w = worst.setdefault(name, dict(calls=0, freq_ppm=0.0,
                                        beta_frames=0.0, psi_frames=0.0))
        w["calls"] += 1
        w["freq_ppm"] = max(w["freq_ppm"], err["freq_err_ppm"])
        w["beta_frames"] = max(w["beta_frames"],
                               err.get("beta_err_frames", 0.0))
        w["psi_frames"] = max(w["psi_frames"], err["psi_err_frames"])
    return worst


def run_scenarios(dev, b=256, steps=40_000):
    """Phase 7: run_scenario on the cable swap and the guarded torus."""
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, ReframePolicy, SimConfig,
                                  fully_connected, make_links, torus3d)
    from repro_torch.kernels import EngineOptions
    from repro_torch.kernels.bittide_step import bittide_fused, bittide_tiled
    from repro_torch.scenarios import (DriftRamp, LatencyStep, Scenario,
                                       edges_between, run_scenario)
    from repro_torch.telemetry import Telemetry
    topo = fully_connected(8)
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, 8)).astype(np.float32)
    ctrl = ControllerConfig(kp=2e-8)
    swap = edges_between(topo, 0, 2)

    def cable_swap(steps):
        return (Scenario(events=(LatencyStep(t=steps * 1e-4 / 2, edges=swap,
                                             cable_m=1000.0,
                                             reestablish=True),),
                         name="fiber-spool-swap"),
                SimConfig(dt=1e-4, steps=steps, record_every=20))

    sc, cfg = cable_swap(steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_fused.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls() as calls:
        res = run_scenario(topo, links, ctrl, ppm, sc, cfg,
                           options=EngineOptions(engine="fused"),
                           telemetry=Telemetry(beta=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_fused.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, "the scenario path launched no fused kernel"
    assert res.engine == "fused" and res.freq_ppm.shape == (b, steps // 20, 8)
    assert np.isfinite(res.freq_ppm).all() and np.isfinite(res.beta).all()
    rtt_shift = int((res.rtt(1) - res.rtt(0))[swap[0]])
    assert abs(rtt_shift - 1231) <= 3, rtt_shift
    spread = res.freq_ppm[:, -1].max(axis=1) - res.freq_ppm[:, -1].min(
        axis=1)
    held = hold_engine_calls(calls, max_records=50)
    del calls

    sc_s, cfg_s = cable_swap(4_000)
    lanes = {}
    for engine in ("fused", "segment-sum"):
        lanes[engine] = run_scenario(topo, links, ctrl, ppm, sc_s, cfg_s,
                                     options=EngineOptions(engine=engine))
    err = float(np.abs(lanes["fused"].freq_ppm
                       - lanes["segment-sum"].freq_ppm).max())
    bar = max(FREQ_ATOL_PPM, float32_floor_ppm(
        2e-8, 7, float(np.abs(lanes["fused"].psi).max())))
    smoke_shift = int((lanes["segment-sum"].rtt(1)
                       - lanes["segment-sum"].rtt(0))[swap[0]])
    out = dict(phase="scenario", topology=topo.name, draws=b, steps=steps,
               record_every=20, dt=1e-4, kp=2e-8, engine=res.engine,
               launches=launches, engine_calls=res.num_launches,
               wall_s=wall, node_steps_per_s_wall=b * 8 * steps / wall,
               max_memory_allocated=mem, rtt_shift_frames=rtt_shift,
               final_band_ppm_max=float(spread.max()),
               kernel_vs_plain=held["bittide_fused"],
               kernel_vs_plain_records=50,
               smoke_steps=4_000, smoke_freq_err_vs_segment_sum_ppm=err,
               smoke_bar_ppm=bar, smoke_rtt_shift_segment_sum=smoke_shift)
    emit(out)
    assert err <= bar, out

    # The guarded torus of tests/test_reframing.py on the tiled (auto) and
    # the forced fused lane.
    topo = torus3d(8)
    links = make_links(topo, cable_m=2.0)
    p = np.random.default_rng(7).uniform(-0.25, 0.25, topo.num_nodes)
    ppm = (p - p.mean()).astype(np.float32)
    sc = Scenario(events=(
        DriftRamp(t=0.048, t_end=0.24, nodes=tuple(range(64)),
                  rate_ppm_per_s=150.0),
        LatencyStep(t=0.288, edges=edges_between(topo, 0, 1),
                    cable_m=1000.0)), name="torus-drift-swap")
    cfg = SimConfig(dt=1e-3, steps=384, record_every=6)
    tel = Telemetry(beta=True, guard=ReframePolicy(depth=16, margin=5.0))
    runs = {}
    for engine, kernel in (("auto", bittide_tiled), ("fused", bittide_fused)):
        kernel.launches = 0
        with recorded_engine_calls() as calls:
            r = run_scenario(topo, links, ControllerConfig(kp=6e-7), ppm, sc,
                             cfg, options=EngineOptions(engine=engine),
                             telemetry=tel)
        launched = kernel.launches
        assert launched >= 1, f"the guarded torus ({engine}) launched no " \
            f"{kernel.__name__} kernel"
        runs[r.engine] = (r, launched, hold_engine_calls(calls, 10**9))
        del calls
    (til, til_launches, til_held), (fus, fus_launches, fus_held) = \
        runs["tiled"], runs["fused"]
    splices = [(x.record, np.asarray(x.shift).tolist())
               for x in til.reframes]
    guard = dict(phase="scenario_guard", topology=topo.name,
                 splices=len(til.reframes),
                 splice_records=[x.record for x in til.reframes],
                 identical_splices=splices == [
                     (x.record, np.asarray(x.shift).tolist())
                     for x in fus.reframes],
                 guard_latency_one=all(x.guard_latency == 1 for x in
                                       til.reframes + fus.reframes),
                 tiled_launches=til_launches, fused_launches=fus_launches,
                 tiled_kernel_vs_plain=til_held["bittide_tiled"],
                 fused_kernel_vs_plain=fus_held["bittide_fused"],
                 freq_tiled_vs_fused_ppm=float(
                     np.abs(til.freq_ppm - fus.freq_ppm).max()))
    emit(guard)
    assert guard["identical_splices"] and guard["guard_latency_one"], guard
    assert guard["splices"] >= 3, guard
    return dict(fused_launches=launches + fus_launches,
                tiled_launches=til_launches,
                held=[held["bittide_fused"], til_held["bittide_tiled"],
                      fus_held["bittide_fused"]],
                held_kernels=["bittide_fused", "bittide_tiled",
                              "bittide_fused"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import (ControllerConfig, SimConfig, cube,
                                  fully_connected, make_links, simulate,
                                  simulate_ensemble, torus3d)
    from repro_torch.core.frame_model import RUN_COUNT
    from repro_torch.kernels import build
    from repro_torch.telemetry import Telemetry
    dev = torch.device("cuda")
    smi = nvidia_smi_line()

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build(["bittide_fused", "bittide_tiled"])
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".so.log")
        ptxas = ([ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln]
                 if log.exists() else ["library already built; no ptxas log"])
        emit(dict(phase="build", kernel=name, library=lib.name,
                  seconds=seconds, ptxas=ptxas, nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda))
    print(smi, flush=True)

    # 2. kernel vs plain version
    worst = phase_parity(dev)

    # 3. main path: FC8 ensemble at users' size
    fc8, _, _ = run_main_path(
        "fc8", fully_connected(8), 4096, 2e-8, 5e-5, 10_000, 20,
        Telemetry(beta=True, watermarks=True), dev, "fused", subset=256,
        reps=3)
    emit(fc8)

    # 4. dense torus at the fused regime's size
    torus, _, _ = run_main_path(
        "torus", torus3d(6), 256, 2e-8, 1e-3, 2_000, 20,
        Telemetry(watermarks=True), dev, "fused", subset=16, reps=2)
    emit(torus)

    # 5. segment-sum lane
    topo = cube()
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (64, 8))
    ctrl = ControllerConfig(kind="discrete", kp=2e-8, fs=1e-7,
                            pulses_per_update=50)
    cfg = SimConfig(dt=1e-3, steps=2_000, record_every=20,
                    quantize_beta=True)
    torch.cuda.reset_peak_memory_stats()
    RUN_COUNT["segment-sum"] = 0
    t0 = time.perf_counter()
    ens = simulate_ensemble(topo, links, ctrl, ppm, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = RUN_COUNT["segment-sum"]
    one = simulate(topo, links, ControllerConfig(kind="discrete", kp=2e-8,
                                                 fs=1e-7,
                                                 pulses_per_update=50),
                   ppm[3], cfg)
    seg = dict(phase="segsum", topology=topo.name, draws=64, steps=2_000,
               record_every=20, dt=1e-3, controller="discrete",
               quantize_beta=True, runs=runs, wall_s=wall,
               node_steps_per_s_wall=64 * 8 * 2_000 / wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               single_draw_bit_identical=bool(
                   np.array_equal(one.freq_ppm, ens.freq_ppm[3])),
               **summary(ens.freq_ppm, ens.times))
    emit(seg)
    assert runs == 1 and np.isfinite(ens.freq_ppm).all()
    assert seg["single_draw_bit_identical"]
    assert seg["converged_draws"] == 64 and seg["final_band_ppm_max"] <= 1.0

    # 6. the tiled lane at Fig-18 size
    tiled = run_tiled(dev)
    emit(tiled)

    # 7. the scenario runner
    scen = run_scenarios(dev)

    # 8. kernels line, card line, last line.  Launches: the main paths'
    # counts (phases 3, 4, 6 and 7; a wrapper counts its calls that
    # launched — one bittide_tiled call launches a kernel per period and
    # two per measure pass from C).  Errors: the worst over every
    # comparison with the plain version (phase 2, the main paths'
    # launches, phase 7's engine calls).
    errs = {k: dict(w) for k, w in worst.items()}

    def fold(kernel, freq_ppm, beta_frames):
        e = errs[kernel]
        e["freq_ppm"] = max(e["freq_ppm"], freq_ppm)
        e["beta_frames"] = max(e["beta_frames"], beta_frames)
    for kernel, row in (("bittide_fused", fc8), ("bittide_fused", torus),
                        ("bittide_tiled", tiled)):
        fold(kernel, row["kernel_vs_plain_freq_err_ppm"],
             row.get("kernel_vs_plain_beta_err_frames", 0.0))
    for kernel, h in zip(scen["held_kernels"], scen["held"]):
        fold(kernel, h["freq_ppm"], h["beta_frames"])
    no_library = ("no single PyTorch call runs the period loop (a matmul "
                  "covers only one period's aggregation)")
    emit({"kernels": [
        dict(name="bittide_fused", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_fused.cu",
             replaces="src/repro/kernels/bittide_step.py:271 (_fused_kernel)",
             launches=fc8["launches"] + torus["launches"]
             + scen["fused_launches"],
             max_abs_err=errs["bittide_fused"]["freq_ppm"],
             max_err_ppm=errs["bittide_fused"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_fused"]["beta_frames"],
             ms=fc8["kernel_ms"], plain_ms=fc8["plain_ms"],
             bound_ms=fc8["bound_ms"], bound_by=fc8["bound_by"],
             library_ms=None, library_note=no_library),
        dict(name="bittide_tiled", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_tiled.cu",
             replaces="src/repro/kernels/bittide_step.py:744 (_tiled_kernel)",
             launches=tiled["launches"] + scen["tiled_launches"],
             max_abs_err=errs["bittide_tiled"]["freq_ppm"],
             max_err_ppm=errs["bittide_tiled"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_tiled"]["beta_frames"],
             ms=tiled["kernel_ms"], plain_ms=tiled["plain_ms"],
             plain_work=tiled["plain_work"],
             ms_same_work_as_plain=tiled["kernel_ms_same_work"],
             bound_ms=tiled["bound_ms"], bound_by=tiled["bound_by"],
             library_ms=None, library_note=no_library)]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
