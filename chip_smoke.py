#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line:

1. build    — nvcc builds ``csrc/bittide_fused.cu``,
              ``csrc/bittide_tiled.cu``, ``csrc/bittide_sparse.cu`` and
              ``csrc/bittide_step.cu`` in parallel; their ptxas reports
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
              per CTA, A read from L2).  Sparse (``SPARSE_PARITY_CASES``):
              FC8 (K=7) at B=64, random_regular(300, 3, 0) at B=9 (the
              last CTA of each draw partial), the ragged
              bounded_degree_topo(96, 4, 3) with 2 isolated nodes and 2
              leaves, the same with K + 2 padded slots, and per-draw
              tables with a dropped link per draw; every variant and the
              guard tripping at different records and never; 0.0 error.
              Per-step (``PERSTEP_PARITY_CASES``): FC8, FC8 with the
              1000 m spool (two classes) and the ragged torus3d(7) with a
              holdover mask, one draw each; every variant and the guard
              tripping at a mid record and never; 0.0 error, and the
              launches the C loop made.
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

8. sparse   — the sparse lane at full width: ``simulate_ensemble_dense``
              with ``engine="auto"`` (which must choose "sparse") on
              torus3d(100): 1,000,000 nodes, 6,000,000 edges, K=6; B=8
              draws in ±8 ppm, 2 m cables, kp=2e-8, dt=5e-3, 2,000
              periods recorded every 100, watermarks.  The kernel against
              the plain version over every draw at full depth (0.0
              error), one more launch reproducing the records, ν against
              the segment-sum lane within ``float32_floor_ppm``; kernel
              time, the host side piece by piece (the auto probe,
              ``ellify``, the λeff fold, tables to the card, records
              back), node-steps/s, memory, the final ν band; every
              pass's aggregation as two ``torch.sparse`` CSR products,
              timed over all the call's passes, as a yardstick (the port
              never calls it).  Then phase 6's run
              (torus3d(22) × 8 draws) on the sparse lane: both kernels'
              times side by side, every draw converged.
9. chaos    — two ``ChaosCampaign``s on the sparse lane, torus3d(8) ×
              1,024 draws: examples/chaos_campaign.py's full campaign
              (FreqStep / DriftRamp / LatencyStep samplers, 4,800 steps
              recorded every 24, ``auto_reframe=True``, depth 32; verdict
              counts, the shrunk repro must reproduce), and a
              LinkDropSampler + FreqStepSampler campaign (per-draw
              weight tables) within ``LINKDROP_ATOL_PPM`` (2e-5 ppm) of
              the segment-sum lane.  Campaign 1's wall is split by its
              flight recorder into the engine calls, triage and the rest.
              Every engine call is held against the plain version on its
              own inputs at 0.0 error.

10. perstep — the per-step lane (``bittide_perstep``, one draw and one
              launch per period).  (a) ``simulate_ensemble_dense(engine=
              "per-step")`` on phase 6's torus3d(22) (A = 453.5 MB), its
              draws 0 and 1, 2,000 periods recorded every 100,
              watermarks: launches (2 × (2,000 + 2 × 20)), the kernel's
              time per pass beside the bytes bound, memory, one
              ``torch.mv`` per class as the yardstick of one period's
              aggregation, the plain version over 2 records × 2 periods at
              0.0 error, ν and watermarks against phase 6's tiled rows.
              (b) ``BittideNetwork.run_scenario`` on phase 7's cable swap
              (40,000 periods, its first 16 draws): ν and β against phase
              7's fused rows, the same RTT shift; every engine call held
              against the plain version over its first 10 records.  (c)
              Phase 7's guarded torus with three draws whose drift rates
              differ, so that the host resync re-runs draws: splices
              identical to the fused lane's.  (d) examples/quickstart.py's
              flow: ``BittideNetwork.sync`` converges; the RTT table and
              the logical latency 0 → 1.

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
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The bars of tests/engine_harness.py (tests/test_torch_package_rules.py
# checks that they agree).
FREQ_ATOL_PPM = 1e-6
BETA_ATOL_FRAMES = 1e-6
# tests/test_chaos.py's bar for a LinkDrop campaign on the sparse lane
# against segment-sum (re-establishment at kp = 2e-8 sets a float32
# floor); tests/test_torch_package_rules.py checks it too.
LINKDROP_ATOL_PPM = 2e-5

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


# Sparse kernel-vs-plain cases of phase 2 and of the card tests:
# (topology, draws, tables).  FC8 (K = 7); random_regular(300, 3, 0) at
# B = 9 (300 nodes: the last CTA of each draw is partial); the ragged
# bounded_degree_topo(96, 4, 3) with 2 isolated nodes and 2 leaves; the
# same with K + 2 always-padded slots; and per-draw tables in which every
# draw drops its own link (both directions) and has its own latencies.
SPARSE_PARITY_CASES = (("fully_connected_8", 64, "shared"),
                       ("random_regular_300", 9, "shared"),
                       ("bounded_degree_96", 16, "shared"),
                       ("bounded_degree_96", 16, "extra_slots"),
                       ("random_regular_300", 9, "per_draw_dropped"))
SPARSE_RECORDS, SPARSE_EVERY = 6, 5
# Per-step kernel-vs-plain cases of phase 2 and of the card tests: FC8;
# FC8 with the 1000 m spool on the pair (0, 1) (two latency classes); the
# ragged torus3d(7) (343 nodes: the last CTA partial) with nodes 0 and
# N-1 in holdover.  One draw each, with phase 2's per-draw knobs.
PERSTEP_PARITY_CASES = ("fc8", "fc8_spool", "torus3d_7")
PERSTEP_RECORDS, PERSTEP_EVERY = 6, 4


def bounded_degree_topo(n, max_deg, seed=0, isolated=0, leaves=0):
    """tests/engine_harness.py's random bounded-in-degree digraph (copied:
    the harness imports jax): node 0 takes max_deg in-edges, the last
    ``isolated`` nodes none, the ``leaves`` before them one."""
    import numpy as np
    from repro_torch.core import Topology
    rng = np.random.default_rng(seed)
    src, dst = [], []
    first_leaf = n - isolated - leaves
    for i in range(n - isolated):
        if i == 0:
            d = max_deg
        elif i >= first_leaf:
            d = 1
        else:
            d = int(rng.integers(1, max_deg + 1))
        others = np.delete(np.arange(n), i)
        picks = rng.choice(others, size=d, replace=False)
        src.extend(int(p) for p in picks)
        dst.extend([i] * d)
    return Topology(n, np.asarray(src, np.int32), np.asarray(dst, np.int32),
                    name=f"bounded_deg_{n}_{max_deg}_{seed}"
                         f"{'_iso' + str(isolated) if isolated else ''}")


def sparse_parity_inputs(case, dev):
    """(topology, sparse kernel args ending in Δ = 125,000 frames,
    per-draw mask) of one of ``SPARSE_PARITY_CASES``: ν_u in ±8 ppm, kp
    = 2e-8 jittered per draw, β_off in ±1, λeff folds of per-edge values
    in ±1 frame (0 at a node without in-edges), holdover on nodes 0 and 1
    for about half the draws, every edge its own latency in 5..60
    frames."""
    import numpy as np
    import torch
    from repro_torch.core import fully_connected, random_regular
    from repro_torch.kernels.bittide_sparse import ellify, max_in_degree
    name, b, tables = case
    topo = {"fully_connected_8": lambda: fully_connected(8),
            "random_regular_300": lambda: random_regular(300, 3, 0),
            "bounded_degree_96": lambda: bounded_degree_topo(
                96, 4, 3, isolated=2, leaves=2)}[name]()
    n, e = topo.num_nodes, topo.num_edges
    rng = np.random.default_rng(4)
    per_draw = tables == "per_draw_dropped"
    lat_f = rng.uniform(5.0, 60.0, (b, e) if per_draw else e)
    edge_w = None
    if per_draw:
        rev = topo.reverse_edge_index()
        edge_w = np.ones((b, e))
        for d, pick in enumerate(rng.integers(0, e, b)):
            edge_w[d, [pick, rev[pick]]] = 0.0
    max_deg = max_in_degree(topo) + (2 if tables == "extra_slots" else 0)
    nbr, latf, w = ellify(topo, lat_f, edge_w=edge_w, max_deg=max_deg)
    put = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev)
    nu_u = put(rng.uniform(-8, 8, (b, n)) * 1e-6)
    mask = np.ones((b, n), np.float32)
    mask[:, :2] = np.where(rng.random((b, 1)) < 0.5, 0.0, 1.0)
    lamsum = (w * rng.uniform(-1, 1, (b,) + w.shape[1:])).sum(axis=1)
    args = (torch.zeros_like(nu_u), nu_u.clone(), nu_u,
            torch.as_tensor(nbr, device=dev), put(latf), put(w),
            put(lamsum),
            put(2e-8 * rng.uniform(0.5, 1.5, b)), put(rng.uniform(-1, 1, b)),
            125000.0)
    return topo, args, put(mask)


def sparse_variants(args, kw, b):
    """The four variants, then the guard with bands that trip draw i near
    record 1 + i % 3 and with bands that never trip."""
    import torch
    from repro_torch.kernels.bittide_sparse import bittide_sparse_torch
    base = bittide_sparse_torch(*args, **dict(kw, record_beta=True))
    deg = args[5].sum(dim=1).clamp(min=1.0)
    peak = (base.beta.abs() / deg).amax(dim=2)                 # (R, B)
    out = [dict(record_beta=beta, record_watermarks=wm)
           for beta, wm in ((False, False), (True, False), (False, True),
                            (True, True))]
    for trips in (True, False):
        band = torch.stack([peak[1 + i % 3, i] * 0.999 if trips
                            else 10 * peak.max() for i in range(b)])
        out.append(dict(record_beta=True, record_watermarks=True,
                        record_guard=True, guard_lo=(-band).contiguous(),
                        guard_hi=band.contiguous(),
                        guard_stop=kw["num_records"] - 1))
    return out


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


def kernel_vs_plain(got, want, records=None, exact=False) -> dict:
    """The kernel's errors against the plain version's outputs over the
    first ``records`` records (all by default; a guard freeze leaves the
    later ones unrun); raises when one leaves its bar (ν at
    FREQ_ATOL_PPM, β and max |β| at BETA_ATOL_FRAMES, watermark and trip
    indices exactly; with ``exact`` every error must be 0.0)."""
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
    if exact:
        assert all(v == 0.0 for k, v in err.items() if k.endswith(
            ("_ppm", "_frames"))), err
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
             for k in ("bittide_fused", "bittide_tiled", "bittide_sparse",
                       "bittide_step")}

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
    sparse_parity(dev, note)
    perstep_parity(dev, note)
    return worst


def sparse_parity(dev, note):
    """Phase 2's sparse cases: every variant of every case of
    ``SPARSE_PARITY_CASES`` against the plain version at 0.0 error, each
    row passed to ``note``."""
    import torch
    from repro_torch.kernels.bittide_sparse import (bittide_sparse,
                                                    bittide_sparse_torch)
    from repro_torch.kernels.bittide_step import sparse_tile
    for case in SPARSE_PARITY_CASES:
        topo, args, mask = sparse_parity_inputs(case, dev)
        b, n = args[0].shape
        kw = dict(num_records=SPARSE_RECORDS, record_every=SPARSE_EVERY,
                  ctrl_mask=mask)
        trip_rows = []
        for v in sparse_variants(args, kw, b):
            before = bittide_sparse.launches
            got = bittide_sparse(*args, **kw, **v)
            torch.cuda.synchronize()
            assert bittide_sparse.launches == before + 1
            want = bittide_sparse_torch(*args, **kw, **v)
            valid = SPARSE_RECORDS
            row = dict(phase="parity", kernel="bittide_sparse",
                       topology=topo.name, draws=b, tables=case[2],
                       k=int(args[3].shape[0]),
                       table_rows=int(args[4].shape[0]),
                       beta=v["record_beta"],
                       watermarks=v["record_watermarks"],
                       guard=v.get("record_guard", False),
                       nodes_per_cta=sparse_tile(n))
            if row["guard"]:
                row["earliest_trip"] = int(want.guard_state.min())
                valid = min(row["earliest_trip"], SPARSE_RECORDS - 1) + 1
                trip_rows.append(row["earliest_trip"])
                row["frozen_records_nan"] = bool(
                    torch.isnan(got.freq[valid:]).all())
                assert row["frozen_records_nan"], row
            row.update(kernel_vs_plain(got, want, records=valid, exact=True))
            note("bittide_sparse", row)
        assert trip_rows[0] < SPARSE_RECORDS - 1 and \
            trip_rows[1] == SPARSE_RECORDS, trip_rows


def perstep_inputs(case, dev):
    """(topology, per-step kernel args ending in Δ = 125,000 frames,
    (N,) mask) of one of ``PERSTEP_PARITY_CASES``: draw 0 of
    ``parity_inputs``'s per-draw knobs (kp, class latencies, λeff fold,
    setpoint), ψ started in ±5 frames."""
    import numpy as np
    import torch
    name, classes = {"fc8": ("fully_connected_8", 1),
                     "fc8_spool": ("fully_connected_8", 2),
                     "torus3d_7": ("torus3d_7", 1)}[case]
    topo, args, _ = parity_inputs((name, 1, classes), dev)
    n = topo.num_nodes
    psi = torch.as_tensor(np.random.default_rng(3).uniform(-5, 5, n),
                          dtype=torch.float32, device=dev)
    mask = torch.ones(n, device=dev)
    if case == "torus3d_7":
        mask[[0, n - 1]] = 0.0
    row = lambda x: x[0].contiguous()
    return topo, (psi, row(args[1]), row(args[2]), args[3], args[4],
                  row(args[5]), row(args[6]), float(args[7][0]),
                  float(args[8][0]), args[9]), mask


def perstep_variants(args, kw):
    """The four variants, then the guard with a band that trips near
    record 2 and with one that never trips."""
    from repro_torch.kernels.bittide_step import bittide_perstep_torch
    base = bittide_perstep_torch(*args, **dict(kw, record_beta=True))
    peak = (base.beta.abs() / args[4].clamp(min=1.0)).amax(dim=1)  # (R,)
    out = [dict(record_beta=beta, record_watermarks=wm)
           for beta, wm in ((False, False), (True, False), (False, True),
                            (True, True))]
    for band in (float(peak[2]) * 0.999, 10 * float(peak.max())):
        out.append(dict(record_beta=True, record_watermarks=True,
                        record_guard=True, guard_lo=-band, guard_hi=band,
                        guard_stop=kw["num_records"] - 1))
    return out


def perstep_parity(dev, note):
    """Phase 2's per-step cases: every variant of every case of
    ``PERSTEP_PARITY_CASES`` against the plain version at 0.0 error, each
    row passed to ``note``; the guard trips at a mid record and never."""
    import torch
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    for case in PERSTEP_PARITY_CASES:
        topo, args, mask = perstep_inputs(case, dev)
        kw = dict(num_records=PERSTEP_RECORDS, record_every=PERSTEP_EVERY,
                  ctrl_mask=mask)
        trips = []
        for v in perstep_variants(args, kw):
            before = bittide_perstep.launches
            got = bittide_perstep(*args, **kw, **v)
            torch.cuda.synchronize()
            launched = bittide_perstep.launches - before
            measure = v["record_beta"] or v["record_watermarks"]
            assert launched == PERSTEP_RECORDS * (
                PERSTEP_EVERY + 2 * measure), launched
            want = bittide_perstep_torch(*args, **kw, **v)
            row = dict(phase="parity", kernel="bittide_step", case=case,
                       topology=topo.name, classes=int(args[3].shape[0]),
                       beta=v["record_beta"],
                       watermarks=v["record_watermarks"],
                       guard=v.get("record_guard", False),
                       launches=launched)
            if row["guard"]:
                row["trip"] = int(want.guard_state)
                trips.append(row["trip"])
            row.update(kernel_vs_plain(got, want, exact=True))
            note("bittide_step", row)
        assert trips[0] < PERSTEP_RECORDS - 1 and \
            trips[1] == PERSTEP_RECORDS, trips


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
    return out, args, kw, res


def run_tiled(dev, k=22, b=8, steps=2_000, rec=100):
    """Phase 6: the tiled lane at Fig-18 size (see the module docstring)."""
    import torch
    from repro_torch.core import torus3d
    from repro_torch.kernels.bittide_step import bittide_tiled
    from repro_torch.telemetry import Telemetry
    out, args, kw, res = run_main_path(
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
    return out, res


@contextlib.contextmanager
def recorded_engine_calls(module=None, name="_fused_engine"):
    """Record every call of the engine entry ``name`` in ``module`` (the
    scenario runner's dense engine by default; ``_sparse_engine`` for the
    sparse lane, and ``repro_torch.kernels.ops`` for the runners of
    ``simulate_ensemble_dense``), as (its arguments by name, its
    outputs)."""
    import inspect
    if module is None:
        from repro_torch.scenarios import runner as module
    inner = getattr(module, name)
    sig = inspect.signature(inner)
    calls = []

    def record(*args, **kw):
        out = inner(*args, **kw)
        bound_args = sig.bind(*args, **kw)
        bound_args.apply_defaults()
        calls.append((dict(bound_args.arguments), out))
        return out
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def sparse_call_args(a):
    """(args, kw) of ``bittide_sparse`` for one recorded ``_sparse_engine``
    call."""
    args = (a["psi"], a["nu"], a["nu_u"], a["nbr"], a["latf"], a["w"],
            a["lamsum"], a["kp"], a["beta_off"], a["dt_frames"])
    kw = dict(num_records=a["num_records"], record_every=a["record_every"],
              ctrl_mask=a["ctrl_mask"], record_beta=a["record_beta"],
              record_watermarks=a["record_watermarks"],
              record_guard=a["record_guard"], guard_lo=a["guard_lo"],
              guard_hi=a["guard_hi"], guard_stop=a["guard_stop"])
    return args, kw


def hold_sparse_calls(calls) -> dict:
    """Hold each recorded sparse-engine call against the plain version on
    the call's own inputs, at its full depth and at 0.0 error (records up
    to the guard's freeze, trip records equal); returns the worst errors
    and the number of calls held."""
    from repro_torch.kernels.bittide_sparse import bittide_sparse_torch
    worst = dict(calls=0, freq_ppm=0.0, beta_frames=0.0, psi_frames=0.0)
    for a, out in calls:
        args, kw = sparse_call_args(a)
        want = bittide_sparse_torch(*args, **kw)
        valid = kw["num_records"]
        if kw["record_guard"]:
            valid = min(int(want.guard_state.min()), kw["guard_stop"]) + 1
        err = kernel_vs_plain(out, want, records=valid, exact=True)
        worst["calls"] += 1
        worst["freq_ppm"] = max(worst["freq_ppm"], err["freq_err_ppm"])
        worst["beta_frames"] = max(worst["beta_frames"],
                                   err.get("beta_err_frames", 0.0))
        worst["psi_frames"] = max(worst["psi_frames"], err["psi_err_frames"])
    return worst


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
                tiled_launches=til_launches, swap_freq=res.freq_ppm[:16],
                swap_beta=res.beta[:16], rtt_shift=rtt_shift,
                held=[held["bittide_fused"], til_held["bittide_tiled"],
                      fus_held["bittide_fused"]],
                held_kernels=["bittide_fused", "bittide_tiled",
                              "bittide_fused"])


def sparse_bound(b, n, k, e, steps, records, table_rows, wm):
    """(bound_ms, bound_by) for one call of the sparse kernel.

    Bytes: every input read once (the tables, (4 + 8·R)·K·N; ψ, ν, ν_u,
    lamsum; mask, gains), every output written once (ψ, ν, the ν records,
    the watermarks).  Operations: what the function needs on this run's
    data — the degrees once (K·N·R adds: the tables are fixed for the
    call), per period 4 per real edge (ν·lat, ψ − ·, w·, acc +) and 10
    per node, and per record's measure pass the row mean (N + chunks + 1
    per draw), 4 per edge and 8 per node (the node's centring ψ − mean
    among them: the gathers read centred ψ, not one subtraction each).
    """
    nodes = b * n
    in_bytes = (4 + 8 * table_rows) * k * n + 4 * (4 * nodes + n + 2 * b)
    out_bytes = 4 * (2 * nodes + records * nodes + 4 * wm * nodes)
    ops = k * n * table_rows + b * steps * (4 * e + 10 * n)
    if wm:
        ops += b * records * (n + -(-n // 1024) + 1 + 4 * e + 8 * n)
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_sparse(dev, k=100, b=8, steps=2_000, rec=100):
    """Phase 8: the sparse lane at full width (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  simulate_ensemble, torus3d)
    from repro_torch.core.frame_model import OMEGA_NOM
    from repro_torch.kernels import ops, simulate_ensemble_dense
    from repro_torch.kernels.bittide_sparse import (bittide_sparse,
                                                    bittide_sparse_torch,
                                                    ellify)
    from repro_torch.telemetry import Telemetry
    kp, dt = 2e-8, 5e-3
    t0 = time.perf_counter()
    topo = torus3d(k)
    topology_build_s = time.perf_counter() - t0
    n, e = topo.num_nodes, topo.num_edges
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, n))
    tel = Telemetry(watermarks=True)
    records = steps // rec
    call = lambda: simulate_ensemble_dense(topo, links, ppm, steps, kp,
                                           dt=dt, record_every=rec,
                                           telemetry=tel)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_sparse.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(ops, "_sparse_engine") as calls:
        res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_sparse.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, "sparse: the main path launched no sparse kernel"
    assert res.engine == "sparse", res.engine
    freq, psi = res
    assert freq.shape == (b, records, n), freq.shape
    assert np.isfinite(freq).all() and np.isfinite(psi).all()
    assert np.isfinite(res.watermarks.beta_abs_max).all()
    (a, out), = calls
    del calls
    args, kw = sparse_call_args(a)

    # One more launch on the main path's inputs reproduces its records.
    again = bittide_sparse(*args, **kw)
    host = lambda x: x.transpose(0, 1).cpu().numpy()
    assert np.array_equal(host(again.freq * 1e6), freq), \
        "sparse: the compared launch differs from the main path's"
    del again
    kernel_ms = cuda_ms(lambda: bittide_sparse(*args, **kw), 1)

    # The plain version over every draw at full depth.
    want, plain_s = timed(lambda: bittide_sparse_torch(*args, **kw))
    err = kernel_vs_plain(out, want, exact=True)
    del want

    # The segment-sum lane on the card over every draw.
    ss = simulate_ensemble(topo, links, ControllerConfig(kp=kp), ppm,
                           SimConfig(dt=dt, steps=steps, record_every=rec,
                                     record_beta=False))
    err_ss = float(np.abs(freq - ss.freq_ppm).max())
    bar = max(FREQ_ATOL_PPM, float32_floor_ppm(kp, 6,
                                               float(np.abs(psi).max())))
    del ss

    # The host side of the call, piece by piece (medians of 3), beside
    # the call's wall (median of 3 more calls).
    median = lambda fn: float(np.median([timed(fn)[1] for _ in range(3)]))
    from repro_torch.kernels.ops import _lamsum_host, latency_classes
    lat_f = np.asarray(links.latency_s, np.float64) * OMEGA_NOM
    tables = ellify(topo, lat_f)

    def back():
        host(out.freq * 1e6)
        out.psi.cpu(), out.nu.cpu()
        [x.cpu() for x in out.watermarks]
    split = dict(
        auto_probe_s=median(lambda: ops._auto_is_sparse(
            topo, b, lambda: len(latency_classes(lat_f, warn=False)[0]))),
        ellify_s=median(lambda: ellify(topo, lat_f)),
        lamsum_fold_s=median(lambda: _lamsum_host(
            topo, np.asarray(links.beta0)[None], None, 1)),
        tables_to_card_s=median(lambda: [torch.as_tensor(x, device=dev)
                                         for x in tables]),
        records_to_host_s=median(back))
    split["wall_s_median3"] = float(np.median([timed(call)[1]
                                               for _ in range(3)]))
    split["rest_of_call_s"] = split["wall_s_median3"] - kernel_ms * 1e-3 \
        - sum(v for key, v in split.items() if key.endswith("_s")
              and key not in ("wall_s_median3",))

    # Yardstick (not used by the port): each pass's aggregation as two
    # torch.sparse CSR products, w·ψ and (w·lat)·ν, on (N, B) operands.
    idx = torch.as_tensor(np.stack([topo.dst, topo.src]).astype(np.int64),
                          device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        w_csr = torch.sparse_coo_tensor(
            idx, torch.ones(e, device=dev), (n, n)).coalesce().to_sparse_csr()
        wl_csr = torch.sparse_coo_tensor(
            idx, torch.as_tensor(lat_f.astype(np.float32), device=dev),
            (n, n)).coalesce().to_sparse_csr()
    # Timed over all of phase 8's passes in one run of CUDA events, each
    # pass's products dropped before the next.
    xp = args[0].t().contiguous()
    xn = args[2].t().contiguous()
    passes = steps + records

    def spmm_passes(count):
        for _ in range(count):
            torch.sparse.mm(w_csr, xp), torch.sparse.mm(wl_csr, xn)
    spmm_passes(1)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    spmm_passes(passes)
    stop.record()
    torch.cuda.synchronize()
    library_ms = start.elapsed_time(stop)
    del w_csr, wl_csr, xp, xn

    bound_ms, bound_by = sparse_bound(b, n, int(args[3].shape[0]), e, steps,
                                      records, int(args[4].shape[0]), True)
    band = freq[:, -1].max(axis=1) - freq[:, -1].min(axis=1)
    out_row = dict(
        phase="sparse", topology=topo.name, nodes=n, edges=e, draws=b,
        k=int(args[3].shape[0]), steps=steps, record_every=rec, dt=dt, kp=kp,
        engine=res.engine, nodes_per_cta=res.tile_j, launches=launches,
        passes=passes, kernel_launches_per_call=steps + 3 * records,
        topology_build_s=topology_build_s, wall_s=wall, kernel_ms=kernel_ms,
        kernel_ms_per_pass=kernel_ms / passes,
        node_steps_per_s_kernel=b * n * steps / (kernel_ms * 1e-3),
        node_steps_per_s_wall=b * n * steps / wall,
        max_memory_allocated=mem, **split,
        plain_ms=plain_s * 1e3, plain_work="the main path's (full depth)",
        kernel_vs_plain_draws=b,
        **{f"kernel_vs_plain_{key}": v for key, v in err.items()},
        segment_sum_draws=b, freq_err_vs_segment_sum_ppm=err_ss,
        segment_sum_bar_ppm=bar, bound_ms=bound_ms, bound_by=bound_by,
        period_stream_bound_ms_per_pass=(
            (12 * int(args[3].shape[0]) * n + 24 * b * n)
            / PEAK_BYTES_PER_S * 1e3),
        library_ms=library_ms, library_ms_per_pass=library_ms / passes,
        final_band_ppm_max=float(band.max()),
        final_band_ppm_p50=float(np.median(band)))
    assert err_ss <= bar, out_row
    return out_row


def run_sparse_fig18(dev, tiled, k=22, b=8, steps=2_000, rec=100):
    """Phase 8b: phase 6's run (torus3d(22), same draws and settings) on
    the sparse lane instead of the tiled one; both kernels timed with CUDA
    events in this run on the main path's own inputs."""
    import numpy as np
    from repro_torch.core import make_links, torus3d
    from repro_torch.kernels import EngineOptions, ops, simulate_ensemble_dense
    from repro_torch.kernels.bittide_sparse import bittide_sparse
    from repro_torch.telemetry import Telemetry
    topo = torus3d(k)
    n = topo.num_nodes
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, n))
    with recorded_engine_calls(ops, "_sparse_engine") as calls:
        res = simulate_ensemble_dense(
            topo, make_links(topo, cable_m=2.0), ppm, steps, 2e-8, dt=5e-3,
            record_every=rec, options=EngineOptions(engine="sparse"),
            telemetry=Telemetry(watermarks=True))
    (a, _), = calls
    args, kw = sparse_call_args(a)
    sparse_ms = cuda_ms(lambda: bittide_sparse(*args, **kw), 3)
    times = (np.arange(1, steps // rec + 1) * rec) * 5e-3
    row = dict(phase="sparse_fig18", topology=topo.name, nodes=n, draws=b,
               steps=steps, record_every=rec, engine=res.engine,
               sparse_kernel_ms=sparse_ms, tiled_kernel_ms=tiled["kernel_ms"],
               tiled_over_sparse=tiled["kernel_ms"] / sparse_ms,
               **summary(res[0], times))
    assert row["converged_draws"] == b, row
    return row


def run_chaos(dev, draws=1024):
    """Phase 9: two chaos campaigns on the sparse lane (see the module
    docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  torus3d)
    from repro_torch.kernels import EngineOptions
    from repro_torch.kernels.bittide_sparse import bittide_sparse
    from repro_torch.scenarios import (ChaosCampaign, DriftRampSampler,
                                       FreqStepSampler, LatencyStepSampler,
                                       LinkDropSampler, edges_between,
                                       run_scenario, runner, triage_result)
    from repro_torch.telemetry import Telemetry
    topo = torus3d(8)
    links = make_links(topo, cable_m=2.0)
    ctrl = ControllerConfig(kp=2e-8)
    out = {}

    # 1. examples/chaos_campaign.py's full campaign on the sparse lane.
    steps = 4800
    cfg = SimConfig(dt=1e-3, steps=steps, record_every=24)
    t_hold = steps * cfg.dt
    camp = ChaosCampaign(
        topo=topo, ctrl=ctrl,
        samplers=(
            FreqStepSampler(t=0.15 * t_hold, ppm_range=(0.05, 6.0)),
            DriftRampSampler(t=0.35 * t_hold, t_end=0.6 * t_hold,
                             rate_range=(0.05, 2.0)),
            LatencyStepSampler(t=0.5 * t_hold,
                               edges=edges_between(topo, 0, 1),
                               cable_range=(5.0, 200.0))),
        num_draws=draws, seed=0, ppm_range=0.05, links=links, cfg=cfg,
        engine="sparse", auto_reframe=True, depth=32, name="torus512")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_sparse.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(runner, "_sparse_engine") as calls:
        result = camp.run(telemetry=Telemetry(trace=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_sparse.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1 and result.result.engine == "sparse"
    assert np.isfinite(result.result.freq_ppm).all()
    # Where the wall goes: the engine calls (the trace's chunk spans: the
    # launches, the guard's trip read and the record copies), triage (run
    # again, timed), and the rest (segment prep, rotations, the build).
    chunk_s = sum(ev.dur for ev in result.result.trace.by_kind("chunk"))
    _, triage_s = timed(lambda: triage_result(result.result, depth=32))
    held = hold_sparse_calls(calls)
    del calls
    shrunk = result.shrink()
    t0 = time.perf_counter()
    reproduces = shrunk.reproduces
    shrink_s = time.perf_counter() - t0
    row = dict(phase="chaos", campaign=camp.name, topology=topo.name,
               draws=draws, steps=steps, record_every=24, engine="sparse",
               launches=launches, engine_calls=result.result.num_launches,
               splices=len(result.result.reframes), wall_s=wall,
               engine_calls_s=chunk_s, triage_s=triage_s,
               rest_of_wall_s=wall - chunk_s - triage_s,
               node_steps_per_s_wall=draws * topo.num_nodes * steps / wall,
               max_memory_allocated=mem, verdicts=result.counts(),
               survival_rate=result.survival_rate(),
               worst_draw=shrunk.draw_index,
               worst_verdict=shrunk.expected_verdict,
               shrink_reproduces=reproduces, shrink_replay_s=shrink_s,
               kernel_vs_plain=held)
    emit(row)
    assert reproduces, row
    assert sum(row["verdicts"].values()) == draws, row
    out["launches"] = launches
    out["held"] = [held]

    # 2. Per-draw LinkDrop victims (per-draw slot weights) + FreqStep,
    # against the segment-sum lane on the card.
    cfg2 = SimConfig(dt=1e-3, steps=240, record_every=12)
    camp2 = ChaosCampaign(
        topo=topo, ctrl=ctrl,
        samplers=(FreqStepSampler(t=0.06, ppm_range=(1.0, 4.0)),
                  LinkDropSampler(t=0.1, t_restore=0.16)),
        num_draws=draws, seed=5, ppm_range=8.0, links=links, cfg=cfg2,
        engine="sparse", name="torus512-linkdrop")
    bittide_sparse.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(runner, "_sparse_engine") as calls:
        result2 = camp2.run()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2 = bittide_sparse.launches
    assert launches2 >= 1 and result2.result.engine == "sparse"
    assert any(a["w"].shape[0] == draws for a, _ in calls), \
        "the LinkDrop campaign ran no per-draw weight table"
    held2 = hold_sparse_calls(calls)
    del calls
    seg = run_scenario(topo, links, ctrl, result2.ppm_u, result2.scenario,
                       cfg2, options=EngineOptions(engine="segment-sum"),
                       telemetry=Telemetry(beta=True))
    err = float(np.abs(result2.result.freq_ppm - seg.freq_ppm).max())
    row2 = dict(phase="chaos", campaign=camp2.name, topology=topo.name,
                draws=draws, steps=240, record_every=12, engine="sparse",
                launches=launches2, engine_calls=result2.result.num_launches,
                wall_s=wall2, verdicts=result2.counts(),
                freq_err_vs_segment_sum_ppm=err,
                segment_sum_bar_ppm=LINKDROP_ATOL_PPM, kernel_vs_plain=held2)
    emit(row2)
    assert err <= LINKDROP_ATOL_PPM, row2
    out["launches"] += launches2
    out["held"].append(held2)
    return out


def perstep_call_args(a):
    """(args, kw) of ``bittide_perstep`` for one recorded
    ``_perstep_engine`` call."""
    args = (a["psi"], a["nu"], a["nu_u"], a["a_t"], a["deg"], a["lamsum"],
            a["lat"], a["kp"], a["beta_off"], a["dt_frames"])
    kw = dict(num_records=a["num_records"], record_every=a["record_every"],
              ctrl_mask=a["ctrl_mask"], record_beta=a["record_beta"],
              record_watermarks=a["record_watermarks"],
              record_guard=a["record_guard"], guard_lo=a["guard_lo"],
              guard_hi=a["guard_hi"], guard_stop=a["guard_stop"])
    return args, kw


def hold_perstep_calls(calls, max_records: int) -> dict:
    """Hold each recorded per-step engine call against the plain version
    on the call's own inputs at 0.0 error: the call's own outputs when it
    ran at most ``max_records`` records, else the kernel launched again
    on its inputs for its first ``max_records`` records (the stop cap
    clipped to them).  Returns the worst errors and the calls held."""
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    worst = dict(calls=0, freq_ppm=0.0, beta_frames=0.0, psi_frames=0.0)
    for a, out in calls:
        args, kw = perstep_call_args(a)
        if kw["num_records"] > max_records:
            kw["num_records"] = max_records
            if kw["record_guard"]:
                kw["guard_stop"] = min(kw["guard_stop"], max_records - 1)
            out = bittide_perstep(*args, **kw)
        want = bittide_perstep_torch(*args, **kw)
        err = kernel_vs_plain(out, want, exact=True)
        worst["calls"] += 1
        worst["freq_ppm"] = max(worst["freq_ppm"], err["freq_err_ppm"])
        worst["beta_frames"] = max(worst["beta_frames"],
                                   err.get("beta_err_frames", 0.0))
        worst["psi_frames"] = max(worst["psi_frames"], err["psi_err_frames"])
    return worst


def run_perstep(dev, tiled_res, scen, k=22, steps=2_000, rec=100,
                swap_steps=40_000, swap_draws=16):
    """Phase 10: the per-step lane (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import (BittideNetwork, ControllerConfig,
                                  OscillatorSpec, ReframePolicy, SimConfig,
                                  fully_connected, make_links, torus3d)
    from repro_torch.core.latency import rtt_table
    from repro_torch.kernels import (EngineOptions, ops,
                                     simulate_ensemble_dense)
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    from repro_torch.scenarios import (DriftRamp, LatencyStep, Scenario,
                                       edges_between, runner)
    from repro_torch.telemetry import Telemetry
    out = {}

    # (a) Full width at Fig-18 scale: draws 0 and 1 of phase 6.
    topo = torus3d(k)
    n = topo.num_nodes
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (8, n))[:2]
    records = steps // rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_perstep.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(ops, "_perstep_engine") as calls:
        res = simulate_ensemble_dense(
            topo, links, ppm, steps, 2e-8, dt=5e-3, record_every=rec,
            options=EngineOptions(engine="per-step"),
            telemetry=Telemetry(watermarks=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = bittide_perstep.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches_a == 2 * (steps + 2 * records), launches_a
    assert res.engine == "per-step" and res[0].shape == (2, records, n)
    assert np.isfinite(res[0]).all()
    tiled_freq, tiled_wm = tiled_res[0][:2], tiled_res.watermarks
    err_tiled = float(np.abs(res[0] - tiled_freq).max())
    wm_same = all(np.array_equal(getattr(res.watermarks, f),
                                 getattr(tiled_wm, f)[:2])
                  for f in ("beta_abs_max", "peak_record", "nu_min_ppm",
                            "nu_max_ppm"))
    assert err_tiled <= FREQ_ATOL_PPM, err_tiled
    assert np.array_equal(res.watermarks.peak_record,
                          tiled_wm.peak_record[:2])
    assert float(np.abs(res.watermarks.nu_max_ppm
                        - tiled_wm.nu_max_ppm[:2]).max()) <= FREQ_ATOL_PPM
    (a, _), _ = calls
    args, kw = perstep_call_args(a)
    passes = steps + records
    call_ms = cuda_ms(lambda: bittide_perstep(*args, **kw), 1)
    # The plain version over 2 records x 2 periods with the measure pass,
    # against the kernel on the same work.
    pkw = dict(kw, num_records=2, record_every=2)
    got = bittide_perstep(*args, **pkw)
    want, plain_s = timed(lambda: bittide_perstep_torch(*args, **pkw))
    err = kernel_vs_plain(got, want, exact=True)
    same_ms = cuda_ms(lambda: bittide_perstep(*args, **pkw), 3)
    # Yardstick (not used by the port): the aggregation of one period as
    # one torch.mv per latency class.
    x = torch.randn(n, device=dev)
    a_t = args[3]
    mv_ms = cuda_ms(lambda: [torch.mv(a_t[c].t(), x)
                             for c in range(a_t.shape[0])], 5)
    nnz = float((a_t != 0).sum())
    bound_ms, bound_by = bound(1, n, a_t.shape[0], nnz, 1, 0, False, False)
    out["a"] = dict(
        phase="perstep", topology=topo.name, nodes=n, draws=2, steps=steps,
        record_every=rec, dt=5e-3, kp=2e-8, engine=res.engine,
        stack_bytes=4 * a_t.shape[0] * n * n, launches=launches_a,
        wall_s=wall, max_memory_allocated=mem, kernel_ms_per_draw=call_ms,
        kernel_passes_per_draw=passes,
        kernel_ms_per_pass=call_ms / passes,
        kernel_ms_per_period_with_measure=call_ms / steps,
        bound_ms_per_pass=bound_ms, bound_by=bound_by,
        library_ms_per_pass=mv_ms,
        library_note="one torch.mv per latency class: the aggregation of "
                     "one period only, not the update; not used by the port",
        plain_ms=plain_s * 1e3, plain_ms_per_pass=plain_s * 1e3 / 6,
        plain_work="2 records x 2 periods + measure passes",
        kernel_ms_same_work=same_ms,
        **{f"kernel_vs_plain_{key}": v for key, v in err.items()},
        freq_err_vs_tiled_ppm=err_tiled,
        bit_identical_to_tiled=bool(np.array_equal(res[0], tiled_freq)),
        watermarks_identical_to_tiled=wm_same,
        **summary(res[0], (np.arange(1, records + 1) * rec) * 5e-3))
    emit(out["a"])
    del calls, args, kw, a_t, got, want

    # (b) The cable swap through the facade, 40,000 periods, the first 16
    # of phase 7's draws.
    fc8 = fully_connected(8)
    ppm = np.random.default_rng(0).uniform(-8, 8, (256, 8)).astype(
        np.float32)[:swap_draws]
    net = BittideNetwork(topo=fc8, links=make_links(fc8, cable_m=2.0),
                         ppm_u=ppm)
    swap = edges_between(fc8, 0, 2)
    sc = Scenario(events=(LatencyStep(t=swap_steps * 1e-4 / 2, edges=swap,
                                      cable_m=1000.0, reestablish=True),),
                  name="fiber-spool-swap")
    bittide_perstep.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(runner, "_perstep_engine") as calls:
        sw = net.run_scenario(sc, ControllerConfig(kp=2e-8),
                              SimConfig(dt=1e-4, steps=swap_steps,
                                        record_every=20),
                              options=EngineOptions(engine="per-step"),
                              telemetry=Telemetry(beta=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_b = bittide_perstep.launches
    assert launches_b >= 1 and sw.engine == "per-step"
    shift = int((sw.rtt(1) - sw.rtt(0))[swap[0]])
    freq_err = float(np.abs(sw.freq_ppm - scen["swap_freq"]).max())
    beta_err = float(np.abs(sw.beta - scen["swap_beta"]).max())
    held = hold_perstep_calls(calls, max_records=10)
    del calls
    out["b"] = dict(
        phase="perstep_swap", entry="BittideNetwork.run_scenario",
        topology=fc8.name, draws=swap_draws, steps=swap_steps,
        record_every=20,
        launches=launches_b, engine_calls=sw.num_launches, wall_s=wall,
        rtt_shift_frames=shift, rtt_shift_fused=scen["rtt_shift"],
        freq_err_vs_fused_ppm=freq_err, beta_err_vs_fused_frames=beta_err,
        bit_identical_to_fused=bool(
            np.array_equal(sw.freq_ppm, scen["swap_freq"])
            and np.array_equal(sw.beta, scen["swap_beta"])),
        kernel_vs_plain=held, kernel_vs_plain_records=10)
    emit(out["b"])
    assert shift == scen["rtt_shift"], out["b"]
    assert freq_err <= FREQ_ATOL_PPM and beta_err <= BETA_ATOL_FRAMES, \
        out["b"]

    # (c) Phase 7's guarded torus on per-step with three draws whose
    # drift rates differ, so that their trips differ and the host resync
    # re-runs draws; against the forced fused lane on the same batch.
    topo = torus3d(8)
    links = make_links(topo, cable_m=2.0)
    p = np.random.default_rng(7).uniform(-0.25, 0.25, topo.num_nodes)
    ppm = np.tile((p - p.mean()).astype(np.float32), (3, 1))
    sc = Scenario(events=(
        DriftRamp(t=0.048, t_end=0.24, nodes=tuple(range(64)),
                  rate_ppm_per_s=np.array([150.0, 120.0, 180.0])),
        LatencyStep(t=0.288, edges=edges_between(topo, 0, 1),
                    cable_m=1000.0)), name="torus-drift-swap")
    cfg = SimConfig(dt=1e-3, steps=384, record_every=6)
    tel = Telemetry(beta=True, guard=ReframePolicy(depth=16, margin=5.0))
    bittide_perstep.launches = 0
    with recorded_engine_calls(runner, "_perstep_engine") as calls:
        ps = BittideNetwork(topo, links, ppm).run_scenario(
            sc, ControllerConfig(kp=6e-7), cfg,
            options=EngineOptions(engine="per-step"), telemetry=tel)
    launches_c = bittide_perstep.launches
    resync = len(calls) - 3 * ps.num_launches
    # Held: the first chunk's three draws and every resync re-run (a
    # draw's second call from the same state), over their first 2 records.
    seen, picked = set(), []
    for i, (a, o) in enumerate(calls):
        ptr = a["psi"].data_ptr()
        if i < 3 or ptr in seen:
            picked.append((a, o))
        seen.add(ptr)
    held_c = hold_perstep_calls(picked, 2)
    held_c["resync_calls"] = len(picked) - 3
    del calls, picked
    fu = BittideNetwork(topo, links, ppm).run_scenario(
        sc, ControllerConfig(kp=6e-7), cfg,
        options=EngineOptions(engine="fused"), telemetry=tel)
    splices = lambda r: [(x.record, np.asarray(x.shift).tolist())
                         for x in r.reframes]
    out["c"] = dict(
        phase="perstep_guard", topology=topo.name, draws=3,
        launches=launches_c, splices=len(ps.reframes),
        resync_draw_runs=resync,
        identical_splices_to_fused=splices(ps) == splices(fu),
        guard_latency_one=all(x.guard_latency == 1 for x in ps.reframes),
        freq_err_vs_fused_ppm=float(np.abs(ps.freq_ppm
                                           - fu.freq_ppm).max()),
        bit_identical_to_fused=bool(np.array_equal(ps.freq_ppm,
                                                   fu.freq_ppm)),
        kernel_vs_plain=held_c)
    emit(out["c"])
    assert out["c"]["identical_splices_to_fused"], out["c"]
    assert out["c"]["guard_latency_one"] and out["c"]["splices"] >= 3
    assert resync >= 1, out["c"]
    assert out["c"]["freq_err_vs_fused_ppm"] <= FREQ_ATOL_PPM, out["c"]

    # (d) The quickstart: examples/quickstart.py's flow on the card.
    net = BittideNetwork.build(fully_connected(8), cable_m=2.0,
                               osc=OscillatorSpec(initial_ppm=8.0, seed=0))
    (sync, sync_s) = timed(lambda: net.sync(
        ctrl=ControllerConfig(kind="discrete", kp=2e-8, fs=1e-7,
                              pulses_per_update=50),
        cfg=SimConfig(dt=5e-5, steps=10_000, record_every=20,
                      quantize_beta=True)))
    out["d"] = dict(phase="quickstart", converged=sync.converged,
                    convergence_time_s=sync.convergence_time_s,
                    freq_spread_ppm=sync.freq_spread_ppm, wall_s=sync_s,
                    rtt_table={str(i): v for i, v in
                               rtt_table(sync.lsn.topo, net.links).items()},
                    latency_0_1=sync.lsn.latency(0, 1))
    emit(out["d"])
    assert sync.converged and sync.freq_spread_ppm < 1.0, out["d"]
    assert 33 <= out["d"]["latency_0_1"] <= 37, out["d"]
    out["launches"] = launches_a + launches_b + launches_c
    out["held"] = [dict(freq_ppm=err["freq_err_ppm"],
                        beta_frames=err.get("beta_err_frames", 0.0)),
                   held, held_c]
    return out


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
    t_start = time.perf_counter()

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build(["bittide_fused", "bittide_tiled", "bittide_sparse",
                        "bittide_step"])
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
    fc8, *_ = run_main_path(
        "fc8", fully_connected(8), 4096, 2e-8, 5e-5, 10_000, 20,
        Telemetry(beta=True, watermarks=True), dev, "fused", subset=256,
        reps=3)
    emit(fc8)

    # 4. dense torus at the fused regime's size
    torus, *_ = run_main_path(
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
    tiled, tiled_res = run_tiled(dev)
    emit(tiled)

    # 7. the scenario runner
    scen = run_scenarios(dev)

    # 8. the sparse lane at full width, and at phase 6's size
    sparse = run_sparse(dev)
    emit(sparse)
    emit(run_sparse_fig18(dev, tiled))

    # 9. chaos campaigns on the sparse lane
    chaos = run_chaos(dev)

    # 10. the per-step lane: Fig-18 scale, the cable swap through the
    # facade, the guard's host resync, the quickstart
    perstep = run_perstep(dev, tiled_res, scen)

    # The kernels line, the card line, the last line.  Launches: the main
    # paths' counts (phases 3, 4, 6, 7, 8, 9 and 10; the fused, tiled and
    # sparse wrappers count their calls that launched — one bittide_tiled
    # or bittide_sparse call launches a kernel per period and two or three
    # per measure pass from C — and bittide_perstep counts the kernels its
    # C loop launched).  Errors: the worst over every comparison with the
    # plain version (phase 2, the main paths' launches, phases 7, 9 and
    # 10's engine calls).
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
    fold("bittide_sparse", sparse["kernel_vs_plain_freq_err_ppm"], 0.0)
    for h in chaos["held"]:
        fold("bittide_sparse", h["freq_ppm"], h["beta_frames"])
    for h in perstep["held"]:
        fold("bittide_step", h["freq_ppm"], h["beta_frames"])
    ps = perstep["a"]
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))
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
             library_ms=None, library_note=no_library),
        dict(name="bittide_sparse", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_sparse.cu",
             replaces="src/repro/kernels/bittide_sparse.py:161 "
                      "(_sparse_kernel)",
             launches=sparse["launches"] + chaos["launches"],
             max_abs_err=errs["bittide_sparse"]["freq_ppm"],
             max_err_ppm=errs["bittide_sparse"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_sparse"]["beta_frames"],
             ms=sparse["kernel_ms"], plain_ms=sparse["plain_ms"],
             plain_work=sparse["plain_work"],
             bound_ms=sparse["bound_ms"], bound_by=sparse["bound_by"],
             library_ms=sparse["library_ms"],
             library_note=("two torch.sparse CSR products per pass (w·ψ and "
                           "(w·lat)·ν, (N, N) x (N, B)), timed over phase "
                           f"8's {sparse['passes']} passes; the aggregation "
                           "only, not the update; not used by the port")),
        dict(name="bittide_step", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_step.cu",
             replaces="src/repro/kernels/bittide_step.py:137 (_kernel)",
             launches=perstep["launches"],
             max_abs_err=errs["bittide_step"]["freq_ppm"],
             max_err_ppm=errs["bittide_step"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_step"]["beta_frames"],
             ms=ps["kernel_ms_per_pass"], plain_ms=ps["plain_ms_per_pass"],
             bound_ms=ps["bound_ms_per_pass"], bound_by=ps["bound_by"],
             library_ms=ps["library_ms_per_pass"],
             unit=f"one pass (one launch) of phase 10's {ps['topology']} "
                  "run; the call's time over its periods and measure "
                  "passes",
             ms_per_draw_call=ps["kernel_ms_per_draw"],
             plain_work=ps["plain_work"],
             library_note=ps["library_note"])]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
