#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line:

1. build    — nvcc builds ``csrc/bittide_fused.cu``; its ptxas report
              (registers, shared memory, spills) and the card's
              ``nvidia-smi`` name and power limit are printed.
2. parity   — the fused kernel against its plain PyTorch version on the
              card (``PARITY_CASES``): FC8 at B=64 and at 4·SMs·3 + 5
              draws (three draws per CTA, a partial last CTA), torus3d(6)
              at B=16 with two latency classes (A read from L2) and with
              one (A in shared memory); per-draw kp / lat / lamsum /
              holdover mask, 400 periods recorded every 20, all four
              variants.
3. fc8      — the main path at users' size: ``simulate_ensemble_dense`` on
              fully_connected(8), B=4096 draws in ±8 ppm, kp=2e-8,
              dt=5e-5, 10,000 steps recorded every 20, β + watermarks;
              256 draws held against the segment-sum lane on the card.
4. torus    — torus3d(6), B=256, kp=2e-8, dt=1e-3, 2,000 steps,
              watermarks; 16 draws held against the segment-sum lane.

Phases 3 and 4 also launch the kernel once more on the main path's own
inputs, check that this launch reproduces the main path's records bit for
bit, and hold it against the plain version over every draw.
5. segsum   — the segment-sum lane: cube, B=64, the quickstart's discrete
              controller with quantized β, dt=1e-3, 2,000 steps; every
              draw must converge into the 1 ppm band.

Then the kernels line, the card's ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and ends the
run with a non-zero exit; without a CUDA card it exits 2 and prints no
result.
"""
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


def parity_inputs(case, dev):
    """(topology, kernel args ending in Δ = 125,000 frames, per-draw mask)
    of one of ``PARITY_CASES``."""
    import numpy as np
    from repro_torch.core import fully_connected, make_links, torus3d
    name, b, classes = case
    topo = {"fully_connected_8": lambda: fully_connected(8),
            "torus3d_6": lambda: torus3d(6)}[name]()
    b = waves_draws(dev) if b == "waves" else b
    links = (two_class_links(topo) if classes == 2
             else make_links(topo, cable_m=2.0))
    ppm = np.random.default_rng(1).uniform(-8, 8, (b, topo.num_nodes))
    args, mask = fused_inputs(topo, links, ppm, 2e-8, dev, seed=2)
    assert args[3].shape[0] == classes, args[3].shape
    return topo, args + (125000.0,), mask


def kernel_vs_plain(got, want) -> dict:
    """The kernel's errors against the plain version's outputs; raises
    when one leaves its bar (ν at FREQ_ATOL_PPM, β and max |β| at
    BETA_ATOL_FRAMES, watermark indices exactly)."""
    import torch
    err = dict(freq_err_ppm=float((got.freq - want.freq).abs().max() * 1e6),
               psi_err_frames=float((got.psi - want.psi).abs().max()))
    if got.beta is not None:
        err["beta_err_frames"] = float((got.beta - want.beta).abs().max())
    if got.watermarks is not None:
        err["peak_record_equal"] = bool(torch.equal(got.watermarks[1],
                                                    want.watermarks[1]))
        err["beta_abs_max_err_frames"] = float(
            (got.watermarks[0] - want.watermarks[0]).abs().max())
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
    a, _, classes, _ = densify(topo, links, device=dev)
    b, n = ppm.shape
    c = a.shape[0]
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
    args = (torch.zeros_like(nu_u), nu_u, nu_u.clone(), a,
            a.sum(dim=(0, 2)), put(lamsum), put(lat), put(kp_v), put(boff))
    return args, put(mask)


def bound(b, n, c, nnz, steps, records, beta, wm):
    """(bound_ms, bound_by) for one fused launch.

    Bytes: every input read once, every output written once.  Operations:
    what this run's data needs — 2 per nonzero of the stack per period
    plus the per-node update (x_c: 2C, err/ν'/ψ': 10), and at records
    with β or watermarks the centring (N+1) and the measure pass
    (2 per nonzero + 3C per node + 4).
    """
    nodes = b * n
    in_bytes = 4 * (4 * nodes + c * n * n + n + b * c + 2 * b + n)
    out_bytes = 4 * (2 * nodes + records * nodes * (1 + beta) + 4 * wm * nodes)
    ops = b * steps * (2 * nnz + n * (2 * c + 10))
    if beta or wm:
        ops += b * records * (n * (n + 1) + 2 * nnz + n * (3 * c + 4))
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


def phase_parity(dev):
    """Kernel vs plain version on the card; returns the max errors."""
    import torch
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  launch_plan)
    worst = dict(freq_ppm=0.0, beta_frames=0.0)
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
            row = dict(phase="parity", topology=topo.name, draws=b,
                       classes=args[3].shape[0], beta=beta, watermarks=wm,
                       launch_plan=plan)
            row.update(kernel_vs_plain(got, want))
            emit(row)
            worst["freq_ppm"] = max(worst["freq_ppm"], row["freq_err_ppm"])
            worst["beta_frames"] = max(worst["beta_frames"],
                                       row.get("beta_err_frames", 0.0))
    # The cases reach A in shared memory and in L2, and several draws per
    # CTA with a partial last CTA.
    assert {p["a_in_smem"] for p, _ in plans} == {True, False}, plans
    assert any(p["draws_per_cta"] > 1 and b % p["draws_per_cta"]
               for p, b in plans), plans
    return worst


def run_dense(name, topo, b, kp, dt, steps, rec, tel, dev, subset, reps):
    """One main-path run of the fused lane plus its measurements.

    After the main path: the segment-sum lane on ``subset`` draws, the
    kernel's CUDA-event time over ``reps`` launches, and one more launch on
    the main path's inputs that must reproduce its records bit for bit and
    is held against the plain version over every draw.
    """
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  simulate_ensemble)
    from repro_torch.kernels import simulate_ensemble_dense
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  launch_plan)
    from repro_torch.telemetry import Watermarks
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, topo.num_nodes))
    records = steps // rec

    torch.cuda.reset_peak_memory_stats()
    bittide_fused.launches = 0
    t0 = time.perf_counter()
    res = simulate_ensemble_dense(topo, links, ppm, steps, kp, dt=dt,
                                  record_every=rec, telemetry=tel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_fused.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, f"{name}: the main path launched no fused kernel"

    freq, psi = res
    assert res.engine == "fused"
    assert freq.shape == (b, records, topo.num_nodes), freq.shape
    assert np.isfinite(freq).all() and np.isfinite(psi).all()
    if tel.beta:
        assert res.beta.shape == freq.shape and np.isfinite(res.beta).all()
        full = Watermarks.from_record(res.beta, freq)
        assert np.array_equal(res.watermarks.peak_record, full.peak_record)
        assert np.array_equal(res.watermarks.beta_abs_max,
                              full.beta_abs_max)
        assert np.array_equal(res.watermarks.nu_min_ppm, full.nu_min_ppm)
    if tel.watermarks:
        assert np.isfinite(res.watermarks.beta_abs_max).all()

    times = (np.arange(1, records + 1) * rec) * dt
    ss = simulate_ensemble(topo, links, ControllerConfig(kp=kp),
                           ppm[:subset],
                           SimConfig(dt=dt, steps=steps, record_every=rec,
                                     record_beta=False))
    err_ss = float(np.abs(freq[:subset] - ss.freq_ppm).max())
    deg_max = int(topo.in_degree.max())
    bar = max(FREQ_ATOL_PPM,
              float32_floor_ppm(kp, deg_max, float(np.abs(psi).max())))

    args, mask = fused_inputs(topo, links, ppm, kp, dev)
    kw = dict(num_records=records, record_every=rec, ctrl_mask=mask,
              record_beta=tel.beta, record_watermarks=tel.watermarks)
    dt_frames = float(125e6 * dt)
    kernel_ms = cuda_ms(lambda: bittide_fused(*args, dt_frames, **kw), reps)

    got = bittide_fused(*args, dt_frames, **kw)
    host = lambda x: x.transpose(0, 1).cpu().numpy()
    assert np.array_equal(host(got.freq * 1e6), freq), \
        f"{name}: the compared launch differs from the main path's"
    if tel.beta:
        assert np.array_equal(host(got.beta), res.beta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = bittide_fused_torch(*args, dt_frames, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = kernel_vs_plain(got, want)
    bound_ms, bound_by = bound(b, topo.num_nodes, args[3].shape[0],
                               float((args[3] != 0).sum()), records * rec,
                               records, tel.beta, tel.watermarks)
    out = dict(phase=name, topology=topo.name, draws=b, steps=steps,
               record_every=rec, dt=dt, kp=kp, launches=launches,
               launch_plan=launch_plan(b, topo.num_nodes, args[3].shape[0],
                                       dev),
               wall_s=wall, kernel_ms=kernel_ms,
               node_steps_per_s_kernel=b * topo.num_nodes * steps
               / (kernel_ms * 1e-3),
               node_steps_per_s_wall=b * topo.num_nodes * steps / wall,
               max_memory_allocated=mem,
               segment_sum_draws=subset,
               freq_err_vs_segment_sum_ppm=err_ss,
               holds_freq_atol_ppm=err_ss <= FREQ_ATOL_PPM,
               segment_sum_bar_ppm=bar, plain_ms=plain_ms,
               kernel_vs_plain_draws=b,
               **{f"kernel_vs_plain_{k}": v for k, v in err.items()},
               bound_ms=bound_ms, bound_by=bound_by, **summary(freq, times))
    assert err_ss <= bar, out
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

    # 1. build
    t0 = time.perf_counter()
    lib = build.build(["bittide_fused"])["bittide_fused"]
    log = lib.with_suffix(".so.log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln or "smem" in ln]
             if log.exists() else ["library already built; no ptxas log"])
    emit(dict(phase="build", library=lib.name,
              seconds=time.perf_counter() - t0, ptxas=ptxas,
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))
    print(smi, flush=True)

    # 2. kernel vs plain version
    worst = phase_parity(dev)

    # 3. main path: FC8 ensemble at users' size
    fc8 = run_dense(
        "fc8", fully_connected(8), 4096, 2e-8, 5e-5, 10_000, 20,
        Telemetry(beta=True, watermarks=True), dev, subset=256, reps=3)
    emit(fc8)

    # 4. dense torus at the fused regime's size
    torus = run_dense(
        "torus", torus3d(6), 256, 2e-8, 1e-3, 2_000, 20,
        Telemetry(watermarks=True), dev, subset=16, reps=2)
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

    # 6. kernels line, card line, last line: errors over every comparison
    # with the plain version (phase 2 and the main paths' launches).
    err_ppm = max(worst["freq_ppm"], fc8["kernel_vs_plain_freq_err_ppm"],
                  torus["kernel_vs_plain_freq_err_ppm"])
    err_beta = max(worst["beta_frames"],
                   fc8["kernel_vs_plain_beta_err_frames"])
    emit({"kernels": [dict(
        name="bittide_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/bittide_fused.cu",
        replaces="src/repro/kernels/bittide_step.py:271 (_fused_kernel)",
        launches=fc8["launches"] + torus["launches"],
        max_abs_err=err_ppm, max_err_ppm=err_ppm,
        max_beta_err_frames=err_beta, ms=fc8["kernel_ms"],
        plain_ms=fc8["plain_ms"], bound_ms=fc8["bound_ms"],
        bound_by=fc8["bound_by"], library_ms=None)]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
