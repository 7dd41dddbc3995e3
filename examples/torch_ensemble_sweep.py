"""Monte Carlo ensemble sweep on the PyTorch port: convergence-time
statistics over oscillator draws, the regime the paper's ±8 ppm accuracy
numbers live in (``examples/ensemble_sweep.py`` on ``repro_torch``).

Every physical bittide deployment is one draw from the oscillator
population; the question that matters for provisioning ("how long until
the logical synchrony network is usable?") is a distribution, not a
number.  The batched ensemble engines answer it in one call per
(topology, controller) point:

  - `repro_torch.core.simulate_ensemble` — the segment-sum lane (the
    eager period loop on the card), any topology
  - `repro_torch.kernels.simulate_ensemble_dense` — the dense lane (the
    fused Hopper kernel for 8 nodes: one launch for every draw and period)

and because dt / record_every / kp are runtime arguments of the period
loop, not build keys, the sweeps below rebuild nothing.

    PYTHONPATH=src python examples/torch_ensemble_sweep.py [--draws 32]
        [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import (ControllerConfig, SimConfig, cube,
                              fully_connected, make_links, simulate_ensemble)
from repro_torch.kernels import simulate_ensemble_dense
from repro_torch.telemetry import launch_counts, launches_since


def runs_text(before: dict) -> str:
    """Segment-sum runs and kernel launches since ``before``, as words."""
    grew = launches_since(before)
    if not grew:
        return "no kernel launch: plain versions on the CPU"
    return ", ".join(f"{k} {'runs' if k == 'segment-sum' else 'launches'}: "
                     f"{v}" for k, v in grew.items())


def ensemble_run(topo, draws: int, seed: int = 0, device=None):
    """One segment-sum ensemble of `draws` ±8 ppm oscillator draws: (the
    ensemble, its wall)."""
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(seed).uniform(-8, 8, (draws, topo.num_nodes))
    cfg = SimConfig(dt=1e-3, steps=2000, record_every=20, record_beta=False)
    t0 = time.time()
    ens = simulate_ensemble(topo, links, ControllerConfig(kp=2e-8),
                            ppm.astype(np.float32), cfg, device=device)
    return ens, time.time() - t0


def convergence_distribution(topo, draws: int, seed: int = 0, device=None):
    """Convergence-time percentiles over `draws` ±8 ppm oscillator draws."""
    ens, wall = ensemble_run(topo, draws, seed, device)
    conv = ens.convergence_times(1.0)
    return conv, ens.final_spread_ppm, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    out = dict(distribution={}, dt_sweep={})

    print(f"== convergence-time distribution, B={args.draws} draws ==")
    for topo in (fully_connected(8), cube()):
        before = launch_counts()
        ens, wall = ensemble_run(topo, args.draws, device=dev)
        conv, spread = ens.convergence_times(1.0), ens.final_spread_ppm
        p50, p95 = np.percentile(conv, [50, 95])
        print(f"{topo.name:>18}: conv_1ppm p50={p50*1e3:6.1f} ms "
              f"p95={p95*1e3:6.1f} ms  worst_band={spread.max():.3f} ppm "
              f"({runs_text(before)}, {wall:.2f} s wall)")
        out["distribution"][topo.name] = dict(
            conv=conv, p50=float(p50), p95=float(p95),
            worst_band=float(spread.max()), wall_s=wall,
            freq_ppm=ens.freq_ppm, times=ens.times)

    # The fused kernel lane: same sweep through the dense kernel, one
    # launch covering all draws x periods (its plain version on the CPU).
    topo = fully_connected(8)
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(1).uniform(-8, 8, (16, topo.num_nodes))
    before = launch_counts()
    t0 = time.time()
    dense = simulate_ensemble_dense(topo, links, ppm, steps=1000, kp=2e-8,
                                    record_every=50, device=dev)
    wall = time.time() - t0
    freq = dense[0]
    band = freq[:, -1].max(axis=1) - freq[:, -1].min(axis=1)
    print(f"\n{dense.engine} kernel lane: 16 draws x 1000 periods "
          f"({runs_text(before)}), {wall:.2f} s wall; final bands "
          f"[{band.min():.3f}, {band.max():.3f}] ppm")
    out["dense"] = dict(engine=dense.engine, freq_ppm=freq,
                        band_min=float(band.min()),
                        band_max=float(band.max()), wall_s=wall)

    print("\nsweeping dt rebuilds nothing (dt is a runtime argument of "
          "the period loop):")
    for dt in (5e-4, 1e-3, 2e-3):
        cfg = SimConfig(dt=dt, steps=1000, record_every=20, record_beta=False)
        ens = simulate_ensemble(topo, links, ControllerConfig(kp=2e-8),
                                ppm.astype(np.float32), cfg, device=dev)
        conv = ens.convergence_times(1.0)
        print(f"  dt={dt*1e3:4.1f} ms -> conv_1ppm p50="
              f"{np.median(conv)*1e3:6.1f} ms")
        out["dt_sweep"][dt] = dict(p50=float(np.median(conv)), conv=conv,
                                   freq_ppm=ens.freq_ppm, times=ens.times)

    # Fig-15-style proportional-gain sweep: kp is PER-DRAW state, so B
    # gains over one oscillator draw run as one batched period loop.
    kps = np.geomspace(5e-9, 5e-8, 8)
    draw = np.random.default_rng(2).uniform(-8, 8, topo.num_nodes)
    tiled = np.tile(draw, (len(kps), 1)).astype(np.float32)
    cfg = SimConfig(dt=1e-3, steps=1500, record_every=20, record_beta=False)
    before = launch_counts()
    t0 = time.time()
    ens = simulate_ensemble(topo, links, ControllerConfig(kp=kps), tiled, cfg,
                            device=dev)
    wall = time.time() - t0
    conv = ens.convergence_times(1.0)
    print(f"\nkp sweep ({len(kps)} gains, {runs_text(before)}, "
          f"{wall:.2f} s wall):")
    for kp, c in zip(kps, conv):
        print(f"  kp={kp:.2e} -> conv_1ppm={c*1e3:6.1f} ms")
    out["kp_sweep"] = dict(kp=kps, conv=conv, wall_s=wall,
                           freq_ppm=ens.freq_ppm, times=ens.times)
    return out


if __name__ == "__main__":
    main()
