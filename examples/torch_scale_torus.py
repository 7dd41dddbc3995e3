"""Scale demo (paper Fig 18) on the PyTorch port: synchronize a 22^3 =
10648-node 3-D torus, then scan network size to show convergence-time
scaling with algebraic connectivity (``examples/scale_torus.py`` on
``repro_torch``) — the question the paper says simulation exists to
answer ("how long does it take for buffer occupancies to converge when
there are many thousands of nodes").

    PYTHONPATH=src python examples/torch_scale_torus.py [--k 22]
        [--no-watermarks] [--device cpu]

The tori run on the segment-sum lane (the eager period loop on the card).
The run ends with the observability capstone: a torus3d(100) =
10^6-node run on the sparse ELL kernel with its excursion watermarks ON
and the full (R, B, N) record OFF — the per-node peak |β| / ν-spread
health report exists even where materializing the record is impossible
(``--no-watermarks`` skips it).
"""
import argparse
import time

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                              simulate, torus3d)
from repro_torch.core.envelopes import reframe_guard_margin


def sync_torus(k: int, kp: float = 2e-8, duration_s: float = 30.0,
               device=None):
    topo = torus3d(k)
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, topo.num_nodes).astype(np.float32)
    dt = 5e-3
    cfg = SimConfig(dt=dt, steps=int(duration_s / dt), record_every=100,
                    record_beta=False)
    t0 = time.time()
    res = simulate(topo, links, ControllerConfig(kp=kp), ppm, cfg,
                   device=device)
    wall = time.time() - t0
    return topo, res, wall


def watermark_health(k: int = 100, depth: int = 32, device=None):
    """10^6-node watermark run: sparse engine, NO (R, B, N) record."""
    from repro_torch.kernels import EngineOptions, simulate_fused
    from repro_torch.telemetry import Telemetry

    topo = torus3d(k)
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-0.5, 0.5, topo.num_nodes)
    ppm = (ppm - ppm.mean()).astype(np.float32)
    dt, steps, record_every, kp = 1e-3, 8, 4, 2e-8
    t0 = time.time()
    res = simulate_fused(topo, links, ppm, steps=steps, kp=kp, dt=dt,
                         record_every=record_every,
                         options=EngineOptions(engine="sparse"),
                         telemetry=Telemetry(watermarks=True), device=device)
    wall = time.time() - t0
    assert res.beta is None  # the whole point: no record materialized
    # The guard margin needs the dense Laplacian spectrum — 7 TiB at
    # 10^6 nodes.  Every 3-D torus is 6-regular with k-independent
    # λ_max, and the slack terms the margin charges (in-flight ν·ω·l
    # coupling, second-order controller products, float32 rounding) are
    # per-node quantities, so a small same-family torus is a faithful
    # proxy for the margin.
    margin = reframe_guard_margin(torus3d(10), kp, dt, record_every,
                                  nu_bound=2e-6, lat_frames_max=2.0)
    print(f"\nwatermark health, torus3d({k}) = {topo.num_nodes} nodes, "
          f"{steps} steps, engine={res.engine}, wall={wall:.1f}s "
          f"(a (R, N) record costs {4 * topo.num_nodes / 1e6:.0f} MB per "
          f"record point; watermarks stay "
          f"{4 * 4 * topo.num_nodes / 1e6:.0f} MB at any horizon)")
    report = res.watermarks.health_report(depth=depth, guard_margin=margin)
    print(report)
    return dict(nodes=topo.num_nodes, engine=res.engine, wall_s=wall,
                margin=margin, report=report, watermarks=res.watermarks,
                freq_ppm=res[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=22)
    ap.add_argument("--no-watermarks", action="store_true",
                    help="skip the 10^6-node watermark health report")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    out = dict(tori=[])
    for k in (6, 10, 14, args.k):
        topo, res, wall = sync_torus(k, device=dev)
        band = np.ptp(res.freq_ppm[-1])
        tconv = res.convergence_time(1.0)
        # algebraic connectivity of a k-torus: 2 - 2cos(2*pi/k)
        lam2 = 2 - 2 * np.cos(2 * np.pi / k)
        print(f"k={k:3d} nodes={topo.num_nodes:6d} edges={topo.num_edges:6d} "
              f"conv_1ppm={tconv:6.2f}s band={band:6.3f}ppm "
              f"lambda2={lam2:.4f} wall={wall:5.1f}s")
        out["tori"].append(dict(k=k, nodes=topo.num_nodes,
                                edges=topo.num_edges, conv_s=tconv,
                                band_ppm=float(band), lambda2=float(lam2),
                                wall_s=wall, freq_ppm=res.freq_ppm,
                                psi_abs_max=float(np.abs(res.psi).max())))
    print("\nconvergence time scales ~1/lambda2 — the simulator answers the "
          "paper's scaling question without 10k FPGAs.")
    if not args.no_watermarks:
        out["health"] = watermark_health(device=dev)
    return out


if __name__ == "__main__":
    main()
