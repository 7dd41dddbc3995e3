"""Closed-loop buffer re-centering on the PyTorch port: run a drifting
network forever in a 32-deep elastic buffer (``examples/auto_reframe.py``
on ``repro_torch``).

The paper's elastic buffers are 32 frames deep; they only stay usable
because the hardware *reframes* — rotates read pointers so occupancy
returns to the setpoint, trading logical latency for headroom (§4.2;
"Buffer Centering for bittide Synchronization via Frame Rotation",
arXiv:2504.07044).  This demo closes that loop in simulation:

  1. a slow thermal drift ramp drags three nodes' oscillators by ~4 ppm —
     under pure-P control the buffer occupancies track the frequency
     deviation and would blow through the 32-deep buffer;
  2. ``run_scenario(telemetry=Telemetry(guard=policy))`` watches the β
     record the kernel writes on the card against the guard band
     ``depth/2 − margin`` and splices RTT-conserving pointer rotations
     (integer node potentials from the Laplacian least-squares solve)
     whenever occupancy approaches the wall — the same kernel library,
     loaded once, is launched again after every splice;
  3. the run stays inside the buffer; every RTT is conserved exactly
     (reverse-pair shifts cancel), so the logical-synchrony schedule the
     applications were planned against is untouched.

    PYTHONPATH=src python examples/torch_auto_reframe.py [--engine fused]
        [--no-plot] [--smoke] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import (ControllerConfig, ReframePolicy, SimConfig,
                              fully_connected, make_links)
from repro_torch.kernels import EngineOptions
from repro_torch.scenarios import (DriftRamp, LatencyStep, Scenario,
                                   edges_between, run_scenario)
from repro_torch.telemetry import (Telemetry, compile_stats, launch_counts,
                                   launches_since)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="fused",
                    choices=["segment-sum", "auto", "fused", "tiled",
                             "per-step"])
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="short run for CI")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    topo = fully_connected(8)
    links = make_links(topo, cable_m=2.0)
    rng = np.random.default_rng(7)
    ppm = rng.uniform(-1, 1, topo.num_nodes).astype(np.float32)
    ppm -= ppm.mean()
    ctrl = ControllerConfig(kp=2e-8)
    steps = 720 if args.smoke else 2880
    cfg = SimConfig(dt=1e-3, steps=steps, record_every=12)
    t_end = 0.75 * steps * cfg.dt
    scenario = Scenario(events=(
        DriftRamp(t=0.06, t_end=t_end, nodes=(0, 1, 2),
                  rate_ppm_per_s=7.5 * 0.48 / (t_end - 0.06)),
        LatencyStep(t=t_end + 0.06, edges=edges_between(topo, 0, 2),
                    cable_m=1000.0),
    ), name="thermal-drift")
    policy = ReframePolicy(depth=16, margin=4.0)
    opts = EngineOptions(engine=args.engine)

    plain = run_scenario(topo, links, ctrl, ppm, scenario, cfg,
                         options=opts, telemetry=Telemetry(beta=True),
                         device=dev)
    builds, before = compile_stats()["builds"], launch_counts()
    res = run_scenario(topo, links, ctrl, ppm, scenario, cfg, options=opts,
                       telemetry=Telemetry(beta=True, guard=policy),
                       device=dev)
    launches = launches_since(before)
    builds = compile_stats()["builds"] - builds

    deg = np.zeros(topo.num_nodes)
    np.add.at(deg, np.asarray(topo.dst), 1.0)
    occ = lambda r: (np.abs(r.beta).max() if r.engine == "segment-sum"
                     else np.abs(r.beta / deg).max())
    counted = (", ".join(f"{k} {v}" for k, v in launches.items())
               or "none: plain versions on the CPU")
    print(f"engine: {res.engine} ({res.num_launches} engine calls, "
          f"{len(res.reframes)} reframe splices, {builds} kernel builds; "
          f"launches: {counted})")
    print(f"worst occupancy without reframing: {occ(plain):6.1f} frames "
          f"(32-deep buffer holds |β| <= 16)")
    print(f"worst occupancy with auto_reframe: {occ(res):6.1f} frames")
    total = res.total_reframe_shift
    rev = topo.reverse_edge_index()
    print(f"accumulated pointer shift: |Δλ| up to {np.abs(total).max()} "
          f"frames per edge; every RTT conserved exactly "
          f"(max |shift_e + shift_rev| = {np.abs(total + total[rev]).max()})")
    rtt_shift = res.rtt(-1) - res.rtt(0)
    sw = edges_between(topo, 0, 2)
    print(f"RTT shift on the swapped link: {int(rtt_shift[sw[0]])} frames "
          "(the fiber spool's in-flight frames — untouched by reframing)")
    out = dict(engine=res.engine, num_launches=res.num_launches,
               reframes=len(res.reframes), builds=builds, launches=launches,
               worst_plain=float(occ(plain)), worst_reframed=float(occ(res)),
               max_shift=int(np.abs(total).max()),
               rtt_residual=int(np.abs(total + total[rev]).max()),
               rtt_shift=int(rtt_shift[sw[0]]),
               total_shift=total, freq_ppm=res.freq_ppm, beta=res.beta,
               plain_freq_ppm=plain.freq_ppm, plain_beta=plain.beta)

    if not args.no_plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping figure")
            return out
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        node = int(np.asarray(topo.dst)[sw[0]])
        for r, label, style in ((plain, "no reframing", "--"),
                                (res, "auto_reframe", "-")):
            b = (r.beta[:, sw[0]] if r.engine == "segment-sum"
                 else r.beta[:, node] / deg[node])
            ax1.plot(r.times, b, style, lw=0.9, label=label)
        ax1.axhline(16, color="r", lw=0.8)
        ax1.axhline(-16, color="r", lw=0.8)
        for rf in res.reframes:
            ax1.axvline(rf.time, color="k", lw=0.3, alpha=0.3)
        ax1.set_ylabel("occupancy (frames)")
        ax1.legend()
        ax1.set_title("closed-loop buffer re-centering under thermal drift")
        ax2.plot(res.times, res.freq_ppm, lw=0.7)
        ax2.set_ylabel("freq offset (ppm)")
        ax2.set_xlabel("time (s)")
        fig.tight_layout()
        fig.savefig("auto_reframe.png", dpi=120)
        print("wrote auto_reframe.png")
    return out


if __name__ == "__main__":
    main()
