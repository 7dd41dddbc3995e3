"""Live cable swap on the PyTorch port: the paper's §5.6 fiber-spool
experiment (``examples/cable_swap.py`` on ``repro_torch``).

The hardware team unplugs a 2 m cable on a running fully-connected-8
system, splices in a 2 km fiber spool, and watches (a) the frequency band
barely notice and (b) the round-trip logical latency of that link shift
by ≈1231 frames — the frames now in flight inside the fiber (Table 2).

  1. converge the network,
  2. LatencyStep both directions of link (0, 2) to 1 km of fiber each
     (with buffer re-establishment, like the physical replug),
  3. plot/print the buffer transient and the before/after RTT tables.

The buffer transient comes straight from the kernel: the dense lanes
(the default ``--engine auto``, the fused kernel on FC8; ``tiled`` and
``per-step`` their own kernels) record the per-node net occupancy β on
the card at every record point, so no occupancy reconstruction happens
on the host.  ``--engine segment-sum`` shows the per-edge stream of the
edge-list simulator instead.

    PYTHONPATH=src python examples/torch_cable_swap.py
        [--engine segment-sum] [--no-plot] [--smoke] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import (ControllerConfig, OscillatorSpec, SimConfig,
                              fully_connected, make_links)
from repro_torch.kernels import EngineOptions
from repro_torch.scenarios import (LatencyStep, Scenario, edges_between,
                                   run_scenario)
from repro_torch.telemetry import Telemetry, launch_counts, launches_since


def launch_text(launches: dict) -> str:
    """The launch counters' growth over a run, as words."""
    if not launches:
        return "no kernel launch: plain versions on the CPU"
    return "launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="auto",
                    choices=["segment-sum", "auto", "fused", "tiled",
                             "per-step"])
    ap.add_argument("--no-plot", action="store_true",
                    help="skip the matplotlib figure")
    ap.add_argument("--smoke", action="store_true",
                    help="short run for CI (fewer control periods)")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    topo = fully_connected(8)
    links = make_links(topo, cable_m=2.0)
    ppm = OscillatorSpec(initial_ppm=8.0, seed=0).sample(topo.num_nodes)
    ctrl = ControllerConfig(kp=2e-8)
    steps = 4_000 if args.smoke else 40_000
    cfg = SimConfig(dt=1e-4, steps=steps, record_every=20)
    t_swap = steps * 1e-4 / 2            # mid-run, converged by then

    swap = edges_between(topo, 0, 2)
    scenario = Scenario(
        events=(LatencyStep(t=t_swap, edges=swap, cable_m=1000.0,
                            reestablish=True),),
        name="fiber-spool-swap")

    before = launch_counts()
    res = run_scenario(topo, links, ctrl, ppm.astype(np.float32), scenario,
                       cfg, options=EngineOptions(engine=args.engine),
                       telemetry=Telemetry(beta=True), device=dev)
    launches = launches_since(before)

    rtt0, rtt1 = res.rtt(0), res.rtt(1)
    e = swap[0]
    print(f"engine: {res.engine} ({res.num_launches} engine calls, "
          f"chunk={res.chunk_records} records; {launch_text(launches)})")
    print(f"swap at t={t_swap:.2f}s on link (0, 2): 2 m -> 2 km of fiber")
    print(f"  RTT before: {rtt0[e]} frames   RTT after: {rtt1[e]} frames")
    print(f"  RTT shift:  {rtt1[e] - rtt0[e]} frames "
          "(paper Table 2: ~1231 = frames in flight in the spool)")
    others = [i for i in range(topo.num_edges) if i not in swap]
    other_shift = int(np.abs((rtt1 - rtt0)[others]).max())
    print(f"  other links shifted by: {other_shift} frames")

    spread = res.freq_ppm.max(axis=1) - res.freq_ppm.min(axis=1)
    i_swap = np.searchsorted(res.times, t_swap)
    post = spread[i_swap + 1:]
    print(f"frequency band around the swap: "
          f"{spread[i_swap - 1]:.4f} ppm before, "
          f"{post.max():.4f} ppm worst-case after "
          "(the paper's point: clock control barely notices)")
    out = dict(engine=res.engine, num_launches=res.num_launches,
               chunk_records=res.chunk_records, launches=launches,
               t_swap=t_swap, rtt_before=int(rtt0[e]),
               rtt_after=int(rtt1[e]), rtt_shift=int(rtt1[e] - rtt0[e]),
               other_shift=other_shift, band_before=float(spread[i_swap - 1]),
               band_after=float(post.max()), freq_ppm=res.freq_ppm,
               beta=res.beta, times=res.times)
    if res.beta.size:
        if args.engine == "segment-sum":
            occ = res.beta[:, e]          # per-edge stream (T, E)
            occ_label = f"edge {e} (swapped)"
        else:
            # dense lanes: per-node net occupancy (T, N) recorded on the
            # card — follow the swapped edge's destination node
            dst = int(np.asarray(topo.dst)[e])
            occ = res.beta[:, dst]
            occ_label = f"node {dst} net occupancy (in-kernel)"
        print(f"buffer occupancy [{occ_label}]: "
              f"{occ[i_swap]:.2f} at the swap -> re-established at "
              f"{occ[i_swap + 1]:.2f}, settled at {occ[-1]:.2f}")
        out.update(occ_label=occ_label, occ_at_swap=float(occ[i_swap]),
                   occ_reestablished=float(occ[i_swap + 1]),
                   occ_settled=float(occ[-1]))

    if not args.no_plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping figure")
            return out
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        ax1.plot(res.times, res.freq_ppm, lw=0.7)
        ax1.axvline(t_swap, color="k", ls="--", lw=0.8)
        ax1.set_ylabel("freq offset (ppm)")
        ax1.set_title("2 km fiber spliced into a running bittide network")
        if res.beta.size:
            ax2.plot(res.times, occ, lw=0.9, label=occ_label)
            ax2.axvline(t_swap, color="k", ls="--", lw=0.8)
            ax2.set_ylabel("buffer occupancy (frames)")
            ax2.legend()
        ax2.set_xlabel("time (s)")
        out_png = "cable_swap.png"
        fig.tight_layout()
        fig.savefig(out_png, dpi=120)
        print(f"wrote {out_png}")
    return out


if __name__ == "__main__":
    main()
