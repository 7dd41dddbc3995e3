"""Chaos campaign on the PyTorch port: per-draw randomized fault
injection with envelope property checks and survival triage
(``examples/chaos_campaign.py`` on ``repro_torch``).

The paper's claim is structural: logical synchrony survives physical
disturbance because the control loop keeps elastic-buffer occupancy
bounded (§4, §5.6).  This demo stress-tests that claim the way a
property-based testing harness would — B=1024 *different* randomized
fault scenarios (oscillator steps, thermal drift ramps, cable swaps),
each with its own magnitudes and victim nodes, run simultaneously as ONE
batched ensemble:

  1. ``ChaosCampaign`` samples per-draw events from seeded samplers and
     lowers them into a single batched :class:`Scenario` — every event
     parameter is runtime data, so the whole campaign runs through one
     chain of engine calls and rebuilds no kernel;
  2. every draw's β record is checked against its OWN closed-form
     occupancy envelope (amplitude + decay rate from the graph
     Laplacian) plus a guard band, and against the physical buffer wall
     ``depth/2``;
  3. the triage table classifies each draw PASS / ENVELOPE-VIOLATION /
     OVERFLOW / RESCUED-BY-REFRAME, and the worst draw shrinks to a
     standalone single-draw repro that reproduces its verdict.

The full run uses the 8×8×8 torus of the paper's scale-out experiments
(512 nodes) on the segment-sum lane (the eager period loop on the card);
``--engine fused`` / ``tiled`` / ``per-step`` run the dense kernels.

    PYTHONPATH=src python examples/torch_chaos_campaign.py [--draws 1024]
        [--engine segment-sum] [--no-plot] [--smoke] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import (ControllerConfig, SimConfig, fully_connected,
                              make_links, torus3d)
from repro_torch.scenarios import (VERDICT_OVERFLOW, ChaosCampaign,
                                   DriftRamp, DriftRampSampler, FreqStep,
                                   FreqStepSampler, LatencyStepSampler,
                                   edges_between)


def disturbance_ppm(result):
    """Per-draw total injected frequency disturbance (ppm): |FreqStep|
    plus each DriftRamp's integrated drift — the x-axis of the
    failure-rate sweep."""
    out = np.zeros(result.num_draws)
    for ev in result.scenario.events:
        for b in range(result.num_draws):
            d = ev.draw(b)
            if isinstance(d, FreqStep):
                out[b] += abs(float(np.max(np.abs(d.delta_ppm))))
            elif isinstance(d, DriftRamp):
                out[b] += abs(float(np.max(np.abs(d.rate_ppm_per_s)))) \
                    * (d.t_end - d.t)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="segment-sum",
                    choices=["segment-sum", "auto", "fused", "tiled",
                             "per-step"])
    ap.add_argument("--draws", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="small FC8 campaign for CI")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    if args.smoke:
        topo = fully_connected(8)
        draws = args.draws or 24
        steps = 1200
    else:
        topo = torus3d(8)
        draws = args.draws or 1024
        steps = 4800
    ctrl = ControllerConfig(kp=2e-8)
    cfg = SimConfig(dt=1e-3, steps=steps, record_every=24)
    t_hold = steps * cfg.dt

    # Fault magnitudes span calm to brutal: with kp=2e-8 the buffer wall
    # (depth/2 = 16 frames) sits a few ppm of single-victim step away, so
    # this range produces a PASS/OVERFLOW mix rather than a monoculture.
    campaign = ChaosCampaign(
        topo=topo, ctrl=ctrl,
        samplers=(
            FreqStepSampler(t=0.15 * t_hold, ppm_range=(0.05, 6.0),
                            victims=1),
            DriftRampSampler(t=0.35 * t_hold, t_end=0.6 * t_hold,
                             rate_range=(0.05, 2.0), victims=1),
            LatencyStepSampler(t=0.5 * t_hold,
                               edges=edges_between(topo, 0, 1),
                               cable_range=(5.0, 200.0)),
        ),
        num_draws=draws, seed=args.seed, ppm_range=0.05,
        links=make_links(topo, cable_m=2.0),
        cfg=cfg, engine=args.engine, auto_reframe=True, depth=32,
        name="smoke" if args.smoke else "torus512")

    result = campaign.run(device=dev)
    summary = result.summary()
    print(summary)
    counts = result.counts()
    print(f"survival rate: {100.0 * result.survival_rate():.1f}% "
          f"({counts[VERDICT_OVERFLOW]} overflow)")

    # Shrink-to-repro: the worst draw exports as a standalone single-draw
    # Scenario and must reproduce its campaign verdict by itself.
    shrunk = result.shrink()
    verdict = shrunk.run()
    print(f"shrunk repro (draw #{shrunk.draw_index}): expected "
          f"{shrunk.expected_verdict}, standalone run -> {verdict} "
          f"[{'OK' if verdict == shrunk.expected_verdict else 'MISMATCH'}]")
    out = dict(topology=topo.name, draws=draws, steps=steps,
               engine=result.result.engine,
               num_launches=result.result.num_launches, summary=summary,
               counts=counts, survival_rate=result.survival_rate(),
               verdicts=result.verdicts, margins=result.margins,
               freq_ppm=result.result.freq_ppm, beta=result.result.beta,
               shrunk_draw=shrunk.draw_index,
               shrunk_expected=shrunk.expected_verdict,
               shrunk_verdict=verdict)

    if not args.no_plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not installed; skipping plot")
            return out
        dist = disturbance_ppm(result)
        failed = result.verdicts == VERDICT_OVERFLOW
        edges = np.quantile(dist, np.linspace(0, 1, 9))
        centers, rates = [], []
        for lo, hi in zip(edges[:-1], edges[1:]):
            sel = (dist >= lo) & (dist <= hi)
            if sel.any():
                centers.append(dist[sel].mean())
                rates.append(failed[sel].mean())
        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 4))
        ax0.plot(centers, 100.0 * np.asarray(rates), "o-")
        ax0.set_xlabel("injected disturbance (ppm)")
        ax0.set_ylabel("overflow rate (%)")
        ax0.set_title(f"failure rate vs disturbance ({draws} draws)")
        ok = ~np.isnan(result.margins)
        ax1.hist(result.margins[ok], bins=32)
        ax1.axvline(0.0, color="r", ls="--", label="envelope boundary")
        ax1.set_xlabel("envelope margin (frames)")
        ax1.set_ylabel("draws")
        ax1.set_title("surviving-draw envelope margins")
        ax1.legend()
        fig.suptitle(f"chaos campaign on {topo.name}, one batched run per "
                     f"engine ({result.result.num_launches} engine calls)")
        fig.tight_layout()
        fig.savefig("chaos_campaign.png", dpi=120)
        print("wrote chaos_campaign.png")
    return out


if __name__ == "__main__":
    main()
