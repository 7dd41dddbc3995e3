"""Serving under stragglers on the PyTorch port: bittide vs barrier vs
async pacing (``examples/serve_bittide.py`` on ``repro_torch``).

The paper's §8 claim at serving granularity.  A continuous-batching
cluster (admission queue → decode slots, chunked prefill, one token per
occupied slot per tick) is paced by the REAL bittide ensemble engine:
one ``run_scenario`` ensemble on the card carries both the controlled
(kp>0) and free-running (kp=0) rate trajectories, and mid-serve fault
events — a straggler onset, a thermal drift ramp, a holdover window, a
link outage — perturb the serving numbers exactly as the frame model
dictates; the engine is launched again per event segment and nothing is
rebuilt.

Against a diurnal + flash-burst arrival process, three pacing
disciplines serve the *same* workload off the *same* ensemble run:

* ``bittide`` — logically synchronous; workers converge to the
  consensus rate, coordination costs zero in-band overhead;
* ``barrier`` — pinned to the instantaneous slowest worker AND paying a
  barrier collective every step;
* ``async``  — free-running with bounded queues; every half-depth
  occupancy crossing costs a credit-stall round trip.

The example prints the p50/p99/p99.9 + goodput comparison and hard-fails
if bittide's goodput drops below barrier's (the claim under test).

    PYTHONPATH=src python examples/torch_serve_bittide.py [--smoke]
        [--no-plot] [--device cpu]
"""
import argparse
import sys

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import ring
from repro_torch.scenarios import (DriftRamp, FreqStep, LinkDrop,
                                   LinkRestore, NodeHoldover, NodeReset,
                                   Scenario)
from repro_torch.serve import (DISCIPLINES, ArrivalConfig, DisciplineConfig,
                               ServeConfig, StepCostModel, generate_requests,
                               pace_workers, serve)
from repro_torch.telemetry import (RunTrace, Watermarks, launch_counts,
                                   launches_since)


def build_scenario(duration_s: float) -> Scenario:
    """Mid-serve faults at fractions of the horizon: straggler onset,
    thermal drift, a holdover window, and a link outage + restore."""
    f = lambda x: x * duration_s
    return Scenario(events=(
        FreqStep(t=f(0.15), nodes=(3,), delta_ppm=-80_000.0),
        DriftRamp(t=f(0.35), t_end=f(0.55), nodes=(5,),
                  rate_ppm_per_s=60_000.0 / duration_s),
        NodeHoldover(t=f(0.45), nodes=(1,)),
        NodeReset(t=f(0.65), nodes=(1,)),
        LinkDrop(t=f(0.55), edges=(0,)),
        LinkRestore(t=f(0.75), edges=(0,)),
    ), name="serve-faults")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="arrival + pacing horizon, seconds")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="elastic queue depth in steps (async bound)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.duration, args.rate, args.workers = 24.0, 4.0, 8
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    # Worker step-rate heterogeneity at the straggler scale (±5%).
    rng = np.random.default_rng(args.seed + 7)
    speed_ppm = rng.uniform(-50_000, 50_000, args.workers)
    scenario = build_scenario(args.duration)

    trace = RunTrace(name="serve_bittide")
    before = launch_counts()
    pe = pace_workers(ring(args.workers), speed_ppm, scenario,
                      kp=5e-3, steps_per_second=10.0,
                      duration_s=args.duration, record_every=5,
                      trace=trace, device=dev)
    runs = launches_since(before).get("segment-sum", 0)
    print(f"[pacing] {args.workers} workers, "
          f"{len(pe.result.compiled.segments)} event segments, "
          f"{pe.result.num_launches} engine calls ({runs} segment-sum "
          f"runs), ONE ensemble (controlled + free-running draws)")

    reqs = generate_requests(ArrivalConfig(
        rate_rps=args.rate, duration_s=args.duration,
        diurnal_amp=0.4, diurnal_period_s=args.duration,
        burst_rate_mult=3.0, burst_duration_s=args.duration / 20,
        num_bursts=2, prompt_mean=48.0, output_mean=24.0,
        seed=args.seed))
    print(f"[arrivals] {reqs.num_requests} requests, "
          f"{reqs.total_tokens} tokens offered "
          f"({reqs.offered_load_tps:.1f} tok/s, diurnal + 2 bursts)")

    cost = StepCostModel.from_zoo(args.arch, decode_slots=args.slots,
                                  hw_flops=1e12)
    cfg = ServeConfig(decode_slots=args.slots, prefill_chunk=64,
                      slo_s=args.duration / 2)
    disc = DisciplineConfig(queue_depth=args.queue_depth)

    results = {}
    for d in DISCIPLINES:
        results[d] = serve(reqs, pe.schedule(d, disc), cost, cfg,
                           trace=trace)
        print(results[d].summary())

    wm = Watermarks.from_record(
        np.abs(pe.result.beta[0]).max(axis=1, keepdims=True),
        pe.result.freq_ppm[0].max(axis=1, keepdims=True))
    beta_peak = float(wm.beta_abs_max.max())
    print(f"[watermarks] controlled |β| peak "
          f"{beta_peak:.2f} steps "
          f"(queue depth {args.queue_depth}); "
          f"trace: {len(trace.events)} events")

    bt, bar = results["bittide"], results["barrier"]
    ok = bt.goodput_tps >= bar.goodput_tps
    print(f"[claim] bittide goodput {bt.goodput_tps:.1f} tok/s "
          f"{'>=' if ok else '<'} barrier {bar.goodput_tps:.1f} tok/s "
          f"-> {'PASS' if ok else 'FAIL'}")
    out = dict(segments=len(pe.result.compiled.segments),
               num_launches=pe.result.num_launches, segment_sum_runs=runs,
               requests=reqs.num_requests, tokens=reqs.total_tokens,
               offered_tps=reqs.offered_load_tps, results=results,
               beta_peak=beta_peak, trace_events=len(trace.events),
               freq_ppm=pe.result.freq_ppm, beta=pe.result.beta,
               claim=bool(ok))

    if not args.no_plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not installed; skipping plot")
        else:
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
            for d in DISCIPLINES:
                lat = np.sort(results[d].latency_s)
                lat = lat[np.isfinite(lat)]
                ax1.plot(lat, np.arange(1, len(lat) + 1) / len(lat),
                         label=d)
                sched = pe.schedule(d, disc)
                ax2.plot(sched.times, sched.rate, label=d)
            ax1.set_xlabel("latency (s)")
            ax1.set_ylabel("CDF")
            ax1.legend()
            ax2.set_xlabel("time (s)")
            ax2.set_ylabel("global step rate")
            ax2.legend()
            fig.suptitle("serving under stragglers: pacing disciplines")
            fig.tight_layout()
            fig.savefig("serve_bittide.png", dpi=120)
            print("[plot] serve_bittide.png")

    if not ok:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
