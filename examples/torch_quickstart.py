"""Quickstart on the PyTorch port: synchronize an 8-node bittide network
and read out its logical synchrony network (``examples/quickstart.py``
on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.  ``sync`` runs
the segment-sum lane: the eager period loop, no hand-written kernel.
"""
import argparse

import numpy as np

from repro_torch._device import device_name, resolve_device
from repro_torch.core import (BittideNetwork, ControllerConfig,
                              OscillatorSpec, SimConfig, fully_connected)
from repro_torch.core.latency import rtt_table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    # 8 FPGA-node analog: fully connected, ±8 ppm oscillators, 2 m cables.
    net = BittideNetwork.build(fully_connected(8), cable_m=2.0,
                               osc=OscillatorSpec(initial_ppm=8.0, seed=0),
                               device=dev)
    print("unadjusted oscillator offsets (ppm):", np.round(net.ppm_u, 2))

    # Realistic controller settings (paper §5.7): converge in < 300 ms.
    outcome = net.sync(
        ctrl=ControllerConfig(kind="discrete", kp=2e-8, fs=1e-7,
                              pulses_per_update=50),
        cfg=SimConfig(dt=5e-5, steps=10_000, record_every=20,
                      quantize_beta=True))

    print(f"converged: {outcome.converged} "
          f"in {outcome.convergence_time_s*1e3:.0f} ms "
          f"(final spread {outcome.freq_spread_ppm:.3f} ppm)")

    # The logical synchrony network: what applications schedule against.
    lsn = outcome.lsn
    table = rtt_table(lsn.topo, net.links)
    print("\nround-trip logical latencies per node (Table 1 analog):")
    for node, rtts in table.items():
        print(f"  node {node}: {rtts}")

    lam01 = lsn.latency(0, 1)
    print(f"\nlogical latency 0->1 = {lam01} localticks — constant forever;"
          "\na frame sent at sender tick t is consumed at receiver tick "
          f"t + {lam01}, schedulable before any code runs.")
    return dict(ppm_u=net.ppm_u, converged=outcome.converged,
                convergence_time_s=outcome.convergence_time_s,
                freq_spread_ppm=outcome.freq_spread_ppm, rtt_table=table,
                lam=lsn.lam, latency_0_1=lam01,
                freq_ppm=outcome.sim.freq_ppm, times=outcome.sim.times)


if __name__ == "__main__":
    main()
