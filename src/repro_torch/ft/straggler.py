"""Straggler mitigation — the bittide mechanism lifted to step rates.

Port of ``repro.ft.straggler``.  The paper's closing argument (§1.4, §8):
treat independently clocked workers as *related* clock domains and very
deep pipelines become possible without barriers.  Here the "oscillator"
is a worker's step rate (1/step time), the "elastic buffer" is the
activation/gradient queue between neighbors, and the same proportional
controller (eq. 1) paces fast workers down so queues stay bounded —
instead of unbounded queue growth (async) or global barrier stalls (sync).

This runs the port's segment-sum :func:`repro_torch.core.simulate`
verbatim: the dynamics are identical, only the units change (steps
instead of frames).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.frame_model import LinkParams, SimConfig, simulate
from repro_torch.core.topology import Topology

__all__ = ["StragglerReport", "simulate_stragglers"]


@dataclasses.dataclass
class StragglerReport:
    controlled_queue_peak: float      # max |queue excursion| with control
    uncontrolled_queue_peak: float    # same without control
    rate_spread_final: float          # relative step-rate spread, controlled
    throughput_ratio: float           # consensus rate / mean uncontrolled rate
    bounded: bool                     # controlled peak within queue depth


def simulate_stragglers(
    topo: Topology,
    speed_ppm: np.ndarray,          # per-worker step-rate offsets (ppm scale;
                                    # e.g. ±50_000 = ±5% heterogeneity)
    queue_depth: int = 64,
    steps_per_second: float = 10.0, # nominal optimizer steps/s
    duration_s: float = 2000.0,
    kp: float = 5e-3,
    ki: float = 5e-5,               # beyond-paper: the integral term drives
                                    # queue offsets back to the setpoint
                                    # exactly (cf. PID consensus, paper [33])
    seed: int = 0,
    device=None,                    # None: the CUDA card (raises without)
) -> StragglerReport:
    """Run the bittide controller on worker step rates.

    Queue units are *steps* (microbatches); the controller samples queue
    occupancies once per step and slews each worker's issue rate.
    """
    dev = resolve_device(device)
    speed_ppm = np.asarray(speed_ppm, np.float32)
    links = LinkParams(latency_s=np.full(topo.num_edges, 1e-3),
                       beta0=np.zeros(topo.num_edges))
    dt = 1.0 / steps_per_second
    cfg = SimConfig(omega_nom=steps_per_second, dt=dt,
                    steps=int(duration_s / dt), record_every=20, seed=seed)

    ctrl = (ControllerConfig(kind="pi", kp=kp, ki=ki) if ki
            else ControllerConfig(kind="proportional", kp=kp))
    res = simulate(topo, links, ctrl, speed_ppm, cfg, device=dev)
    controlled_peak = float(np.abs(res.beta).max())
    spread = float(res.freq_ppm[-1].max() - res.freq_ppm[-1].min()) * 1e-6

    res_un = simulate(topo, links,
                      ControllerConfig(kind="proportional", kp=0.0),
                      speed_ppm, cfg, device=dev)
    uncontrolled_peak = float(np.abs(res_un.beta).max())

    consensus_rate = 1.0 + res.freq_ppm[-1].mean() * 1e-6
    mean_rate = 1.0 + speed_ppm.mean() * 1e-6
    return StragglerReport(
        controlled_queue_peak=controlled_peak,
        uncontrolled_queue_peak=uncontrolled_peak,
        rate_spread_final=spread,
        throughput_ratio=float(consensus_rate / mean_rate),
        bounded=controlled_peak <= queue_depth / 2,
    )
