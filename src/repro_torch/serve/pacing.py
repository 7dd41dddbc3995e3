"""Worker step pacing from the real bittide ensemble engine.

Port of ``repro.serve.pacing``.  The serving cluster is the paper's
closing picture (§1.4/§8): one model sharded across N workers, every
global decode step needing a step from every worker, with *no shared
clock*.  Per-worker step rates are the oscillators of the frame model
lifted to step time (:mod:`repro_torch.ft.straggler`), so the pacing
trajectories come from the port's engine: ONE
:func:`repro_torch.scenarios.run_scenario` call carries a B=2 ensemble —

* draw 0: the bittide proportional controller closed at gain ``kp`` —
  the logically-synchronous cluster, step rates converging to consensus;
* draw 1: the same oscillator draw at ``kp = 0`` — free-running rates,
  what a barrier'd or async cluster actually has underneath.

Gains are per-draw kernel arguments, so both trajectories run on one
built engine, and mid-serve ``Scenario`` events — straggler FreqStep,
thermal DriftRamp, NodeHoldover, LinkDrop — perturb the serving workers
exactly as the frame model dictates, across segments with no new builds
(``no_new_compiles``).

``engine`` picks the lane: "segment-sum" (the default, the eager torch
loop, β per edge) or a kernel lane — "fused" runs the ensemble on the
``bittide_fused`` kernel, β per node.  The ``async`` discipline reads β,
so its stalls depend on the lane (in the reference as here).

The three pacing disciplines price a global decode step from those
trajectories:

``bittide``   step time = work / min_i(controlled rate_i).  After
              convergence every worker runs at the consensus (≈ mean)
              rate; elastic buffers absorb the residual spread, and per
              the paper's claim the coordination costs ZERO in-band
              overhead per step.
``barrier``   step time = work / min_i(free rate_i) + a barrier
              collective per step.  The cluster is pinned to the
              instantaneous slowest worker AND pays the sync.
``async``     free-running with bounded elastic queues and in-band
              credit flow control: sustained rate is the slowest
              worker's (backpressure), no per-step barrier, but every
              time the fast/slow occupancy divergence crosses another
              half-queue-depth the producer blocks on a credit round
              trip.  The divergence is read off the kp=0 draw's β
              record — unbounded queue growth priced as stall time.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.frame_model import LinkParams, SimConfig
from repro_torch.core.topology import Topology
from repro_torch.kernels.api import EngineOptions
from repro_torch.scenarios import Scenario, ScenarioResult, run_scenario
from repro_torch.telemetry import Telemetry, coerce_trace

__all__ = ["DISCIPLINES", "DisciplineConfig", "PacingSchedule",
           "PacedEnsemble", "pace_workers"]

DISCIPLINES = ("bittide", "barrier", "async")


@dataclasses.dataclass(frozen=True)
class DisciplineConfig:
    """Coordination prices of the non-bittide disciplines.

    barrier_overhead_s: wall-clock cost of the per-step barrier
      collective (≥ one cross-cluster round trip).
    stall_overhead_s: async flow control — one credit round trip each
      time a bounded queue fills and the producer must block.
    queue_depth: elastic queue depth in steps (the async bound, and the
      depth the bittide β envelope is checked against).
    """

    barrier_overhead_s: float = 2e-3
    stall_overhead_s: float = 2e-3
    queue_depth: int = 64


@dataclasses.dataclass(frozen=True)
class PacingSchedule:
    """One discipline's global step-rate timeline, record-granular.

    times: (T,) record times (seconds since serve start).
    rate: (T,) global step-rate multiplier (1.0 = nominal hardware).
    step_overhead_s: fixed in-band coordination cost added to every tick.
    stall_cum_s: (T,) cumulative stall seconds by record — charged by the
      engine as a record boundary is crossed (async queue-full blocks).
    """

    discipline: str
    times: np.ndarray
    rate: np.ndarray
    step_overhead_s: float
    stall_cum_s: np.ndarray

    def record_at(self, t: float) -> int:
        """Record index whose rate governs wall-clock time ``t``."""
        idx = int(np.searchsorted(self.times, t, side="left"))
        return min(idx, len(self.times) - 1)


@dataclasses.dataclass
class PacedEnsemble:
    """The one ensemble run, sliced into pacing trajectories.

    result: the ``ScenarioResult`` — freq_ppm (2, T, N) with draw 0
      controlled / draw 1 free-running; beta (2, T, E) per-edge frames on
      segment-sum, (2, T, N) per-node on the kernel lanes.
    """

    result: ScenarioResult
    steps_per_second: float
    kp: float

    def __post_init__(self):
        if self.result.freq_ppm.ndim != 3 or self.result.freq_ppm.shape[0] != 2:
            raise ValueError("PacedEnsemble needs the (2, T, N) "
                             "controlled/free ensemble from pace_workers")

    @property
    def times(self) -> np.ndarray:
        return self.result.times

    @property
    def num_workers(self) -> int:
        return int(self.result.freq_ppm.shape[2])

    def rates(self, controlled: bool) -> np.ndarray:
        """(T, N) per-worker step-rate multipliers, 1.0 = nominal."""
        row = 0 if controlled else 1
        return 1.0 + self.result.freq_ppm[row].astype(np.float64) * 1e-6

    def queue_record(self, controlled: bool) -> np.ndarray:
        """(T, E) (segment-sum) or (T, N) (kernel lanes) inter-worker
        queue occupancies in steps (β record)."""
        return np.asarray(self.result.beta[0 if controlled else 1],
                          np.float64)

    def schedule(self, discipline: str,
                 disc: DisciplineConfig = DisciplineConfig()
                 ) -> PacingSchedule:
        """Lower one discipline to a record-granular rate timeline."""
        if discipline not in DISCIPLINES:
            raise ValueError(f"unknown discipline {discipline!r}; "
                             f"pick one of {DISCIPLINES}")
        t = np.asarray(self.times, np.float64)
        zeros = np.zeros_like(t)
        if discipline == "bittide":
            # Slowest *logical* clock; post-convergence this IS the
            # consensus rate, and coordination is free in-band.
            return PacingSchedule("bittide", t,
                                  self.rates(controlled=True).min(axis=1),
                                  0.0, zeros)
        rate_free = self.rates(controlled=False).min(axis=1)
        if discipline == "barrier":
            return PacingSchedule("barrier", t, rate_free,
                                  disc.barrier_overhead_s, zeros)
        # async: stalls accrue as the free-running occupancy divergence
        # crosses successive half-depth walls (running max of |β|).
        div = np.abs(self.queue_record(controlled=False)).max(axis=1)
        crossings = np.floor(np.maximum.accumulate(div)
                             / (disc.queue_depth / 2.0))
        return PacingSchedule("async", t, rate_free, 0.0,
                              crossings * disc.stall_overhead_s)


def pace_workers(topo: Topology, speed_ppm: np.ndarray,
                 scenario: Scenario, *,
                 kp: float = 5e-3,
                 steps_per_second: float = 10.0,
                 duration_s: float = 60.0,
                 record_every: int = 10,
                 link_latency_s: float = 1e-3,
                 engine: str = "segment-sum",
                 trace=False,
                 compiled=None,
                 device=None) -> PacedEnsemble:
    """Run the B=2 controlled/free ensemble through ``run_scenario``.

    Args:
      topo: worker interconnect (the sharding neighbor graph).
      speed_ppm: (N,) per-worker step-rate offsets, ppm scale (±50_000 =
        ±5% heterogeneity, as in ``ft.simulate_stragglers``).
      scenario: mid-serve events (straggler steps, drift, holdover, link
        drops) — hits both draws at the same times.
      kp: proportional pacing gain of the controlled draw (draw 1 runs
        the identical oscillators at gain 0).
      steps_per_second: nominal worker step rate; the frame model's
        ``omega_nom`` and ``1/dt``.
      duration_s / record_every: horizon and telemetry decimation.
      engine: the lane — "segment-sum", or a kernel lane ("fused",
        "auto", …) of :class:`repro_torch.kernels.EngineOptions`.
      trace: the flight recorder (``True`` or a ``RunTrace``).
      compiled: reuse a prior ``compile_scenario`` result (warm replays).
      device: where to run; None means the CUDA card (raises without one).

    Returns a :class:`PacedEnsemble`; one built engine serves every event
    segment (gains and event parameters are arguments).
    """
    dev = resolve_device(device)
    speed_ppm = np.asarray(speed_ppm, np.float64).reshape(-1)
    n = topo.num_nodes
    if speed_ppm.shape[0] != n:
        raise ValueError(f"speed_ppm must be ({n},), "
                         f"got {speed_ppm.shape}")
    dt = 1.0 / steps_per_second
    steps = int(round(duration_s / dt))
    cfg = SimConfig(omega_nom=steps_per_second, dt=dt, steps=steps,
                    record_every=record_every)
    links = LinkParams(latency_s=np.full(topo.num_edges, link_latency_s),
                       beta0=np.zeros(topo.num_edges))
    ctrl = ControllerConfig(kind="proportional",
                            kp=np.array([kp, 0.0], np.float32))
    ppm2 = np.tile(speed_ppm.astype(np.float32), (2, 1))
    tr = coerce_trace(trace, name="pace_workers")
    res = run_scenario(topo, links, ctrl, ppm2, scenario, cfg,
                       compiled=compiled,
                       options=EngineOptions(engine=engine),
                       telemetry=Telemetry(beta=True,
                                           trace=tr if tr else False),
                       device=dev)
    tr.event("pacing", workers=n, steps=steps, kp=float(kp),
             engine=res.engine, launches=int(res.num_launches),
             segments=len(res.compiled.segments))
    return PacedEnsemble(result=res, steps_per_second=steps_per_second,
                         kp=float(kp))
