"""BittideNetwork — the user-facing facade of the core library.

Port of ``repro.core.network``.  Bundles a topology, physical link
parameters, and oscillator population; ``sync()`` runs the clock-control
simulation on the segment-sum lane, checks convergence, applies
reframing, and returns the LogicalSynchronyNetwork that applications
schedule against; ``run_scenario()`` runs a dynamic-event scenario on any
engine of :func:`repro_torch.scenarios.run_scenario`.  Both run on the
CUDA card unless the network was built with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch._device import resolve_device

from . import latency as latency_lib
from .controller import ControllerConfig
from .frame_model import (OMEGA_NOM, LinkParams, SimConfig, SimResult,
                          make_links, simulate)
from .reframing import reframe
from .schedule import LogicalSynchronyNetwork
from .topology import Topology

__all__ = ["OscillatorSpec", "BittideNetwork", "SyncOutcome"]


@dataclasses.dataclass(frozen=True)
class OscillatorSpec:
    """Oscillator population model (paper §3.1: Skyworks SI5395J-A).

    initial_ppm: ±8 ppm initial accuracy -> sampled uniform.
    envelope_ppm: ±98 ppm absolute worst-case envelope (temperature etc.).
    """

    initial_ppm: float = 8.0
    envelope_ppm: float = 98.0
    seed: int = 0

    def sample(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        ppm = rng.uniform(-self.initial_ppm, self.initial_ppm, n)
        return np.clip(ppm, -self.envelope_ppm, self.envelope_ppm)


@dataclasses.dataclass
class SyncOutcome:
    sim: SimResult
    lsn: LogicalSynchronyNetwork
    converged: bool
    convergence_time_s: float
    freq_spread_ppm: float


@dataclasses.dataclass
class BittideNetwork:
    """A network of oscillators and links.  ``device`` is where its runs
    go: None means the CUDA card (and raises without one), ``"cpu"`` runs
    the plain PyTorch versions."""

    topo: Topology
    links: LinkParams
    ppm_u: np.ndarray
    omega_nom: float = OMEGA_NOM
    device: object = None

    @classmethod
    def build(cls, topo: Topology, cable_m=2.0,
              osc: Optional[OscillatorSpec] = None,
              omega_nom: float = OMEGA_NOM, *,
              device=None) -> "BittideNetwork":
        resolve_device(device)
        osc = osc or OscillatorSpec()
        links = make_links(topo, cable_m=cable_m, omega_nom=omega_nom)
        return cls(topo=topo, links=links, ppm_u=osc.sample(topo.num_nodes),
                   omega_nom=omega_nom, device=device)

    def sync(self, ctrl: Optional[ControllerConfig] = None,
             cfg: Optional[SimConfig] = None,
             band_ppm: float = 1.0) -> SyncOutcome:
        ctrl = ctrl or ControllerConfig(kind="proportional", kp=2e-8)
        cfg = cfg or SimConfig(dt=1e-4, steps=20_000, record_every=20)
        sim = simulate(self.topo, self.links, ctrl, self.ppm_u, cfg,
                       device=self.device)
        spread = float(sim.freq_ppm[-1].max() - sim.freq_ppm[-1].min())
        tconv = sim.convergence_time(band_ppm)
        converged = bool(np.isfinite(tconv) and spread <= band_ppm)
        if converged and sim.beta.size:
            # Reframing recenters the real 32-deep buffers to half-full + 2:
            # λ = absolute occupancy (16 + normalized target) + in-flight.
            rf = reframe(sim, target=2.0)
            lam = np.rint(16.0 + rf.occupancy_after +
                          np.asarray(self.links.latency_s) * self.omega_nom
                          ).astype(np.int64)
        else:
            lam = latency_lib.logical_latency(self.topo, self.links,
                                              self.omega_nom)
        lsn = LogicalSynchronyNetwork(topo=self.topo, lam=lam)
        return SyncOutcome(sim=sim, lsn=lsn, converged=converged,
                           convergence_time_s=tconv, freq_spread_ppm=spread)

    def run_scenario(self, scenario, ctrl: Optional[ControllerConfig] = None,
                     cfg: Optional[SimConfig] = None, options=None,
                     telemetry=None, **kw):
        """Run a dynamic-event scenario (cable swaps, drift ramps, holdover,
        link outages, pointer rotations) against this network — the
        paper's §5.6 live fiber-insertion experiment generalized to any
        event sequence.

        ``options=`` takes a :class:`repro_torch.kernels.EngineOptions`
        (``engine="per-step"`` runs the per-step kernel);
        ``telemetry=Telemetry(guard=True)`` (or a
        :class:`repro_torch.core.reframing.ReframePolicy`) enables
        closed-loop buffer re-centering.  Delegates to
        :func:`repro_torch.scenarios.run_scenario` on this network's
        device; returns its ScenarioResult (``.lam`` holds the
        per-segment logical-latency tables whose differences are the
        Table-2 RTT shifts; ``.reframes`` the applied rotations).
        """
        # Deferred import: repro_torch.scenarios composes on top of core.
        from repro_torch.scenarios import run_scenario as _run_scenario
        ctrl = ctrl or ControllerConfig(kind="proportional", kp=2e-8)
        cfg = cfg or SimConfig(dt=1e-4, steps=20_000, record_every=20)
        return _run_scenario(self.topo, self.links, ctrl, self.ppm_u,
                             scenario, cfg, options=options,
                             telemetry=telemetry, device=self.device, **kw)
