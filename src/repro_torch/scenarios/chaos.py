"""Chaos campaigns: randomized per-draw fault injection with triage.

Port of ``repro.scenarios.chaos`` (numpy on the host around the port's
``run_scenario``).  ``ChaosCampaign.run`` takes ``device=`` like every
entry point of the port (None means the CUDA card), and a shrunk repro
replays on the device its campaign ran on.

A chaos campaign asks the robustness question behind the paper's control
claims: across a *distribution* of faults — frequency steps of random
size on random victims, drift ramps, cable re-splices, holdovers, link
partitions — does every disturbed system stay inside its closed-form
occupancy envelope, inside its physical buffer, or at least get rescued
by the reframing subsystem?

The pipeline:

  samplers ──► one per-draw Scenario ──► ONE engine runs all
  B draws ──► per-draw oracle checks ──► triage verdicts + shrink

* **Samplers** (:class:`FreqStepSampler`, :class:`DriftRampSampler`,
  :class:`LatencyStepSampler`, :class:`HoldoverSampler`,
  :class:`LinkDropSampler`) draw per-draw event parameters from a seeded
  ``numpy`` Generator and emit ordinary ``repro_torch.scenarios`` events
  whose magnitudes/victims are per-draw arrays (see
  ``repro_torch.scenarios.events`` — "Per-draw (chaos-campaign)
  parameters").

* **One build, B scenarios**: the scenario compiler lowers the
  per-draw parameters to (B, ·) data arrays, so the batch runs through
  ONE engine — segment-sum, a dense kernel lane, or the sparse ELL lane —
  with no new kernel build, exactly like a homogeneous ensemble.
  ``scenario.draw(b)`` recovers draw b as a standalone single-run
  scenario that replays bit-identically.

* **Oracle checks** (:func:`triage_result`): every draw's β record is
  checked hypothesis-style against its own composite closed-form
  envelope (``repro_torch.core.envelopes``) with a defensible slack, and
  against the physical buffer wall ``depth/2`` — the simulator has no
  hard wall, so a crossing means the telemetry past it is *nonphysical*
  and the draw is flagged, never silently simulated through.

* **Triage**: each draw gets exactly one verdict —

    ``OVERFLOW``             per-edge occupancy estimate crossed the
                             buffer wall (checked first: an overflowed
                             draw's record is nonphysical, so no other
                             claim about it is meaningful);
    ``RESCUED-BY-REFRAME``   the per-draw auto-reframe guard rotated
                             this draw's pointers; the rotation
                             recenters occupancy, which invalidates the
                             open-loop envelope claim, so the envelope
                             check is skipped (margin is NaN) — survival
                             is credited to the reframing subsystem;
    ``ENVELOPE-VIOLATION``   the record left the composite envelope;
    ``PASS``                 inside the envelope, inside the buffer.

* **Shrink-to-repro**: :meth:`CampaignResult.shrink` exports a failing
  draw as a :class:`ShrunkRepro` — single-draw scenario + oscillator row
  + engine/config — whose :meth:`ShrunkRepro.run` reproduces the
  verdict standalone (the property-testing "shrink" step, minus the
  search: per-draw isolation already localizes the failure).

Envelope hypothesis, per draw: events are folded into additive terms

    |b(t) − (b_pre + Σ_j db_inf_j)| ≤ Σ_j amp_j·e^{−σ_j(t−t_j)} + slack

checked on the tail t ≥ t_last (after the last event settles the claim
is exact; mid-scenario excursions are the amp terms' job).  FreqStep and
DriftRamp (as its total-drift step at ``t_end``) map to
:func:`repro_torch.core.envelopes.freq_step_envelopes`; LatencyStep to
``latency_step_envelopes``; holdover-reset and link drop/restore have no
tight closed form, so they are charged a conservative freq-step-shaped
term of 2·ν_bound at the affected nodes — the "guard band" part of the
hypothesis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.controller import ControllerConfig
from repro_torch.core.envelopes import (freq_step_envelopes, laplacian,
                                        latency_step_envelopes)
from repro_torch.core.frame_model import (PIPE_FRAMES, SIGNAL_VELOCITY,
                                          LinkParams, SimConfig, make_links)
from repro_torch.core.topology import Topology
from repro_torch.kernels.api import EngineOptions, resolve_options
from repro_torch.telemetry import Telemetry, coerce_trace
from repro_torch.telemetry.api import resolve_telemetry

from .events import (DriftRamp, FreqStep, LatencyStep, LinkDrop,
                     LinkRestore, NodeHoldover, NodeReset, Scenario)
from .runner import ScenarioResult, run_scenario

__all__ = [
    "VERDICT_PASS", "VERDICT_ENVELOPE", "VERDICT_OVERFLOW",
    "VERDICT_RESCUED",
    "FreqStepSampler", "DriftRampSampler", "LatencyStepSampler",
    "HoldoverSampler", "LinkDropSampler",
    "ChaosCampaign", "CampaignResult", "ShrunkRepro", "triage_result",
]

VERDICT_PASS = "PASS"
VERDICT_ENVELOPE = "ENVELOPE-VIOLATION"
VERDICT_OVERFLOW = "OVERFLOW"
VERDICT_RESCUED = "RESCUED-BY-REFRAME"


# --------------------------------------------------------------------------
# Event samplers
# --------------------------------------------------------------------------

def _victim_rows(rng, count: int, k: int,
                 num_draws: int) -> Tuple[Tuple[int, ...], ...]:
    """B per-draw victim tuples, k distinct ids each from range(count)."""
    return tuple(
        tuple(int(v) for v in rng.choice(count, size=k, replace=False))
        for _ in range(num_draws))


def _signed(rng, lo: float, hi: float, num_draws: int) -> np.ndarray:
    """(B,) magnitudes uniform in [lo, hi] with random sign."""
    return (rng.uniform(lo, hi, num_draws)
            * rng.choice(np.array([-1.0, 1.0]), num_draws))


@dataclasses.dataclass(frozen=True)
class FreqStepSampler:
    """Per-draw oscillator step: random victims, random signed ppm."""

    t: float
    ppm_range: Tuple[float, float] = (0.05, 0.5)
    victims: int = 1

    def sample(self, rng, topo: Topology, num_draws: int):
        lo, hi = self.ppm_range
        return (FreqStep(
            t=self.t,
            nodes=_victim_rows(rng, topo.num_nodes, self.victims, num_draws),
            delta_ppm=_signed(rng, lo, hi, num_draws)),)


@dataclasses.dataclass(frozen=True)
class DriftRampSampler:
    """Per-draw thermal drift: random victims, random signed ppm/s slope."""

    t: float
    t_end: float
    rate_range: Tuple[float, float] = (0.1, 1.0)
    victims: int = 1

    def sample(self, rng, topo: Topology, num_draws: int):
        lo, hi = self.rate_range
        return (DriftRamp(
            t=self.t, t_end=self.t_end,
            nodes=_victim_rows(rng, topo.num_nodes, self.victims, num_draws),
            rate_ppm_per_s=_signed(rng, lo, hi, num_draws)),)


@dataclasses.dataclass(frozen=True)
class LatencyStepSampler:
    """Per-draw cable re-splice on a SHARED edge set.

    Every draw swaps the same directed edges (so the dense lanes'
    column-signature latency classes stay at C′ ≤ 2·C) but to its own
    random cable length in ``cable_range`` meters.
    """

    t: float
    edges: Tuple[int, ...]
    cable_range: Tuple[float, float] = (5.0, 100.0)
    reestablish: bool = False

    def sample(self, rng, topo: Topology, num_draws: int):
        lo, hi = self.cable_range
        cable = rng.uniform(lo, hi, (num_draws, len(self.edges)))
        return (LatencyStep(t=self.t, edges=tuple(self.edges),
                            cable_m=cable, reestablish=self.reestablish),)


@dataclasses.dataclass(frozen=True)
class HoldoverSampler:
    """Per-draw clock holdover: random victims freeze at ``t``, rejoin at
    ``t_reset`` (same victims for the NodeReset)."""

    t: float
    t_reset: float
    victims: int = 1

    def sample(self, rng, topo: Topology, num_draws: int):
        nodes = _victim_rows(rng, topo.num_nodes, self.victims, num_draws)
        return (NodeHoldover(t=self.t, nodes=nodes),
                NodeReset(t=self.t_reset, nodes=nodes))


@dataclasses.dataclass(frozen=True)
class LinkDropSampler:
    """Per-draw link partition: random bidirectional link pairs drop at
    ``t`` and heal at ``t_restore``.

    Each draw picks ``drops`` directed edges; the reverse edge of each is
    dropped too (a severed cable kills both directions).  Per-draw edge
    weights change the adjacency itself, so campaigns using this sampler
    run on the segment-sum engine or the sparse ELL lane (whose slot
    tables carry per-draw weights as traced data); the dense lanes
    reject them.
    """

    t: float
    t_restore: float
    drops: int = 1
    reestablish: bool = True

    def sample(self, rng, topo: Topology, num_draws: int):
        rev = np.asarray(topo.reverse_edge_index())
        rows = []
        for _ in range(num_draws):
            picks = rng.choice(topo.num_edges, size=self.drops,
                               replace=False)
            rows.append(tuple(sorted({int(e) for p in picks
                                      for e in (p, rev[p])})))
        edges = tuple(rows)
        return (LinkDrop(t=self.t, edges=edges),
                LinkRestore(t=self.t_restore, edges=edges,
                            reestablish=self.reestablish))


# --------------------------------------------------------------------------
# Envelope hypothesis + triage
# --------------------------------------------------------------------------

def _event_rows(ev, num_draws: int, num_nodes: int,
                values: np.ndarray) -> np.ndarray:
    """(B, N) per-draw rows: draw b gets values[b] on its victim nodes."""
    rows = np.zeros((num_draws, num_nodes), np.float64)
    vals = np.broadcast_to(np.asarray(values, np.float64).reshape(-1),
                           (num_draws,))
    for b in range(num_draws):
        rows[b, list(ev.draw(b).nodes)] = vals[b]
    return rows


def _dst_rows(topo: Topology, edges, num_draws: int,
              value: float) -> np.ndarray:
    """(B, N) rows with ``value`` at the destination nodes of per-draw
    (or shared) ``edges`` — the conservative victims of a link event."""
    dst = np.asarray(topo.dst)
    rows = np.zeros((num_draws, topo.num_nodes), np.float64)
    per_draw = bool(edges) and isinstance(edges[0], tuple)
    for b in range(num_draws):
        idx = list(edges[b] if per_draw else edges)
        rows[b, dst[idx]] = value
    return rows


def _composite_envelope(res: ScenarioResult, nu_bound: float):
    """Fold the scenario's events into additive per-draw envelope terms.

    Returns ``(terms, t_first, t_last, slack)`` where ``terms`` is a list
    of ``(t_j, BatchedEnvelope)``, ``t_first``/``t_last`` bracket the
    event window, and ``slack`` is the (B,) additive slack charged once
    for the state-dependent leftovers (ν·ω·l coupling, second-order
    controller terms, record-grid sampling of each step, float32
    telemetry) — :func:`repro_torch.core.envelopes.default_slack` vectorized
    over the batch and summed over terms.
    """
    topo, cfg, ctrl = res.topo, res.cfg, res.ctrl
    num_draws = res.freq_ppm.shape[0] if res.freq_ppm.ndim == 3 else 1
    n = topo.num_nodes
    kp = float(np.max(np.asarray(ctrl.kp)))
    conservative_ppm = 2.0 * nu_bound * 1e6

    # Rolling per-draw latency table: LatencyStep Δl is measured against
    # the latencies live at the event time, not the t=0 base.
    lat = np.broadcast_to(
        np.asarray(res.links.latency_s, np.float64),
        (num_draws, topo.num_edges)).copy()

    terms = []
    t_first, t_last = np.inf, 0.0
    events = sorted(res.scenario.events, key=lambda e: e.t)
    for ev in events:
        if isinstance(ev, FreqStep):
            rows = _event_rows(ev, num_draws, n, ev.delta_ppm)
            terms.append((ev.t, freq_step_envelopes(
                topo, kp, cfg.dt, rows, cfg.omega_nom)))
            t_j = ev.t
        elif isinstance(ev, DriftRamp):
            total = (np.broadcast_to(
                np.asarray(ev.rate_ppm_per_s, np.float64).reshape(-1),
                (num_draws,)) * (ev.t_end - ev.t))
            rows = _event_rows(ev, num_draws, n, total)
            # The ramp's endpoint equals a step of the total drift; the
            # gradual transient is dominated by the step transient, so
            # the step envelope anchored at t_end bounds the tail.
            terms.append((ev.t_end, freq_step_envelopes(
                topo, kp, cfg.dt, rows, cfg.omega_nom)))
            t_j = ev.t_end
        elif isinstance(ev, LatencyStep):
            idx = list(ev.edges)
            new = np.atleast_2d(ev.new_latency_s(
                cfg.omega_nom, SIGNAL_VELOCITY, PIPE_FRAMES))
            new = np.broadcast_to(new, (num_draws, len(idx)))
            dl = new - lat[:, idx]
            terms.append((ev.t, latency_step_envelopes(
                topo, kp, cfg.dt, idx, dl, nu_bound, cfg.omega_nom)))
            lat[:, idx] = new
            t_j = ev.t
        elif isinstance(ev, NodeReset):
            # No tight closed form for a node rejoining after holdover:
            # charge a freq-step-shaped term of 2·ν_bound at the victims
            # (the largest relative-frequency error a rejoin can carry).
            rows = _event_rows(ev, num_draws, n,
                               np.full(num_draws, conservative_ppm))
            env = freq_step_envelopes(topo, kp, cfg.dt, rows, cfg.omega_nom)
            terms.append((ev.t, dataclasses.replace(
                env, db_inf=np.zeros_like(env.db_inf))))
            t_j = ev.t
        elif isinstance(ev, (LinkDrop, LinkRestore)):
            # Same conservative charge at the endpoints of the affected
            # links (topology changes redistribute occupancy there).
            rows = _dst_rows(topo, ev.edges, num_draws, conservative_ppm)
            env = freq_step_envelopes(topo, kp, cfg.dt, rows, cfg.omega_nom)
            terms.append((ev.t, dataclasses.replace(
                env, db_inf=np.zeros_like(env.db_inf))))
            t_j = ev.t
        else:   # NodeHoldover, Reframe, Mark, … — push the window only
            t_j = ev.t
        t_first = min(t_first, ev.t)
        t_last = max(t_last, t_j)

    lat_frames_max = float(lat.max()) * cfg.omega_nom
    rec = cfg.dt * cfg.record_every
    slack = np.full(num_draws, 1e-4)
    for _, env in terms:
        slack += (env.a_max * env.amp
                  + env.amp * (1.0 - np.exp(-env.sigma * rec)))
    if terms:
        # ν·ω·l in-flight coupling, charged once (λ_max as degree proxy —
        # the same charge default_slack makes for a single event).
        slack += terms[0][1].lam_max * nu_bound * lat_frames_max
    if not np.isfinite(t_first):
        t_first = t_last = 0.0
    return terms, float(t_first), float(t_last), slack


def _net_from_edges(topo: Topology, beta_edges: np.ndarray,
                    edge_w) -> np.ndarray:
    """(B, T, N) per-node net occupancy from a (B, T, E) per-edge record
    (per-draw (B, E) weights supported — chaos LinkDrop victims)."""
    w = np.asarray(edge_w, np.float64)
    contrib = np.asarray(beta_edges, np.float64) * (
        w[:, None, :] if w.ndim == 2 else w)
    fold = np.zeros((topo.num_edges, topo.num_nodes))
    fold[np.arange(topo.num_edges), np.asarray(topo.dst)] = 1.0
    return contrib @ fold


def _peak_edge_occupancy(res: ScenarioResult) -> np.ndarray:
    """(B,) max |β̂_e| over every record and LIVE edge, per draw.

    Segment-sum records are per-edge, so the peak is exact; the dense
    lanes record the per-node net, so the peak is the graph-consistent
    per-edge estimate (Laplacian-pinv node potentials differenced along
    edges — the same reconstruction the auto-reframe guard watches).
    Weight-0 (severed) edges are excluded per segment: a dropped link
    has no buffer to overflow.  Per-draw (B, E) weights (LinkDrop
    victims) on a per-node record take each draw's own Laplacian; the
    reference applies one shared Laplacian there and fails on the (B, E)
    shape.
    """
    comp = res.compiled
    topo = res.topo
    beta = np.asarray(res.beta, np.float64)
    if beta.ndim == 2:
        beta = beta[None]
    b = beta.shape[0]
    per_edge = beta.shape[-1] == topo.num_edges
    peaks = np.zeros(b)
    pinv_cache = {}
    src, dst = np.asarray(topo.src), np.asarray(topo.dst)
    for seg in comp.segments:
        sl = slice(seg.start_record, seg.start_record + seg.records)
        w = np.asarray(seg.edge_w, np.float64)
        if per_edge:
            live = (w > 0)[:, None, :] if w.ndim == 2 else (w > 0)
            vals = np.where(live if w.ndim == 2 else live[None, None],
                            np.abs(beta[:, sl]), 0.0)
            peaks = np.maximum(peaks, vals.max(axis=(1, 2)))
        elif w.ndim == 2:
            pinvs = _per_draw_pinvs(topo, w, pinv_cache)
            for bi in range(b):
                pot = beta[bi, sl] @ pinvs[bi].T
                est = np.abs(pot[:, src] - pot[:, dst])[:, w[bi] > 0]
                peaks[bi] = max(peaks[bi], est.max())
        else:
            key = w.tobytes()
            if key not in pinv_cache:
                pinv_cache[key] = np.linalg.pinv(laplacian(topo, w))
            pot = beta[:, sl] @ pinv_cache[key].T
            est = np.abs(pot[..., src] - pot[..., dst])[..., w > 0]
            peaks = np.maximum(peaks, est.max(axis=(1, 2)))
    return peaks


def _per_draw_pinvs(topo: Topology, w: np.ndarray, cache: dict) -> list:
    """Laplacian pseudo-inverses of the (B, E) weight rows, one per draw,
    computed once per distinct row (batched; through the symmetric
    eigendecomposition when every new Laplacian is symmetric, as it is
    when a link drops in both directions)."""
    keys = [row.tobytes() for row in w]
    new = {k: i for i, k in enumerate(keys) if k not in cache}
    if new:
        laps = np.stack([laplacian(topo, w[i]) for i in new.values()])
        sym = bool(np.array_equal(laps, laps.transpose(0, 2, 1)))
        for k, pinv in zip(new, np.linalg.pinv(laps, hermitian=sym)):
            cache[k] = pinv
    return [cache[k] for k in keys]


def _reframed_rows(res: ScenarioResult, num_draws: int) -> np.ndarray:
    """(B,) bool — which draws the auto-reframe guard actually rotated."""
    out = np.zeros(num_draws, bool)
    for r in res.reframes:
        if not r.auto:
            continue
        sh = np.asarray(r.shift)
        if sh.ndim == 2:
            out |= (sh != 0).any(axis=1)
        else:
            out |= (sh != 0).any()
    return out


def triage_result(res: ScenarioResult, depth: int = 32,
                  nu_bound: Optional[float] = None):
    """Classify every draw of a β-recorded scenario run.

    Args:
      res: a ``run_scenario`` result with β telemetry (any engine; a
        single-run result is treated as a one-draw batch).
      depth: elastic-buffer depth in frames; the wall is ``depth/2``.
      nu_bound: |ν| bound used by the envelope hypothesis; default is
        the recorded max |freq_ppm|·1e-6 (covers drift and steps, since
        the record includes them).

    Returns:
      ``(verdicts, margins, peaks, reframed)`` — per-draw verdict
      strings, envelope margins in frames (NaN where the envelope claim
      does not apply: overflowed or reframed draws), peak per-edge
      occupancy estimates, and the guard-rescue flags.
    """
    if res.beta.shape[-1] == 0:
        raise ValueError("triage needs β telemetry: run the scenario "
                         "with record_beta=True")
    freq = np.asarray(res.freq_ppm)
    num_draws = freq.shape[0] if freq.ndim == 3 else 1
    if nu_bound is None:
        nu_bound = float(np.abs(freq).max()) * 1e-6
    terms, t_first, t_last, slack = _composite_envelope(res, nu_bound)

    # Per-node net occupancy record, whatever the engine recorded.
    beta = np.asarray(res.beta, np.float64)
    if beta.ndim == 2:
        beta = beta[None]
    if beta.shape[-1] == res.topo.num_edges:
        net = np.concatenate([
            _net_from_edges(res.topo, beta[:, sl], seg.edge_w)
            for seg, sl in ((s, slice(s.start_record,
                                      s.start_record + s.records))
                            for s in res.compiled.segments)], axis=1)
    else:
        net = beta

    times = np.asarray(res.times, np.float64)
    pre = times < t_first - 1e-12
    b_pre = (net[:, pre][:, -1] if pre.any()
             else np.zeros((num_draws, net.shape[-1])))
    tail = times >= t_last - 1e-12
    db_tot = b_pre + sum((env.db_inf for _, env in terms),
                         np.zeros((num_draws, net.shape[-1])))
    dev = np.abs(net[:, tail] - db_tot[:, None, :])
    bound = np.broadcast_to(slack[:, None], (num_draws, int(tail.sum()))) \
        .astype(np.float64).copy()
    for t_j, env in terms:
        bound += (env.amp[:, None]
                  * np.exp(-env.sigma[:, None]
                           * np.maximum(times[tail][None, :] - t_j, 0.0)))
    margins = (bound[:, :, None] - dev).min(axis=(1, 2))

    peaks = _peak_edge_occupancy(res)
    reframed = _reframed_rows(res, num_draws)

    wall = depth / 2.0
    verdicts = np.empty(num_draws, object)
    for b in range(num_draws):
        if peaks[b] > wall:
            verdicts[b] = VERDICT_OVERFLOW
        elif reframed[b]:
            verdicts[b] = VERDICT_RESCUED
        elif margins[b] < 0.0:
            verdicts[b] = VERDICT_ENVELOPE
        else:
            verdicts[b] = VERDICT_PASS
    out_margins = np.where(
        [v in (VERDICT_OVERFLOW, VERDICT_RESCUED) for v in verdicts],
        np.nan, margins)
    return verdicts, out_margins, peaks, reframed


# --------------------------------------------------------------------------
# Campaign
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShrunkRepro:
    """A failing draw exported as a standalone single-run repro.

    ``scenario`` is ``campaign_scenario.draw(b)`` — every per-draw
    parameter scalarized to draw b's value — and ``ppm_u`` is draw b's
    oscillator row, so :meth:`run` replays exactly the batch slice and
    must reproduce ``expected_verdict``.
    """

    topo: Topology
    links: LinkParams
    ctrl: ControllerConfig
    ppm_u: np.ndarray
    scenario: Scenario
    cfg: SimConfig
    engine: str
    auto_reframe: object
    depth: int
    expected_verdict: str
    draw_index: int
    device: object = None

    def run(self) -> str:
        """Replay the repro on :attr:`device`; returns its verdict (and
        asserts nothing — callers compare against
        :attr:`expected_verdict`)."""
        res = run_scenario(self.topo, self.links, self.ctrl, self.ppm_u,
                           self.scenario, self.cfg,
                           options=EngineOptions(engine=self.engine),
                           telemetry=Telemetry(beta=True,
                                               guard=self.auto_reframe),
                           device=self.device)
        verdicts, _, _, _ = triage_result(res, depth=self.depth)
        return str(verdicts[0])

    @property
    def reproduces(self) -> bool:
        return self.run() == self.expected_verdict


@dataclasses.dataclass
class CampaignResult:
    """Per-draw triage of one chaos campaign.

    ``verdicts``/``margins``/``peaks``/``reframed`` are (B,) arrays (see
    :func:`triage_result`); ``result`` is the underlying batched
    :class:`~repro_torch.scenarios.runner.ScenarioResult`; ``device`` the
    device the campaign ran on (its shrunk repros replay there).
    """

    campaign: "ChaosCampaign"
    scenario: Scenario
    ppm_u: np.ndarray
    result: ScenarioResult
    verdicts: np.ndarray
    margins: np.ndarray
    peaks: np.ndarray
    reframed: np.ndarray
    device: object = None

    @property
    def num_draws(self) -> int:
        return len(self.verdicts)

    def counts(self) -> dict:
        order = (VERDICT_PASS, VERDICT_RESCUED, VERDICT_ENVELOPE,
                 VERDICT_OVERFLOW)
        return {v: int((self.verdicts == v).sum()) for v in order}

    def survival_rate(self) -> float:
        """Fraction of draws that stayed physical (not OVERFLOW)."""
        return 1.0 - self.counts()[VERDICT_OVERFLOW] / self.num_draws

    def worst_draw(self) -> int:
        """The draw to debug first: highest buffer peak among OVERFLOW
        draws, else smallest envelope margin."""
        if (self.verdicts == VERDICT_OVERFLOW).any():
            masked = np.where(self.verdicts == VERDICT_OVERFLOW,
                              self.peaks, -np.inf)
            return int(masked.argmax())
        m = np.where(np.isnan(self.margins), np.inf, self.margins)
        return int(m.argmin())

    def shrink(self, b: Optional[int] = None) -> ShrunkRepro:
        """Export draw ``b`` (default: :meth:`worst_draw`) standalone."""
        if b is None:
            b = self.worst_draw()
        c = self.campaign
        return ShrunkRepro(
            topo=c.topo, links=c.links, ctrl=c.ctrl,
            ppm_u=np.asarray(self.ppm_u[b]),
            scenario=self.scenario.draw(b), cfg=c.cfg, engine=c.engine,
            auto_reframe=c.auto_reframe, depth=c.depth,
            expected_verdict=str(self.verdicts[b]), draw_index=int(b),
            device=self.device)

    def summary(self) -> str:
        lines = [f"chaos campaign {self.campaign.name!r}: "
                 f"{self.num_draws} draws, engine={self.result.engine}, "
                 f"{self.result.num_launches} launches"]
        for v, k in self.counts().items():
            lines.append(f"  {v:<20s} {k:6d}  "
                         f"({100.0 * k / self.num_draws:5.1f}%)")
        w = self.worst_draw()
        lines.append(
            f"  worst draw #{w}: {self.verdicts[w]}, "
            f"margin={self.margins[w]:.3f} frames, "
            f"peak |β̂|={self.peaks[w]:.3f} frames "
            f"(wall {self.campaign.depth / 2:.0f})")
        return "\n".join(lines)


@dataclasses.dataclass
class ChaosCampaign:
    """Seeded randomized fault-injection campaign.

    Args:
      topo, ctrl, cfg: system under test (``links`` defaults to uniform
        2 m cables via :func:`repro_torch.core.frame_model.make_links`).
      samplers: event samplers applied in order; their per-draw events
        compile into ONE scenario batch.
      num_draws: campaign size B.
      seed: the single Generator seed — campaigns are reproducible.
      ppm_range: oscillator draws are uniform in ±ppm_range.
      engine: any scenario engine; per-draw LinkDrop victims require
        "segment-sum" or "sparse".
      auto_reframe: forwarded to ``run_scenario`` — False, True, or a
        :class:`repro_torch.core.reframing.ReframePolicy`; with it on, draws
        the guard rescues triage as RESCUED-BY-REFRAME.
      depth: physical elastic-buffer depth in frames (wall = depth/2).
    """

    topo: Topology
    ctrl: ControllerConfig
    samplers: Sequence[object]
    num_draws: int = 256
    seed: int = 0
    ppm_range: float = 0.05
    links: Optional[LinkParams] = None
    cfg: SimConfig = dataclasses.field(
        default_factory=lambda: SimConfig(dt=1e-3, steps=4800,
                                          record_every=24))
    engine: str = "segment-sum"
    auto_reframe: object = False
    depth: int = 32
    name: str = "chaos"

    def __post_init__(self):
        if self.links is None:
            self.links = make_links(self.topo, cable_m=2.0,
                                    omega_nom=self.cfg.omega_nom)

    def build(self) -> Tuple[Scenario, np.ndarray]:
        """Sample the per-draw scenario + oscillator rows (pure host)."""
        rng = np.random.default_rng(self.seed)
        ppm = rng.uniform(-self.ppm_range, self.ppm_range,
                          (self.num_draws, self.topo.num_nodes)) \
            .astype(np.float32)
        events: List[object] = []
        for s in self.samplers:
            events.extend(s.sample(rng, self.topo, self.num_draws))
        scenario = Scenario(events=tuple(events), name=self.name)
        if scenario.num_draws not in (None, self.num_draws):
            raise ValueError(
                f"samplers produced {scenario.num_draws} draws, campaign "
                f"has {self.num_draws}")
        return scenario, ppm

    def run(self, telemetry: Optional[Telemetry] = None,
            options: Optional[EngineOptions] = None, *,
            device=None, record_watermarks: Optional[bool] = None,
            trace=None) -> CampaignResult:
        """Build, simulate (one engine call sequence for all B draws), and
        triage.

        ``telemetry`` (:class:`repro_torch.telemetry.Telemetry`) selects
        what to observe — the campaign always adds the β record (triage
        needs it) and its own ``auto_reframe`` guard unless the caller set
        one.  ``Telemetry.trace`` threads a flight recorder through the
        whole campaign (same contract as ``run_scenario``): the build, the
        batched run (with its engine spans), and one ``chaos_draw``
        verdict event per draw land in a single
        :class:`repro_torch.telemetry.RunTrace`, available as
        ``CampaignResult.result.trace``.  ``Telemetry.watermarks``
        additionally carries the in-kernel O(N) excursion watermarks
        (per-draw: ``result.watermarks[b]``).  ``options``
        (:class:`repro_torch.kernels.EngineOptions`) overrides the
        campaign's ``engine`` field and the runner's chunking.
        ``device``: where to run; None means the CUDA card.  The legacy
        ``record_watermarks=`` / ``trace=`` kwargs keep working with a
        once-per-process :class:`DeprecationWarning`.
        """
        opts = resolve_options(options, "ChaosCampaign.run",
                               default_engine=self.engine)
        tel = resolve_telemetry(telemetry, "ChaosCampaign.run",
                                watermarks=record_watermarks,
                                trace=trace if trace else None)
        tr = coerce_trace(tel.trace, name=f"chaos:{self.name}")
        tel = dataclasses.replace(
            tel, beta=True, trace=tr,
            guard=tel.guard if tel.guard else self.auto_reframe)
        with tr.span("segment", name="chaos-build", draws=self.num_draws):
            scenario, ppm = self.build()
        res = run_scenario(self.topo, self.links, self.ctrl, ppm, scenario,
                           self.cfg, options=opts, telemetry=tel,
                           device=device)
        verdicts, margins, peaks, reframed = triage_result(
            res, depth=self.depth)
        for b in range(self.num_draws):
            tr.event("chaos_draw", draw=int(b), verdict=str(verdicts[b]),
                     margin=float(margins[b]), peak=float(peaks[b]),
                     reframed=bool(reframed[b]))
        return CampaignResult(
            campaign=self, scenario=scenario, ppm_u=ppm, result=res,
            verdicts=verdicts, margins=margins, peaks=peaks,
            reframed=reframed, device=device)
