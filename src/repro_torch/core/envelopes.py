"""Closed-form occupancy-envelope oracles for step-response transients.

"Modeling Buffer Occupancy in bittide Systems" (arXiv:2410.05432) shows
that under proportional control the elastic-buffer occupancies respond to
step disturbances with closed-form exponential envelopes set by the graph
Laplacian's spectrum.  This module derives those envelopes for the exact
quantity our dense engines record in-kernel — the **per-node net
occupancy** b_i = Σ_{e→i} w_e·β_e (frames) — and packages them as test
oracles: a recorded transient must stay inside the analytic bound.

Derivation (linearized frame model)
-----------------------------------
One control period of the proportional-controlled frame model (see
``repro_torch.core.frame_model``; Δ = ω·dt frames/period):

    err_i(k)  = Σ_{e→i} w_e·(β_e(k) − β_off)
    ν(k+1)    = ν_u + kp·err(k)                  (+ O(ν_u·kp·err))
    ψ(k+1)    = ψ(k) + Δ·ν(k+1)

With β_e = ψ_src − ν_src·ω·l_e + λeff_e − ψ_dst, the per-node net
occupancy is an affine function of the phase vector:

    b  =  −L·ψ − h + lamsum,       h_i = Σ_{e→i} w_e·ν_src·ω·l_e

where L = D_in − A_in is the weighted in-degree graph Laplacian
(symmetric for the bidirectional topologies bittide runs on — every
builder in ``repro_torch.core.topology`` emits both directed edges of each
physical link).  Dropping the O(ν·ω·l) coupling h (it is folded into the
oracle's ``slack``), the disagreement component ψ⊥ = ψ − mean(ψ)·1
follows the discrete consensus iteration

    ψ⊥(k+1) = (I − Δ·kp·L)·ψ⊥(k) + Δ·ν_u⊥

whose modes contract per period by (1 − Δ·kp·λ_m) for each Laplacian
eigenvalue λ_m > 0.  For 0 < Δ·kp·λ_max ≤ 1 every factor satisfies
0 ≤ 1 − a ≤ e^{−a}, so the continuous-time envelope upper-bounds the
discrete trajectory (the oracles *enforce* this validity condition).

Equilibrium: ν must be uniform, so kp·err_i^∞ = ν̄ − ν_u,i exactly — the
well-known steady-state buffer offset of pure-P consensus control.  A
**frequency step** δν_u (a FreqStep event, in relative units) therefore
moves the net occupancy to a new equilibrium and decays toward it:

    δb_i^∞      = (mean(δν_u) − δν_u,i) / kp                      [frames]
    |b(t) − b^∞|_∞ ≤ (‖δν_u⊥‖₂ / kp) · e^{−σ·(t−t0)} + slack
    σ           = kp·Δ·λ₂ / dt                                    [1/s]

(The amplitude is exact in the linear model: the post-step deviation is
x₀ = −L⁺·δν_u⊥/kp, and ‖L·e^{−kpΔL·k}·x₀‖₂ = ‖e^{−kpΔL·k}·δν_u⊥‖₂/kp
≤ e^{−kpΔλ₂·k}·‖δν_u⊥‖₂/kp, using L·L⁺·v = v for v ⊥ 1.)

A **latency step** that preserves λeff (the plain cable-swap semantics —
occupancy is continuous through the splice, "Buffer Centering for bittide
Synchronization via Frame Rotation", arXiv:2504.07044, gives the λ
accounting) perturbs only the small coupling term h by
Δh_i = Σ_{e→i} w_e·ν_src·ω·Δl_e.  The net-occupancy equilibrium is
*unchanged* up to the uniform −mean(Δh) shift, and the transient envelope
is the same exponential with amplitude ‖Δh⊥‖₂ — the paper's §5.6
observation that the clock network barely notices a 2 km splice, made
quantitative.

Everything the linearization drops — the ν_u·kp·err product, the moving
h(ν) coupling, float32 telemetry rounding, and the O(1-record) sampling
offset of the step time — is absorbed by the oracle's additive ``slack``
(callers pass their own; :func:`default_slack` gives a defensible one).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .frame_model import OMEGA_NOM
from .topology import Topology

__all__ = ["EnvelopeSpec", "BatchedEnvelope", "laplacian", "spectral_gap",
           "freq_step_envelope", "latency_step_envelope",
           "freq_step_envelopes", "latency_step_envelopes",
           "check_occupancy_envelope", "check_occupancy_envelopes",
           "default_slack", "reframe_guard_margin", "reframe_guard_margins"]


@dataclasses.dataclass(frozen=True)
class EnvelopeSpec:
    """A closed-form step-response envelope for per-node net occupancy.

    The claim: for every record time t ≥ t0,

        |b_i(t) − (b_i(t0⁻) + db_inf_i)|  ≤  amp·exp(−sigma·(t−t0)) + slack

    where b(t0⁻) is the converged pre-event telemetry.

    db_inf: (N,) equilibrium shift in frames.
    amp: scalar envelope amplitude in frames (ℓ2 bound over nodes, so it
      bounds every component).
    sigma: decay rate in 1/s (continuous-time upper bound of the
      per-period contraction).
    lam2, lam_max: Laplacian eigenvalues the rates derive from.
    a_max: per-period contraction argument Δ·kp·λ_max; must be ≤ 1 for
      the exponential to upper-bound the discrete iteration.
    """

    db_inf: np.ndarray
    amp: float
    sigma: float
    lam2: float
    lam_max: float
    a_max: float

    def bound(self, times, t0: float, slack: float) -> np.ndarray:
        """(T,) envelope |b − b∞| may not exceed, at ``times`` ≥ t0."""
        dt = np.maximum(np.asarray(times, np.float64) - t0, 0.0)
        return self.amp * np.exp(-self.sigma * dt) + slack


@dataclasses.dataclass(frozen=True)
class BatchedEnvelope:
    """Per-draw closed-form envelopes sharing one Laplacian spectrum.

    The chaos-campaign form of :class:`EnvelopeSpec`: B draws see the
    same topology (so λ₂/λ_max are computed once) but each has its own
    disturbance magnitude and gain — ``db_inf`` is (B, N), ``amp`` /
    ``sigma`` / ``a_max`` are (B,).  The per-draw claim is identical:

        |b_i(t) − (b_i(t0⁻) + db_inf[d, i])|
            ≤ amp[d]·exp(−sigma[d]·(t−t0)) + slack[d]
    """

    db_inf: np.ndarray   # (B, N) frames
    amp: np.ndarray      # (B,) frames
    sigma: np.ndarray    # (B,) 1/s
    lam2: float
    lam_max: float
    a_max: np.ndarray    # (B,)

    @property
    def num_draws(self) -> int:
        return self.db_inf.shape[0]

    def draw(self, b: int) -> EnvelopeSpec:
        """Draw ``b``'s envelope as a plain :class:`EnvelopeSpec`."""
        return EnvelopeSpec(
            db_inf=self.db_inf[b].copy(), amp=float(self.amp[b]),
            sigma=float(self.sigma[b]), lam2=self.lam2,
            lam_max=self.lam_max, a_max=float(self.a_max[b]))


def laplacian(topo: Topology, edge_w=None) -> np.ndarray:
    """(N, N) float64 weighted in-degree graph Laplacian L = D_in − A_in.

    Row i aggregates the edges INTO node i (the controller's error
    aggregation); ``edge_w`` are the scenario's (E,) link weights
    (0 = dropped link).  bittide topologies are bidirectional, so L is
    symmetric whenever the weights are direction-symmetric — the spectral
    envelope derivation assumes it, and :func:`spectral_gap` verifies it.
    """
    n = topo.num_nodes
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    lap = np.zeros((n, n), np.float64)
    np.add.at(lap, (np.asarray(topo.dst), np.asarray(topo.src)), -w)
    np.add.at(lap, (np.asarray(topo.dst), np.asarray(topo.dst)), w)
    return lap


def spectral_gap(lap: np.ndarray) -> tuple[float, float]:
    """(λ₂, λ_max) of a symmetric Laplacian (asserts symmetry, ~1e-9)."""
    if not np.allclose(lap, lap.T, atol=1e-9):
        raise ValueError(
            "Laplacian is not symmetric: the closed-form envelope needs a "
            "bidirectional topology with direction-symmetric edge weights")
    ev = np.linalg.eigvalsh(lap)
    return float(ev[1]), float(ev[-1])


def _rates(topo: Topology, kp: float, dt: float, omega_nom: float,
           edge_w) -> tuple[float, float, float, float]:
    lam2, lam_max = spectral_gap(laplacian(topo, edge_w))
    dt_frames = omega_nom * dt
    a_max = kp * dt_frames * lam_max
    if not 0.0 < a_max <= 1.0:
        raise ValueError(
            f"Δ·kp·λ_max = {a_max:.3g} outside (0, 1]: the per-period "
            "contraction factors 1 − Δ·kp·λ are only bounded by "
            "exp(−Δ·kp·λ) in this regime (lower kp or dt to use the "
            "closed-form envelope)")
    sigma = kp * dt_frames * lam2 / dt
    return lam2, lam_max, a_max, sigma


def freq_step_envelope(topo: Topology, kp: float, dt: float,
                       nodes: Sequence[int], delta_ppm: float,
                       omega_nom: float = OMEGA_NOM,
                       edge_w=None) -> EnvelopeSpec:
    """Envelope for a FreqStep of ``delta_ppm`` on ``nodes`` at t0.

    Args:
      topo: bidirectional network topology.
      kp: proportional gain (relative frequency per frame of error).
      dt: control period in seconds.
      nodes: stepped node ids; delta_ppm: the step in ppm.
      edge_w: (E,) live-link weights at the time of the step.

    Returns an :class:`EnvelopeSpec` whose ``db_inf`` is the exact linear
    equilibrium shift (mean(δν) − δν)/kp and whose amplitude ‖δν⊥‖₂/kp
    bounds the whole transient.
    """
    lam2, lam_max, a_max, sigma = _rates(topo, kp, dt, omega_nom, edge_w)
    dnu = np.zeros(topo.num_nodes, np.float64)
    dnu[list(nodes)] = delta_ppm * 1e-6
    dnu_perp = dnu - dnu.mean()
    return EnvelopeSpec(
        db_inf=-dnu_perp / kp,
        amp=float(np.linalg.norm(dnu_perp) / kp),
        sigma=sigma, lam2=lam2, lam_max=lam_max, a_max=a_max)


def latency_step_envelope(topo: Topology, kp: float, dt: float,
                          edges: Sequence[int], dlat_s,
                          nu_bound: float,
                          omega_nom: float = OMEGA_NOM,
                          edge_w=None) -> EnvelopeSpec:
    """Envelope for a λeff-preserving LatencyStep on ``edges`` at t0.

    Args:
      edges: swapped directed-edge ids; dlat_s: per-edge latency *change*
        in seconds (scalar or one per listed edge; sign-free — the bound
        uses magnitudes).
      nu_bound: bound on |ν| of the senders at the step (relative units;
        e.g. the recorded max |freq_ppm|·1e-6 just before the event).

    The occupancy is continuous through a λeff-preserving swap; only the
    O(ν·ω·Δl) in-flight re-estimate perturbs the error — so the envelope
    amplitude is ‖Δh‖₂ with Δh_i = Σ_{e→i} w_e·ν_src·ω·Δl_e bounded via
    ``nu_bound``, and the equilibrium shift is the uniform −mean(Δh)
    (bounded the same way, folded into the amplitude here).  This is the
    quantitative form of the paper's "the clock network barely notices a
    2 km splice".
    """
    lam2, lam_max, a_max, sigma = _rates(topo, kp, dt, omega_nom, edge_w)
    dl = np.broadcast_to(np.asarray(dlat_s, np.float64), (len(list(edges)),))
    dh = np.zeros(topo.num_nodes, np.float64)
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    dst = np.asarray(topo.dst)
    for k, e in enumerate(edges):
        dh[dst[e]] += w[e] * nu_bound * abs(dl[k]) * omega_nom
    amp = float(np.linalg.norm(dh))
    return EnvelopeSpec(
        # Equilibrium shift is ≤ mean(|Δh|) and sign-uncertain (it depends
        # on the senders' live ν); fold it into the amplitude instead.
        db_inf=np.zeros(topo.num_nodes),
        amp=2.0 * amp,
        sigma=sigma, lam2=lam2, lam_max=lam_max, a_max=a_max)


def _rates_batched(topo: Topology, kp, dt: float, omega_nom: float,
                   edge_w, b: int):
    """Per-draw (kp, λ₂, λ_max, a_max, sigma) with one spectrum solve."""
    lam2, lam_max = spectral_gap(laplacian(topo, edge_w))
    kp = np.broadcast_to(
        np.asarray(kp, np.float64).reshape(-1), (b,)).copy()
    dt_frames = omega_nom * dt
    a_max = kp * dt_frames * lam_max
    if np.any(a_max <= 0.0) or np.any(a_max > 1.0):
        raise ValueError(
            f"Δ·kp·λ_max outside (0, 1] for some draw (range "
            f"[{a_max.min():.3g}, {a_max.max():.3g}]): the closed-form "
            "envelope needs every per-period contraction in this regime")
    sigma = kp * dt_frames * lam2 / dt
    return kp, lam2, lam_max, a_max, sigma


def freq_step_envelopes(topo: Topology, kp, dt: float, delta_ppm,
                        omega_nom: float = OMEGA_NOM,
                        edge_w=None) -> BatchedEnvelope:
    """Per-draw FreqStep envelopes (the batched chaos-campaign oracle).

    Args:
      kp: proportional gain — scalar or (B,) per-draw.
      delta_ppm: (B, N) per-draw ν_u step in ppm, zeros off the victims
        (each draw's own magnitude AND victim set).

    Same math as :func:`freq_step_envelope` per row; the Laplacian
    spectrum is solved once for the batch.
    """
    dnu = np.atleast_2d(np.asarray(delta_ppm, np.float64)) * 1e-6
    if dnu.shape[1] != topo.num_nodes:
        raise ValueError(f"delta_ppm must be (B, {topo.num_nodes}), got "
                         f"{np.shape(delta_ppm)}")
    b = dnu.shape[0]
    kp, lam2, lam_max, a_max, sigma = _rates_batched(
        topo, kp, dt, omega_nom, edge_w, b)
    dperp = dnu - dnu.mean(axis=1, keepdims=True)
    return BatchedEnvelope(
        db_inf=-dperp / kp[:, None],
        amp=np.linalg.norm(dperp, axis=1) / kp,
        sigma=sigma, lam2=lam2, lam_max=lam_max, a_max=a_max)


def latency_step_envelopes(topo: Topology, kp, dt: float,
                           edges: Sequence[int], dlat_s, nu_bound,
                           omega_nom: float = OMEGA_NOM,
                           edge_w=None) -> BatchedEnvelope:
    """Per-draw λeff-preserving LatencyStep envelopes.

    Args:
      edges: swapped directed-edge ids, shared across draws.
      dlat_s: (B, len(edges)) per-draw latency change in seconds
        (sign-free; the bound uses magnitudes).
      nu_bound: scalar or (B,) bound on |ν| of the senders at the step.

    Same math as :func:`latency_step_envelope` per row.
    """
    edges = list(edges)
    dl = np.atleast_2d(np.asarray(dlat_s, np.float64))
    b = dl.shape[0]
    dl = np.broadcast_to(dl, (b, len(edges)))
    kp, lam2, lam_max, a_max, sigma = _rates_batched(
        topo, kp, dt, omega_nom, edge_w, b)
    nub = np.broadcast_to(np.asarray(nu_bound, np.float64).reshape(-1), (b,))
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    dst = np.asarray(topo.dst)
    dh = np.zeros((b, topo.num_nodes), np.float64)
    for k, e in enumerate(edges):
        dh[:, dst[e]] += w[e] * nub * np.abs(dl[:, k]) * omega_nom
    return BatchedEnvelope(
        db_inf=np.zeros((b, topo.num_nodes)),
        amp=2.0 * np.linalg.norm(dh, axis=1),
        sigma=sigma, lam2=lam2, lam_max=lam_max, a_max=a_max)


def default_slack(env: EnvelopeSpec, nu_bound: float, lat_frames_max: float,
                  dt: float, record_every: int,
                  omega_nom: float = OMEGA_NOM) -> float:
    """A defensible additive slack for :func:`check_occupancy_envelope`.

    Covers what the linear envelope drops:
      * the ν·ω·l in-flight coupling (per node ≲ deg·|ν|·ω·l_max — we
        charge ‖·‖₂-style via λ_max as the degree proxy);
      * second-order controller terms, ~a_max·amp relative;
      * one record period of sampling offset of the step time,
        amp·(1 − e^{−σ·rec});
      * float32 telemetry rounding (1e-4 frames absolute headroom).
    """
    rec = dt * record_every
    return (env.lam_max * nu_bound * lat_frames_max
            + env.a_max * env.amp
            + env.amp * (1.0 - np.exp(-env.sigma * rec))
            + 1e-4)


def reframe_guard_margin(topo: Topology, kp: float, dt: float,
                         record_every: int, nu_bound: float,
                         lat_frames_max: float,
                         omega_nom: float = OMEGA_NOM,
                         edge_w=None) -> float:
    """Default guard-band margin for the auto-reframe trigger (frames).

    The closed-loop re-centering subsystem
    (``repro_torch.scenarios.run_scenario(auto_reframe=...)``) trips a pointer
    rotation when the node-normalized in-kernel occupancy record crosses
    ``depth/2 − margin``.  The margin must cover what the *record* can
    understate about the true worst occupancy between inspections —
    exactly the terms :func:`default_slack` charges for a zero-amplitude
    envelope (the ν·ω·l in-flight coupling, second-order controller
    products, float32 telemetry rounding), floored at one frame (the
    quantization granularity of a pointer shift).  Scenarios whose
    disturbances slew the occupancy faster than one frame per record
    chunk should pass a larger margin via
    :class:`repro_torch.core.reframing.ReframePolicy`.
    """
    env = freq_step_envelope(topo, kp, dt, nodes=(), delta_ppm=0.0,
                             omega_nom=omega_nom, edge_w=edge_w)
    return max(1.0, default_slack(env, nu_bound, lat_frames_max, dt,
                                  record_every, omega_nom))


def reframe_guard_margins(topo: Topology, kp, dt: float, record_every: int,
                          nu_bound, lat_frames_max: float,
                          omega_nom: float = OMEGA_NOM,
                          edge_w=None) -> np.ndarray:
    """Per-draw guard-band margins (frames) — the batched
    :func:`reframe_guard_margin`.

    ``kp`` and ``nu_bound`` broadcast to a common (B,) length; each
    draw's margin derives from its OWN gain and disturbance bound, so a
    gain-sweep batch is no longer guarded by one margin computed from
    its stiffest draw (which under-guards the soft draws' larger ν·ω·l
    coupling and over-guards the stiff ones).  Repeated (kp, ν) pairs
    pay the spectral envelope solve once.
    """
    kp_b, nu_b = np.broadcast_arrays(
        np.atleast_1d(np.asarray(kp, np.float64)),
        np.atleast_1d(np.asarray(nu_bound, np.float64)))
    cache: dict = {}
    out = np.empty(kp_b.shape[0], np.float64)
    for i, (k, nu) in enumerate(zip(kp_b, nu_b)):
        key = (float(k), float(nu))
        if key not in cache:
            cache[key] = reframe_guard_margin(
                topo, float(k), dt, record_every, float(nu),
                lat_frames_max, omega_nom, edge_w=edge_w)
        out[i] = cache[key]
    return out


def check_occupancy_envelope(times, beta, t0: float, env: EnvelopeSpec,
                             slack: float,
                             b_pre: Optional[np.ndarray] = None):
    """Verify a recorded per-node net-occupancy transient against an oracle.

    Args:
      times: (T,) record times in seconds.
      beta: (T, N) per-node net occupancy telemetry (frames) — e.g.
        ``DenseResult.beta`` / ``ScenarioResult.beta`` of a dense-lane run.
      t0: event time (seconds).
      env: the closed-form envelope.
      slack: additive slack in frames (see :func:`default_slack`).
      b_pre: (N,) converged pre-event occupancy; default: the last record
        strictly before t0 (REQUIRED in watermark mode, which has no
        record to baseline from).

    ``beta`` may also be in-kernel watermarks
    (:class:`repro_torch.telemetry.Watermarks`, single-draw) instead of a full
    record — the mode that makes envelope checks possible at the sparse
    lane's 10⁶-node scale, where no (R, N) record exists.  The check is
    then the NECESSARY condition at the peak only: each node's recorded
    \\|β\\| maximum, evaluated against the bound at its time-of-peak
    record.  It rejects any run whose peak breaks its node's envelope,
    but — unlike the full-record check — cannot see a non-peak record
    that breaks a tighter (earlier) bound, so a watermark pass is
    one-sided.  Peaks attained before ``t0`` pass vacuously (the
    envelope constrains the post-event transient).

    Returns:
      (ok, margin) — ``margin`` is min over post-event records (or over
      nodes, in watermark mode) of (bound − |b − b∞|); non-negative iff
      the checked deviations stay inside the envelope.
    """
    times = np.asarray(times, np.float64)
    if hasattr(beta, "beta_abs_max"):        # Watermarks, duck-typed
        wm = beta
        if wm.beta_abs_max.ndim != 1:
            raise ValueError("watermark envelope check is single-draw; "
                             "slice a draw first (watermarks[b])")
        if b_pre is None:
            raise ValueError("watermark mode has no pre-event record; "
                             "pass b_pre explicitly")
        t_peak = times[np.asarray(wm.peak_record, np.int64)]
        base = np.abs(np.asarray(b_pre, np.float64)
                      + np.asarray(env.db_inf, np.float64))
        post = t_peak >= t0
        # |β| ≤ |b_pre + b∞| + |β − (b_pre + b∞)| — charge the baseline.
        dev = wm.beta_abs_max[post] - base[post]
        bound = env.bound(t_peak[post], t0, slack)
        margin = float((bound - dev).min()) if post.any() else float(slack)
        return margin >= 0.0, margin
    beta = np.asarray(beta, np.float64)
    if b_pre is None:
        pre = np.nonzero(times < t0)[0]
        if len(pre) == 0:
            raise ValueError("no record before t0 to baseline against; "
                             "pass b_pre explicitly")
        b_pre = beta[pre[-1]]
    post = times >= t0
    dev = np.abs(beta[post] - (np.asarray(b_pre) + env.db_inf)[None, :])
    bound = env.bound(times[post], t0, slack)
    margin = float((bound[:, None] - dev).min())
    return margin >= 0.0, margin


def check_occupancy_envelopes(times, beta, t0: float, env: BatchedEnvelope,
                              slack, b_pre: Optional[np.ndarray] = None):
    """Per-draw form of :func:`check_occupancy_envelope`.

    Args:
      times: (T,) record times in seconds.
      beta: (B, T, N) per-draw per-node net occupancy telemetry (frames).
      t0: event time (shared — campaign events are simultaneous).
      env: per-draw envelopes.
      slack: scalar or (B,) additive slack in frames.
      b_pre: (B, N) converged pre-event occupancy; default: the last
        record strictly before t0, per draw.

    Returns:
      (ok (B,) bool, margin (B,)) — draw d passes iff its transient stays
      inside its own envelope at every post-event record.
    """
    times = np.asarray(times, np.float64)
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 2:
        beta = beta[None]
    b = beta.shape[0]
    if env.num_draws != b:
        raise ValueError(f"envelope batch {env.num_draws} != beta batch {b}")
    if b_pre is None:
        pre = np.nonzero(times < t0)[0]
        if len(pre) == 0:
            raise ValueError("no record before t0 to baseline against; "
                             "pass b_pre explicitly")
        b_pre = beta[:, pre[-1]]
    b_pre = np.atleast_2d(np.asarray(b_pre, np.float64))
    post = times >= t0
    dtm = np.maximum(times[post] - t0, 0.0)
    slack_b = np.broadcast_to(np.asarray(slack, np.float64).reshape(-1),
                              (b,))
    dev = np.abs(beta[:, post] - (b_pre + env.db_inf)[:, None, :])
    bound = (env.amp[:, None] * np.exp(-env.sigma[:, None] * dtm[None, :])
             + slack_b[:, None])
    margin = (bound - dev.max(axis=2)).min(axis=1)
    return margin >= 0.0, margin
