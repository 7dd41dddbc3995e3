"""The abstract frame model (paper §6) on torch tensors: the segment-sum lane.

Port of ``repro.core.frame_model``.  The model integrates relative
coordinates, exactly as the reference does:

    ψ_i = θ_i − ω_nom·t            (|ψ| ≲ 1e6 ticks)
    ν_i = ω_i/ω_nom − 1            (|ν| ≲ 1e-4)

    β_{j→i} = ψ_j − ν_j·ω_nom·l_{j→i} − ψ_i + λeff_{j→i}

and advances at a fixed control period ``dt``; between control events
frequencies are constant, so phase integration is exact.

The per-destination error sum (the reference's ``.at[dst].add``) is an
ordered reduction: edges are grouped by destination into a (N, K) slot
table in their original order, and the K slots are added one after the
other.  No atomics are involved, so the sum runs in the same order on
every device and in every batch — a draw run alone is bit-identical to
the same draw inside a batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device

from .controller import (ControllerConfig, controller_init, controller_step,
                         holdover_freeze)
from .topology import Topology

__all__ = ["LinkParams", "SimConfig", "SimResult", "EnsembleResult",
           "simulate", "simulate_ensemble", "make_links", "broadcast_gain",
           "OMEGA_NOM", "SIGNAL_VELOCITY", "PIPE_FRAMES", "EB_INIT",
           "RUN_COUNT"]

OMEGA_NOM = 125e6  # frames/s — the paper's 125 MHz node clock.

# Calibrated physical constants (paper §5.6): group velocity in fiber such
# that a 2 km spool (~1 km per direction) adds ~1231 frames of round-trip
# logical latency, and 16 frames of transceiver pipeline per direction.
SIGNAL_VELOCITY = 2.03e8   # m/s
PIPE_FRAMES = 16.0         # serdes/transceiver pipeline, frames per direction
EB_INIT = 18.0             # elastic buffer init: 32-deep, half-full + 2 (§5.2)

# Runs of the segment-sum period loop in this process (one per call of
# simulate / simulate_ensemble) — the lane's launch count.
RUN_COUNT = {"segment-sum": 0}


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """Per-directed-edge physical link parameters.

    latency_s: one-way physical latency (cable + transceiver pipeline).
    beta0: initial elastic-buffer occupancy in frames (0 = half-full).

    Either field may carry a per-draw leading axis — shape (B, E) — for
    Monte Carlo over cable-length distributions; the batched lanes consume
    one row per draw.  Single-run entry points take the (E,) form.
    """

    latency_s: np.ndarray
    beta0: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(np.asarray(self.latency_s).shape[-1])

    @property
    def num_draws(self) -> Optional[int]:
        """Leading batch size if any field is per-draw, else None."""
        for arr in (self.latency_s, self.beta0):
            arr = np.asarray(arr)
            if arr.ndim == 2:
                return int(arr.shape[0])
        return None

    def draw(self, b: int) -> "LinkParams":
        """The (E,)-shaped link set of draw ``b``."""
        pick = lambda arr: (np.asarray(arr)[b] if np.asarray(arr).ndim == 2
                            else np.asarray(arr))
        return LinkParams(latency_s=pick(self.latency_s),
                          beta0=pick(self.beta0))


def make_links(
    topo: Topology,
    cable_m: float | np.ndarray = 2.0,
    beta0: float | np.ndarray = 0.0,
    omega_nom: float = OMEGA_NOM,
    pipe_frames: float = PIPE_FRAMES,
    velocity: float = SIGNAL_VELOCITY,
) -> LinkParams:
    """Build LinkParams from cable lengths in meters (per directed edge).

    ``cable_m`` / ``beta0`` accept scalars, (E,) arrays, or 2-D per-draw
    arrays broadcastable to (B, E), which yields batched LinkParams.
    """
    cable = np.asarray(cable_m, np.float64)
    b0 = np.asarray(beta0, np.float64)
    if cable.ndim == 2 or b0.ndim == 2:
        b = cable.shape[0] if cable.ndim == 2 else b0.shape[0]
        if (cable.ndim == 2 and b0.ndim == 2
                and cable.shape[0] != b0.shape[0]):
            raise ValueError(
                f"per-draw cable_m and beta0 disagree on B: "
                f"{cable.shape[0]} vs {b0.shape[0]}")
        shape = (b, topo.num_edges)
    else:
        shape = (topo.num_edges,)
    cable = np.broadcast_to(cable, shape)
    lat = cable / velocity + pipe_frames / omega_nom
    b0 = np.broadcast_to(b0, shape)
    return LinkParams(latency_s=lat.astype(np.float64), beta0=b0.astype(np.float64))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    omega_nom: float = OMEGA_NOM
    dt: float = 1e-3            # control period, seconds
    steps: int = 50_000
    record_every: int = 10      # telemetry decimation
    quantize_beta: bool = False # model the hardware's integer occupancy reads
    record_beta: bool = True
    telemetry_noise_ppm: float = 0.0  # observation noise on *recorded* freq (Fig 16)
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    """Telemetry + final state of one run (host numpy arrays).

    freq_ppm: (T, N) recorded clock frequency offsets from nominal, ppm.
    beta: (T, E) recorded occupancies (empty if record_beta=False).
    times: (T,) physical time of each record, seconds.
    psi/nu/c_state: final simulator state (for chaining).
    """

    freq_ppm: np.ndarray
    beta: np.ndarray
    times: np.ndarray
    psi: np.ndarray
    nu: np.ndarray
    c_state: dict
    topo: Topology
    links: LinkParams
    cfg: SimConfig
    engine: str = "segment-sum"

    @property
    def final_freq_ppm(self) -> np.ndarray:
        return self.freq_ppm[-1]

    def convergence_time(self, band_ppm: float = 1.0) -> float:
        """First recorded time after which all nodes stay within band_ppm."""
        spread = self.freq_ppm.max(axis=1) - self.freq_ppm.min(axis=1)
        return _convergence_time(spread, self.times, band_ppm)


def _convergence_time(spread, times, band_ppm: float) -> float:
    """First recorded time after which a (T,) spread stays within band."""
    ok = spread <= band_ppm
    bad = np.nonzero(~ok)[0]   # last record the band was violated
    if len(bad) == 0:
        return float(times[0])
    if bad[-1] == len(ok) - 1:
        return float("inf")
    return float(times[bad[-1] + 1])


@dataclasses.dataclass
class EnsembleResult:
    """Telemetry + final state of a batched (Monte Carlo) run.

    Same fields as SimResult with a leading batch axis B:
      freq_ppm: (B, T, N); beta: (B, T, E); psi/nu: (B, N);
      c_state values: (B, N).
    """

    freq_ppm: np.ndarray
    beta: np.ndarray
    times: np.ndarray
    psi: np.ndarray
    nu: np.ndarray
    c_state: dict
    topo: Topology
    links: LinkParams
    cfg: SimConfig
    engine: str = "segment-sum"

    @property
    def num_draws(self) -> int:
        return int(self.freq_ppm.shape[0])

    @property
    def final_spread_ppm(self) -> np.ndarray:
        """(B,) final recorded frequency band per draw."""
        last = self.freq_ppm[:, -1]
        return last.max(axis=1) - last.min(axis=1)

    def convergence_times(self, band_ppm: float = 1.0) -> np.ndarray:
        """(B,) first recorded time after which each draw stays in band."""
        spread = self.freq_ppm.max(axis=2) - self.freq_ppm.min(axis=2)
        return np.array([_convergence_time(s, self.times, band_ppm)
                         for s in spread])

    def draw(self, b: int) -> SimResult:
        """View draw b as a SimResult (chainable: c_state is per-draw)."""
        return SimResult(
            freq_ppm=self.freq_ppm[b], beta=self.beta[b], times=self.times,
            psi=self.psi[b], nu=self.nu[b],
            c_state={k: v[b] for k, v in self.c_state.items()},
            topo=self.topo,
            links=(self.links.draw(b) if self.links.num_draws is not None
                   else self.links),
            cfg=self.cfg, engine=self.engine)


def _dst_slots(topo: Topology) -> np.ndarray:
    """(N, K) edge indices grouped by destination, in edge order.

    K is the largest in-degree; empty slots hold E, the index of a zero
    column appended to the per-edge contributions.
    """
    n, e = topo.num_nodes, topo.num_edges
    order = np.argsort(topo.dst, kind="stable")
    counts = np.bincount(topo.dst, minlength=n)
    k = max(int(counts.max(initial=0)), 1)
    slots = np.full((n, k), e, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(e) - np.repeat(starts, counts)
    slots[topo.dst[order], rank] = order
    return slots


def _segment_sum(contrib: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """(B, E) per-edge values -> (B, N) per-destination sums, ordered.

    Starts from zero and adds each destination's edges in edge order — the
    order of the reference's scatter-add — with no atomics.
    """
    padded = torch.cat([contrib, contrib.new_zeros(contrib.shape[0], 1)],
                       dim=1)
    gathered = padded[:, slots]                         # (B, N, K)
    out = torch.zeros_like(gathered[..., 0])
    for k in range(gathered.shape[-1]):
        out = out + gathered[..., k]
    return out


def _run_core(src, dst, slots, lat_frames, lam_eff, nu_u, dt_frames, inner,
              kp, beta_off, psi0, nu0, c0, edge_w, ctrl_mask,
              ctrl: ControllerConfig, outer: int, quantize_beta: bool,
              record_beta: bool):
    """``outer`` records of ``inner`` control periods over a batch of draws.

    Shapes: lat_frames / lam_eff (B, E); nu_u, psi0, nu0 and c0's values
    (B, N); kp / beta_off (B, 1); edge_w (1|B, E); ctrl_mask (1|B, N).
    Returns ((psi, nu, c_state), freq (B, R, N) in ν units, beta (B, R, E)
    or None).
    """

    def occupancies(psi, nu):
        # ν is piecewise-constant over the period, so the delayed-phase
        # term uses the sender's current ν.
        return (psi[:, src] - nu[:, src] * lat_frames + lam_eff
                - psi[:, dst])

    enabled = ctrl_mask > 0.5
    psi, nu, c_state = psi0, nu0, c0
    freq, betas = [], []
    for _ in range(outer):
        for _ in range(inner):
            beta = occupancies(psi, nu)
            if quantize_beta:
                beta = torch.round(beta)
            err = _segment_sum((beta - beta_off) * edge_w, slots)
            c_state_new, c_corr = controller_step(ctrl, c_state, err, kp)
            c_state = holdover_freeze(c_state_new, c_state, enabled)
            # (1+ν_u)(1+c) − 1 without forming 1 + O(1e-6) (f32 cancellation)
            nu_ctrl = nu_u + c_corr + nu_u * c_corr
            # Holdover: a masked-out node's ν holds its previous value.
            nu = torch.where(enabled, nu_ctrl, nu)
            psi = psi + nu * dt_frames
        # Read out β consistently with the post-update state.
        freq.append(nu)
        if record_beta:
            betas.append(occupancies(psi, nu))
    freq = torch.stack(freq, dim=1)
    beta = torch.stack(betas, dim=1) if record_beta else None
    return (psi, nu, c_state), freq, beta


def _resolve_init(init, nu_u: torch.Tensor, ctrl: ControllerConfig):
    """Initial (psi0, nu0, c0) on ``nu_u``'s device and shape.

    ``init`` is None (cold start: ψ = 0, ν = ν_u, fresh controller state),
    a ``(psi, nu, c_state)`` tuple, or a result exposing ``.psi`` / ``.nu``
    / ``.c_state``.  Chained state passes through exactly, so a split run
    is bit-identical to an unsplit one.
    """
    dev, shape = nu_u.device, nu_u.shape
    if init is None:
        return (torch.zeros_like(nu_u), nu_u.clone(),
                controller_init(ctrl, shape, dev))
    if isinstance(init, (tuple, list)):
        psi, nu, c_state = init
    else:
        psi, nu, c_state = init.psi, init.nu, init.c_state

    def put(x):
        t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return t.reshape(shape)

    return put(psi), put(nu), {k: put(v) for k, v in c_state.items()}


def _edge_node_weights(edge_w, ctrl_mask, num_edges: int, num_nodes: int,
                       num_draws: Optional[int] = None):
    """Validate the link-drop weights and controller mask as numpy rows.

    Shared (E,) / (N,) rows always pass; with ``num_draws`` (ensemble
    callers) per-draw (B, E) / (B, N) rows are accepted too.
    """
    w = (np.ones((num_edges,), np.float32) if edge_w is None
         else np.asarray(edge_w, np.float32))
    m = (np.ones((num_nodes,), np.float32) if ctrl_mask is None
         else np.asarray(ctrl_mask, np.float32))
    w_shapes = [(num_edges,)] + (
        [(num_draws, num_edges)] if num_draws else [])
    m_shapes = [(num_nodes,)] + (
        [(num_draws, num_nodes)] if num_draws else [])
    if w.shape not in w_shapes:
        raise ValueError(f"edge_w must be one of {w_shapes}, got {w.shape}")
    if m.shape not in m_shapes:
        raise ValueError(f"ctrl_mask must be one of {m_shapes}, "
                         f"got {m.shape}")
    return np.atleast_2d(w), np.atleast_2d(m)


def _split_steps(cfg: SimConfig):
    inner = cfg.record_every
    outer = cfg.steps // inner
    if outer < 1:
        raise ValueError("steps must be >= record_every")
    return inner, outer


def broadcast_gain(value, b: int, name: str = "kp") -> np.ndarray:
    """Normalize a controller gain to a (B,) float32 per-draw vector.

    Accepts a scalar (shared across draws) or a length-B array (one gain
    per draw — the batched gain-sweep axis).
    """
    arr = np.asarray(value, np.float32).reshape(-1)
    if arr.shape[0] == 1:
        arr = np.broadcast_to(arr, (b,))
    if arr.shape[0] != b:
        raise ValueError(
            f"{name} must be a scalar or length-{b} (one per draw), "
            f"got shape {np.asarray(value).shape}")
    return np.ascontiguousarray(arr)


def _link_arrays(topo: Topology, links: LinkParams, cfg: SimConfig, b: int):
    """(B, E) float32 latency (frames) and λeff rows; shared links tile."""
    e = topo.num_edges
    lat = np.asarray(links.latency_s, np.float64)
    b0 = np.asarray(links.beta0, np.float64)
    for name, arr in (("latency_s", lat), ("beta0", b0)):
        if arr.ndim == 2 and arr.shape != (b, e):
            raise ValueError(f"per-draw links.{name} must be (B, E) = "
                             f"({b}, {e}), got {arr.shape}")
    lat = np.broadcast_to(lat * cfg.omega_nom, (b, e)).astype(np.float32)
    b0 = np.broadcast_to(b0, (b, e)).astype(np.float32)  # β(0) with ψ(0)=0
    return lat, b0


def _run(topo, links, ctrl, ppm_u, cfg, init, edge_w, ctrl_mask, device):
    """Shared body of simulate / simulate_ensemble on (B, N) draws."""
    dev = resolve_device(device)
    b = ppm_u.shape[0]
    inner, outer = _split_steps(cfg)
    lat, lam = _link_arrays(topo, links, cfg, b)
    w, m = _edge_node_weights(edge_w, ctrl_mask, topo.num_edges,
                              topo.num_nodes, num_draws=b)
    put = lambda x: torch.as_tensor(np.array(x), device=dev)
    kp = put(broadcast_gain(ctrl.kp, b, "kp")[:, None])
    beta_off = put(broadcast_gain(ctrl.beta_off, b, "beta_off")[:, None])
    nu_u = put((ppm_u * np.float32(1e-6)).astype(np.float32))
    psi0, nu0, c0 = _resolve_init(init, nu_u, ctrl)
    RUN_COUNT["segment-sum"] += 1
    (psi, nu, c_state), freq, beta = _run_core(
        put(topo.src.astype(np.int64)), put(topo.dst.astype(np.int64)),
        put(_dst_slots(topo)), put(lat), put(lam), nu_u,
        float(np.float32(cfg.omega_nom * cfg.dt)), inner, kp, beta_off,
        psi0, nu0, c0, put(w), put(m), ctrl, outer, cfg.quantize_beta,
        cfg.record_beta)
    freq = (freq * 1e6).cpu().numpy()
    if cfg.telemetry_noise_ppm:
        gen = torch.Generator().manual_seed(cfg.seed)
        freq = freq + cfg.telemetry_noise_ppm * torch.randn(
            freq.shape, generator=gen).numpy()
    beta = (beta.cpu().numpy() if cfg.record_beta
            else np.zeros((b, outer, 0), np.float32))
    times = (np.arange(1, outer + 1) * inner) * cfg.dt
    return (freq, beta, times, psi.cpu().numpy(), nu.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in c_state.items()})


def simulate(
    topo: Topology,
    links: LinkParams,
    ctrl: ControllerConfig,
    ppm_u: np.ndarray,
    cfg: SimConfig = SimConfig(),
    init=None,
    edge_w=None,
    ctrl_mask=None,
    *,
    device=None,
) -> SimResult:
    """Run the abstract frame model for one oscillator draw.

    Args:
      topo, links, ctrl, cfg: as in ``repro.core.simulate``.
      ppm_u: (N,) unadjusted oscillator offsets in ppm.
      init: optional chained state — ``(psi, nu, c_state)`` or a prior
        SimResult.
      edge_w: optional (E,) error-contribution weights (0 = dropped link).
      ctrl_mask: optional (N,) controller-enable mask (0 = clock holdover).
      device: where to run; None means the CUDA card (raises without one).
    """
    ppm_u = np.asarray(ppm_u, np.float32)
    if ppm_u.shape != (topo.num_nodes,):
        raise ValueError(f"ppm_u must be ({topo.num_nodes},), got {ppm_u.shape}")
    if np.asarray(ctrl.kp).ndim or np.asarray(ctrl.beta_off).ndim:
        raise ValueError("simulate() takes scalar gains; per-draw kp/beta_off "
                         "arrays are the batched axis of simulate_ensemble()")
    if links.num_draws is not None:
        raise ValueError("simulate() takes a single (E,) link set; per-draw "
                         "(B, E) links are the batched axis of "
                         "simulate_ensemble()")
    for name, arr in (("edge_w", edge_w), ("ctrl_mask", ctrl_mask)):
        if arr is not None and np.ndim(arr) != 1:
            raise ValueError(f"simulate() takes an unbatched {name}")
    freq, beta, times, psi, nu, c_state = _run(
        topo, links, ctrl, ppm_u[None], cfg, init, edge_w, ctrl_mask, device)
    return SimResult(
        freq_ppm=freq[0], beta=beta[0], times=times, psi=psi[0], nu=nu[0],
        c_state={k: v[0] for k, v in c_state.items()},
        topo=topo, links=links, cfg=cfg)


def simulate_ensemble(
    topo: Topology,
    links: LinkParams,
    ctrl: ControllerConfig,
    ppm_u: np.ndarray,
    cfg: SimConfig = SimConfig(),
    init=None,
    edge_w=None,
    ctrl_mask=None,
    *,
    device=None,
) -> EnsembleResult:
    """Run B independent oscillator draws together.

    ``ctrl.kp`` / ``ctrl.beta_off`` may be length-B arrays (one gain per
    draw); ``links`` may carry per-draw (B, E) rows; ``edge_w`` may be (E,)
    or (B, E) and ``ctrl_mask`` (N,) or (B, N).  Every operation is
    elementwise across draws or an ordered per-draw sum, so draw b is
    bit-identical to ``simulate`` of that draw alone.

    Args:
      ppm_u: (B, N) unadjusted oscillator offsets in ppm.
      init: optional ``(psi, nu, c_state)`` with (B, N) leaves or a prior
        EnsembleResult.
      device: where to run; None means the CUDA card (raises without one).
    """
    ppm_u = np.asarray(ppm_u, np.float32)
    if ppm_u.ndim != 2 or ppm_u.shape[1] != topo.num_nodes:
        raise ValueError(
            f"ppm_u must be (B, {topo.num_nodes}), got {ppm_u.shape}")
    b = ppm_u.shape[0]
    if links.num_draws is not None and links.num_draws != b:
        raise ValueError(f"links carry {links.num_draws} draws but ppm_u "
                         f"has {b}")
    freq, beta, times, psi, nu, c_state = _run(
        topo, links, ctrl, ppm_u, cfg, init, edge_w, ctrl_mask, device)
    return EnsembleResult(
        freq_ppm=freq, beta=beta, times=times, psi=psi, nu=nu,
        c_state=c_state, topo=topo, links=links, cfg=cfg)
