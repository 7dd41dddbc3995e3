"""Reframing (paper §4.2, ref [15]; arXiv:2504.07044): frame rotation.

During initial synchronization the DDCs act as virtual 2^32-deep buffers and
their occupancies settle at arbitrary values.  Before applications start, the
read pointer of each real (32-deep) elastic buffer is *rotated* so occupancy
sits at the chosen setpoint.  Rotating the read pointer by δ frames changes
the logical latency of that edge by exactly δ — the operation trades λ for
buffer headroom and is the reason Table 1's RTTs are ~69 rather than ~2^32.

Two shift-assignment modes are provided:

``per-edge``
    Each buffer is recentered independently: ``shift_e = rint(target − β_e)``.
    This is the hardware's one-shot post-sync reframing — it needs the
    per-edge occupancy (the segment-sum simulator's (T, E) β record) and
    moves every RTT to its physical minimum (Table 1).

``graph``
    The *graph-consistent* assignment used by the closed-loop auto-reframe
    subsystem (``repro_torch.scenarios.run_scenario(auto_reframe=...)``): integer
    node potentials x solve the weighted-Laplacian least-squares problem
    ``L x = d`` against the per-node NET occupancy deviation d — exactly the
    quantity the dense kernels record in-kernel — and every edge gets
    ``shift_e = x_src − x_dst``.  Shifts that are potential differences
    telescope around every closed walk, so ALL cycle sums of λ — in
    particular every round-trip λ_e + λ_rev(e) — are conserved *by
    construction*: the rotation recenters the buffers without perturbing the
    logical-synchrony schedule the applications were planned against.

The frame-rotation invariant (Δλ_edge == applied shift; graph-mode cycle
sums conserved) is pinned by :func:`check_rotation_invariant` and the
hypothesis property suite in ``tests/test_reframing.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .frame_model import LinkParams, OMEGA_NOM, SimResult
from .topology import Topology

__all__ = ["ReframeResult", "ReframePolicy", "reframe", "reframe_net",
           "reframe_state", "edge_occupancy", "node_net_occupancy",
           "graph_shifts", "shift_assignment", "potential_residual",
           "check_rotation_invariant"]


@dataclasses.dataclass(frozen=True)
class ReframeResult:
    """Applied pointer rotation.

    links: links with the rotated λeff fold (``beta0 += shift``).
    shift: (E,) integer read-pointer shifts in frames (Δλ per edge).
    occupancy_before/after: (E,) per-edge β around the rotation — None
      when only the per-node net occupancy was observable (the dense
      telemetry entry point :func:`reframe_net`).
    mode: "per-edge" | "graph".
    potentials: (N,) integer node potentials (graph mode; shift is
      exactly ``potentials[src] − potentials[dst]``).
    net_before/after: (N,) per-node net occupancy Σ_{e→i} w_e·β_e.
    """

    links: LinkParams
    shift: np.ndarray
    occupancy_before: Optional[np.ndarray]
    occupancy_after: Optional[np.ndarray]
    mode: str = "per-edge"
    potentials: Optional[np.ndarray] = None
    net_before: Optional[np.ndarray] = None
    net_after: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class ReframePolicy:
    """Closed-loop auto-reframe policy (``run_scenario(auto_reframe=...)``).

    The runner inspects each chunk's in-kernel β record; when the
    graph-consistent per-edge occupancy estimate reconstructed from it
    (node potentials via the Laplacian pseudo-inverse, differenced along
    each edge) crosses the guard band ``depth/2 − margin`` it splices a
    graph-mode rotation (computed from the live threaded state) before
    the next chunk and continues the SAME compiled engine — the shifts
    only rewrite the traced λeff inputs.

    depth: elastic-buffer depth in frames (paper hardware: 32).
    margin: guard-band margin in frames; None derives it from
      :func:`repro_torch.core.envelopes.default_slack` via
      :func:`repro_torch.core.envelopes.reframe_guard_margin` (what a record can
      legitimately move past the last inspected record: the ν·ω·l coupling,
      float32 rounding, a one-frame floor).  Size it up to at least the
      worst per-chunk occupancy slew of the scenario's disturbances.
    target: normalized per-edge occupancy setpoint after the rotation
      (0 == half-full, the DDC midpoint).
    """

    depth: int = 32
    margin: Optional[float] = None
    target: float = 0.0

    def __post_init__(self):
        if self.depth <= 0:
            raise ValueError("ReframePolicy.depth must be positive")
        if self.margin is not None and self.margin < 0:
            raise ValueError("ReframePolicy.margin must be >= 0")

    def guard(self, margin=None):
        """The trip threshold ``depth/2 − margin`` (frames, must be > 0).

        ``margin`` may be a scalar or a per-draw (B,) array (from
        :func:`repro_torch.core.envelopes.reframe_guard_margins`); the return
        matches — a float for scalar input, an ndarray otherwise.
        """
        m = self.margin if margin is None else margin
        g = self.depth / 2.0 - np.asarray(m, np.float64)
        if np.any(g <= 0):
            bad = float(np.min(g))
            raise ValueError(
                f"reframe guard band depth/2 − margin = {bad:.3g} <= 0 "
                f"(depth={self.depth}, margin={np.max(np.asarray(m)):.3g});"
                " pass a smaller margin or a deeper buffer")
        return float(g) if g.ndim == 0 else g


def edge_occupancy(topo: Topology, psi, nu, lat_frames, lam_eff) -> np.ndarray:
    """(..., E) per-edge occupancy from live state, exact float64 host math.

    β_e = ψ_src − ν_src·lat_e + λeff_e − ψ_dst, with ``lat_frames`` the
    physical latency in frames (ω·l).  Leading batch axes broadcast.
    """
    psi = np.asarray(psi, np.float64)
    nu = np.asarray(nu, np.float64)
    lat = np.asarray(lat_frames, np.float64)
    lam = np.asarray(lam_eff, np.float64)
    src = np.asarray(topo.src)
    dst = np.asarray(topo.dst)
    return (psi[..., src] - nu[..., src] * lat + lam - psi[..., dst])


def node_net_occupancy(topo: Topology, beta_edges, edge_w=None) -> np.ndarray:
    """(..., N) per-node net occupancy Σ_{e→i} w_e·β_e (the dense engines'
    in-kernel telemetry quantity) from per-edge β."""
    beta = np.asarray(beta_edges, np.float64)
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    out = np.zeros(beta.shape[:-1] + (topo.num_nodes,), np.float64)
    flat = out.reshape(-1, topo.num_nodes)
    bflat = (beta * w).reshape(-1, topo.num_edges)
    rows = np.arange(flat.shape[0])[:, None]
    dst = np.asarray(topo.dst)[None, :]
    np.add.at(flat, (rows, dst), bflat)
    return out


def _weighted_degree(topo: Topology, edge_w=None) -> np.ndarray:
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    deg = np.zeros(topo.num_nodes, np.float64)
    np.add.at(deg, np.asarray(topo.dst), w)
    return deg


def graph_shifts(topo: Topology, net_deviation, edge_w=None, lap_pinv=None):
    """Integer, cycle-sum-free pointer shifts from a NET occupancy deviation.

    Solves the weighted in-degree Laplacian least-squares problem
    ``L x = d`` (d = net occupancy − setpoint, per node), rounds the node
    potentials to integers, and assigns ``shift_e = x_src − x_dst``.  The
    scatter-by-destination of the shifts is then ≈ −d (exactly −d up to
    potential rounding and the Laplacian's nullspace component of d), and
    every cycle sum of the shifts is zero by construction — RTTs and all
    longer logical round trips are conserved.

    ``lap_pinv`` optionally supplies a precomputed pseudo-inverse of the
    same weighted Laplacian (the scenario runner caches one per
    edge-weight vector), turning the O(N³) solve into an O(N²) matvec.

    Returns (potentials (N,) int64, shift (E,) int64).
    """
    # Local import: envelopes ← frame_model/topology only, no cycle.
    from .envelopes import laplacian

    d = np.asarray(net_deviation, np.float64)
    if d.shape != (topo.num_nodes,):
        raise ValueError(
            f"net_deviation must be ({topo.num_nodes},), got {d.shape}")
    if lap_pinv is not None:
        x = np.asarray(lap_pinv, np.float64) @ d
    else:
        x = np.linalg.lstsq(laplacian(topo, edge_w), d, rcond=None)[0]
    x = np.rint(x - x.mean()).astype(np.int64)
    shift = x[np.asarray(topo.src)] - x[np.asarray(topo.dst)]
    return x, shift


def shift_assignment(topo: Topology, beta, edge_w, mode: str,
                     target: float, edges=None, lap_pinv=None):
    """The ONE shift-assignment rule every rotation path applies.

    From a per-edge occupancy row ``beta`` (frames), returns
    ``(potentials-or-None, (E,) int64 shifts)``: ``mode="per-edge"``
    recenters each listed buffer to ``target`` independently,
    ``mode="graph"`` solves the RTT-conserving potential assignment
    against the per-node net fold (``edges`` must be None there — node
    potentials are global; ``lap_pinv`` optionally reuses a cached
    Laplacian pseudo-inverse).  Both :func:`reframe_state` and the
    scenario runner's splice path (``repro_torch.scenarios.runner``) delegate
    here, so the live closed loop and the library API cannot drift apart.
    """
    beta = np.asarray(beta, np.float64)
    e = topo.num_edges
    if mode == "per-edge":
        idx = list(range(e)) if edges is None else list(edges)
        shift = np.zeros(e, np.int64)
        shift[idx] = np.rint(target - beta[idx]).astype(np.int64)
        return None, shift
    if mode != "graph":
        raise ValueError(f"unknown reframe mode {mode!r}")
    if edges is not None:
        raise ValueError("graph-mode rotation assigns every edge (node "
                         "potentials are global); leave edges=None")
    net = node_net_occupancy(topo, beta, edge_w)
    deg = _weighted_degree(topo, edge_w)
    return graph_shifts(topo, net - target * deg, edge_w, lap_pinv=lap_pinv)


def potential_residual(topo: Topology, shift) -> float:
    """Max deviation of a per-edge quantity from a node-potential form.

    0.0 iff ``shift_e == x_src − x_dst`` for some potential x — i.e. iff
    every cycle sum of ``shift`` vanishes (the graph-mode rotation
    invariant).  Computed by propagating potentials over a BFS spanning
    forest of the undirected support and checking every edge against it.
    """
    shift = np.asarray(shift, np.float64)
    n = topo.num_nodes
    src = np.asarray(topo.src)
    dst = np.asarray(topo.dst)
    adj = [[] for _ in range(n)]
    for e in range(topo.num_edges):
        adj[src[e]].append((dst[e], -shift[e]))   # walking src -> dst
        adj[dst[e]].append((src[e], shift[e]))
    x = np.full(n, np.nan)
    for root in range(n):
        if not np.isnan(x[root]):
            continue
        x[root] = 0.0
        queue = [root]
        while queue:
            i = queue.pop()
            for j, dx in adj[i]:
                if np.isnan(x[j]):
                    x[j] = x[i] + dx
                    queue.append(j)
    resid = np.abs(shift - (x[src] - x[dst]))
    return float(resid.max(initial=0.0))


def check_rotation_invariant(topo: Topology, lam_before, lam_after, shift,
                             graph_mode: bool = False) -> None:
    """Assert the frame-rotation invariant on applied λ tables.

    Δλ per edge must equal the applied shift exactly; with ``graph_mode``
    the shifts must additionally have zero cycle sums (all RTTs conserved).
    """
    dlam = np.asarray(lam_after, np.int64) - np.asarray(lam_before, np.int64)
    shift = np.asarray(shift, np.int64)
    if not np.array_equal(dlam, shift):
        bad = int(np.abs(dlam - shift).argmax())
        raise AssertionError(
            f"frame-rotation invariant violated: Δλ[{bad}] = {dlam[bad]} "
            f"!= shift[{bad}] = {shift[bad]}")
    if graph_mode:
        resid = potential_residual(topo, shift)
        if resid > 0:
            raise AssertionError(
                f"graph-mode shifts have nonzero cycle sums (residual "
                f"{resid:g}); RTTs are not conserved")


def _apply_shift(links: LinkParams, shift) -> LinkParams:
    return LinkParams(latency_s=links.latency_s,
                      beta0=np.asarray(links.beta0, np.float64) + shift)


def _depth_check(dev, depth: int, what: str) -> None:
    if np.any(np.abs(dev) > depth / 2):
        raise RuntimeError(
            f"reframing failed: residual {what} exceeds buffer depth")


def reframe(result: SimResult, target: float = 2.0, depth: int = 32,
            mode: str = "per-edge") -> ReframeResult:
    """Recenter converged buffers from a segment-sum per-edge β record.

    Must be called on a converged simulation (frequencies aligned); the
    recentering itself is instantaneous in the model — the hardware
    performs it by rotating read pointers, which takes O(|shift|)
    localticks.  ``mode="per-edge"`` (default, the post-sync hardware
    semantics) recenters every buffer to ``target`` independently;
    ``mode="graph"`` applies the RTT-conserving potential assignment
    against the per-node net occupancy instead.
    """
    if result.beta.size == 0:
        raise ValueError("simulation was run with record_beta=False")
    occ = np.asarray(result.beta[-1], np.float64)
    topo = result.topo
    potentials, shift = shift_assignment(topo, occ, None, mode, target)
    after = occ + shift
    _depth_check(after - target, depth, "occupancy")
    return ReframeResult(
        links=_apply_shift(result.links, shift), shift=shift,
        occupancy_before=occ, occupancy_after=after, mode=mode,
        potentials=potentials,
        net_before=node_net_occupancy(topo, occ),
        net_after=node_net_occupancy(topo, after))


def reframe_net(topo: Topology, links: LinkParams, net_beta,
                edge_w=None, target: float = 0.0,
                depth: int = 32) -> ReframeResult:
    """Graph-mode rotation from the dense lanes' per-node NET β telemetry.

    ``net_beta`` is one (N,) record of the in-kernel occupancy stream
    (``DenseResult.beta_final`` / the last ``ScenarioResult.beta`` row).
    Per-edge occupancies are not observable here; the returned result
    carries the net view only.
    """
    net = np.asarray(net_beta, np.float64)
    deg = _weighted_degree(topo, edge_w)
    potentials, shift = graph_shifts(topo, net - target * deg, edge_w)
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    applied = np.zeros(topo.num_nodes, np.float64)
    np.add.at(applied, np.asarray(topo.dst), shift * w)
    net_after = net + applied
    _depth_check(net_after / np.maximum(deg, 1.0) - target, depth,
                 "node-normalized net occupancy")
    return ReframeResult(
        links=_apply_shift(links, shift), shift=shift,
        occupancy_before=None, occupancy_after=None, mode="graph",
        potentials=potentials, net_before=net, net_after=net_after)


def reframe_state(topo: Topology, links: LinkParams, psi, nu,
                  omega_nom: float = OMEGA_NOM, edge_w=None,
                  target: float = 0.0, depth: int = 32,
                  mode: str = "graph") -> ReframeResult:
    """Rotation computed from live simulator state (ψ, ν in the relative
    coordinates of ``repro_torch.core.frame_model``; links.beta0 is the live
    λeff fold).  Applies the same :func:`shift_assignment` rule the
    scenario runner splices, so shifts computed here match a
    ``run_scenario`` rotation at the same state exactly.
    """
    lat_frames = np.asarray(links.latency_s, np.float64) * omega_nom
    occ = edge_occupancy(topo, psi, nu, lat_frames, links.beta0)
    if occ.ndim != 1:
        raise ValueError("reframe_state takes single-draw state; loop draws "
                         "for batched runs")
    net = node_net_occupancy(topo, occ, edge_w)
    potentials, shift = shift_assignment(topo, occ, edge_w, mode, target)
    after = occ + shift
    _depth_check(after - target, depth, "occupancy")
    return ReframeResult(
        links=_apply_shift(links, shift), shift=np.asarray(shift, np.int64),
        occupancy_before=occ, occupancy_after=after, mode=mode,
        potentials=potentials, net_before=net,
        net_after=node_net_occupancy(topo, after, edge_w))
