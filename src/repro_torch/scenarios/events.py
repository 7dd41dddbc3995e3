"""Declarative dynamic events for bittide simulations.

The paper's headline robustness claim is that bittide "robustly handles
varying physical latencies" — the hardware team physically swaps a 2 m
cable for a 2 km fiber spool *mid-experiment* (§5.6, Table 2) and watches
the logical latency re-settle.  Every event type here names a physical
perturbation of that kind:

``LatencyStep``
    A cable swap on a set of directed edges.  Default semantics preserve
    the per-edge constant λeff (= λ − ω·l, fixed by the initial
    occupancy): the buffer occupancy is continuous through the swap up to
    the O(ν·Δl) sensitivity term, and the *logical* latency λ shifts by
    exactly ω_nom·Δl — the in-flight frames added by the longer fiber,
    the paper's ≈1231-frame RTT shift.  ``reestablish=True`` additionally
    models the link bring-up protocol re-initializing the elastic buffer
    to its β0 setpoint (λeff is recomputed from the live clock state at
    the event).
``FreqStep``
    A step in the unadjusted oscillator frequency of a set of nodes
    (e.g. a thermal shock); the control loop re-converges around it.
``DriftRamp``
    A linear drift in unadjusted frequency between two times — slow
    temperature drift across part of the machine.  The compiler lowers
    the ramp into per-record constant steps.
``NodeHoldover`` / ``NodeReset``
    A node's control loop opens: its oscillator *holds* the last applied
    correction (ν frozen) and its controller state freezes, while the
    rest of the network keeps adapting around it.  ``NodeReset`` closes
    the loop again.
``LinkDrop`` / ``LinkRestore``
    A link goes down: its occupancy reading stops contributing to the
    receiver's error sum (weight 0).  Restore re-adds it, by default
    re-establishing the buffer at its β0 setpoint (``reestablish=True``),
    like the hardware's link bring-up.
``Reframe``
    A read-pointer rotation on the elastic buffers (paper §4.2;
    "Buffer Centering for bittide Synchronization via Frame Rotation",
    arXiv:2504.07044).  Each listed buffer's logical latency λ shifts by
    exactly the applied pointer shift — occupancy is traded for
    headroom, no frame of the post-splice stream is lost.  Shifts may be
    explicit (integer frames per edge) or computed from the live state
    at the splice: ``mode="per-edge"`` recenters every listed buffer to
    ``target`` independently (the hardware's one-shot post-sync
    reframing), ``mode="graph"`` applies the RTT-conserving
    least-squares potential assignment of
    :mod:`repro_torch.core.reframing` against the per-node net occupancy.
    The *closed-loop* variant — reframing whenever the in-kernel β
    record approaches the buffer depth — is the runner's
    ``auto_reframe=`` policy, not an event.
``Mark``
    A no-op segment boundary — forces the runner to split at a record
    (used by the chaining regression tests and for annotating plots).

Events carry *times in seconds*; the compiler snaps them to telemetry
record boundaries (``cfg.dt * cfg.record_every``), the granularity at
which the piecewise-constant lowering operates.

Per-draw (chaos-campaign) parameters
------------------------------------
Every physical event accepts *per-draw* parameters so one batched
(B-draw) simulation can run B distinct randomized fault scenarios —
the ``repro_torch.scenarios.chaos`` campaign regime:

* magnitudes: ``FreqStep.delta_ppm`` / ``DriftRamp.rate_ppm_per_s`` may
  be a (B,) array (one step size / slope per draw), and
  ``LatencyStep.cable_m`` / ``latency_s`` a (B, K) array (one swap value
  per draw per listed edge);
* victims: node/edge selections (``nodes`` / ``edges``) may be a
  sequence of B per-draw tuples — each draw gets its own holdover node
  or dropped link.

Events stay simultaneous across draws (every draw's segment boundaries
coincide), which is what keeps a whole campaign on ONE compiled kernel:
the compiler lowers per-draw parameters to traced (B, ·) arrays, never
shapes.  ``event.num_draws`` reports the batch (None = shared), and
``event.draw(b)`` / ``Scenario.draw(b)`` scalarize to a single-draw
event list — the chaos triage's shrink-to-repro hook.

This module is dependency-free (plain dataclasses + numpy) so the
frame-level oracle can consume events without import cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Mark", "LatencyStep", "FreqStep", "DriftRamp", "NodeHoldover",
           "NodeReset", "LinkDrop", "LinkRestore", "Reframe", "Scenario",
           "edges_between"]


def _ids(xs) -> Tuple:
    """Normalize a node/edge selection to a tuple of ints (shared across
    draws) or a tuple of per-draw tuples (one selection per draw)."""
    if isinstance(xs, (int, np.integer)):
        return (int(xs),)
    rows = list(xs)
    if rows and not isinstance(rows[0], (int, np.integer)):
        return tuple(tuple(int(x) for x in row) for row in rows)
    return tuple(int(x) for x in rows)


def _sel_draws(sel: Tuple) -> Optional[int]:
    """Batch size of a per-draw selection (None when shared)."""
    if sel and isinstance(sel[0], tuple):
        return len(sel)
    return None


def _sel_row(sel: Tuple, b: int) -> Tuple[int, ...]:
    """Draw ``b``'s selection (identity for shared selections)."""
    return sel[b] if _sel_draws(sel) is not None else sel


def _mag_draws(value, per_draw_ndim: int = 1) -> Optional[int]:
    """Batch size of a per-draw magnitude (None when shared)."""
    if value is None:
        return None
    arr = np.asarray(value)
    return int(arr.shape[0]) if arr.ndim == per_draw_ndim else None


def _one_draws(name: str, *batches: Optional[int]) -> Optional[int]:
    """Merge per-field batch sizes, requiring consistency."""
    sizes = {b for b in batches if b is not None}
    if len(sizes) > 1:
        raise ValueError(
            f"{name}: per-draw fields disagree on the batch size: {sizes}")
    return sizes.pop() if sizes else None


@dataclasses.dataclass(frozen=True)
class Mark:
    """Force a segment boundary at time ``t`` (no parameter change)."""
    t: float
    label: str = ""


@dataclasses.dataclass(frozen=True)
class LatencyStep:
    """Swap the cable on a set of directed edges at time ``t``.

    Exactly one of ``cable_m`` (meters; converted with the paper's fiber
    group velocity + transceiver pipeline) or ``latency_s`` (seconds) must
    be given; a scalar applies to every listed edge, an array gives one
    value per listed edge, and a (B, len(edges)) array one value per draw
    per edge (chaos campaigns — victim edges stay shared so the dense
    engines keep a per-draw class table).  Remember bittide links are
    bidirectional — a physical swap steps *both* directed edges
    (``edges_between``).
    """
    t: float
    edges: Tuple[int, ...]
    cable_m: Optional[object] = None
    latency_s: Optional[object] = None
    reestablish: bool = False

    def __post_init__(self):
        object.__setattr__(self, "edges", _ids(self.edges))
        if _sel_draws(self.edges) is not None:
            raise ValueError(
                "LatencyStep victim edges are shared across draws; use a "
                "(B, len(edges)) cable_m/latency_s for per-draw magnitudes")
        if (self.cable_m is None) == (self.latency_s is None):
            raise ValueError(
                "LatencyStep takes exactly one of cable_m or latency_s")

    @property
    def num_draws(self) -> Optional[int]:
        return _one_draws("LatencyStep", _mag_draws(self.cable_m, 2),
                          _mag_draws(self.latency_s, 2))

    def draw(self, b: int) -> "LatencyStep":
        if self.num_draws is None:
            return self
        pick = (lambda v: None if v is None
                else np.asarray(v, np.float64)[b].copy())
        return LatencyStep(t=self.t, edges=self.edges,
                           cable_m=pick(self.cable_m),
                           latency_s=pick(self.latency_s),
                           reestablish=self.reestablish)

    def new_latency_s(self, omega_nom: float, velocity: float,
                      pipe_frames: float) -> np.ndarray:
        """(len(edges),) — or per-draw (B, len(edges)) — latency after
        the swap."""
        if self.latency_s is not None:
            lat = np.asarray(self.latency_s, np.float64)
        else:
            cable = np.asarray(self.cable_m, np.float64)
            lat = cable / velocity + pipe_frames / omega_nom
        shape = ((lat.shape[0], len(self.edges)) if lat.ndim == 2
                 else (len(self.edges),))
        return np.broadcast_to(lat, shape).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class FreqStep:
    """Step the unadjusted frequency of ``nodes`` by ``delta_ppm``.

    ``delta_ppm`` may be a (B,) array and/or ``nodes`` a sequence of B
    per-draw tuples for chaos campaigns (per-draw magnitudes/victims).
    """
    t: float
    nodes: Tuple[int, ...]
    delta_ppm: object

    def __post_init__(self):
        object.__setattr__(self, "nodes", _ids(self.nodes))

    @property
    def num_draws(self) -> Optional[int]:
        return _one_draws("FreqStep", _sel_draws(self.nodes),
                          _mag_draws(self.delta_ppm))

    def draw(self, b: int) -> "FreqStep":
        if self.num_draws is None:
            return self
        delta = self.delta_ppm
        if _mag_draws(delta) is not None:
            delta = float(np.asarray(delta, np.float64)[b])
        return FreqStep(t=self.t, nodes=_sel_row(self.nodes, b),
                        delta_ppm=delta)


@dataclasses.dataclass(frozen=True)
class DriftRamp:
    """Ramp the unadjusted frequency of ``nodes`` linearly.

    From ``t`` to ``t_end`` the nodes' ν_u drifts at ``rate_ppm_per_s``;
    the compiler discretizes the ramp to one constant step per telemetry
    record (total drift = rate · (t_end − t)).  ``rate_ppm_per_s`` may be
    a (B,) array and/or ``nodes`` a sequence of B per-draw tuples for
    chaos campaigns.
    """
    t: float
    t_end: float
    nodes: Tuple[int, ...]
    rate_ppm_per_s: object

    def __post_init__(self):
        object.__setattr__(self, "nodes", _ids(self.nodes))
        if self.t_end <= self.t:
            raise ValueError("DriftRamp needs t_end > t")

    @property
    def num_draws(self) -> Optional[int]:
        return _one_draws("DriftRamp", _sel_draws(self.nodes),
                          _mag_draws(self.rate_ppm_per_s))

    def draw(self, b: int) -> "DriftRamp":
        if self.num_draws is None:
            return self
        rate = self.rate_ppm_per_s
        if _mag_draws(rate) is not None:
            rate = float(np.asarray(rate, np.float64)[b])
        return DriftRamp(t=self.t, t_end=self.t_end,
                         nodes=_sel_row(self.nodes, b), rate_ppm_per_s=rate)


@dataclasses.dataclass(frozen=True)
class NodeHoldover:
    """Open the control loop of ``nodes`` (ν and controller state freeze).

    ``nodes`` may be a sequence of B per-draw tuples (per-draw victims).
    """
    t: float
    nodes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "nodes", _ids(self.nodes))

    @property
    def num_draws(self) -> Optional[int]:
        return _sel_draws(self.nodes)

    def draw(self, b: int) -> "NodeHoldover":
        if self.num_draws is None:
            return self
        return NodeHoldover(t=self.t, nodes=_sel_row(self.nodes, b))


@dataclasses.dataclass(frozen=True)
class NodeReset:
    """Close the control loop of ``nodes`` again (rejoin after holdover).

    ``nodes`` may be a sequence of B per-draw tuples (per-draw victims).
    """
    t: float
    nodes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "nodes", _ids(self.nodes))

    @property
    def num_draws(self) -> Optional[int]:
        return _sel_draws(self.nodes)

    def draw(self, b: int) -> "NodeReset":
        if self.num_draws is None:
            return self
        return NodeReset(t=self.t, nodes=_sel_row(self.nodes, b))


@dataclasses.dataclass(frozen=True)
class LinkDrop:
    """Take directed ``edges`` down: weight 0 in the error aggregation.

    ``edges`` may be a sequence of B per-draw tuples (per-draw victims —
    segment-sum or sparse engine; the dense adjacency stacks are shared
    across draws).
    """
    t: float
    edges: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "edges", _ids(self.edges))

    @property
    def num_draws(self) -> Optional[int]:
        return _sel_draws(self.edges)

    def draw(self, b: int) -> "LinkDrop":
        if self.num_draws is None:
            return self
        return LinkDrop(t=self.t, edges=_sel_row(self.edges, b))


@dataclasses.dataclass(frozen=True)
class LinkRestore:
    """Bring directed ``edges`` back up.

    ``reestablish=True`` (default) re-initializes each restored elastic
    buffer at its β0 setpoint, like the hardware's link bring-up; False
    resumes with the occupancy the (virtual) DDC drifted to meanwhile.
    ``edges`` may be a sequence of B per-draw tuples (per-draw victims —
    segment-sum or sparse engine).
    """
    t: float
    edges: Tuple[int, ...]
    reestablish: bool = True

    def __post_init__(self):
        object.__setattr__(self, "edges", _ids(self.edges))

    @property
    def num_draws(self) -> Optional[int]:
        return _sel_draws(self.edges)

    def draw(self, b: int) -> "LinkRestore":
        if self.num_draws is None:
            return self
        return LinkRestore(t=self.t, edges=_sel_row(self.edges, b),
                           reestablish=self.reestablish)


@dataclasses.dataclass(frozen=True)
class Reframe:
    """Rotate elastic-buffer read pointers at time ``t`` (frame rotation).

    edges: directed edges to rotate; None = every edge.
    shift: explicit integer pointer shifts in frames — a scalar or one
      value per listed edge.  None (default) computes the shifts from the
      live state at the splice.
    mode: shift assignment when ``shift`` is None — ``"per-edge"`` recenters
      each listed buffer to ``target`` independently (Δλ arbitrary per
      edge; the post-sync hardware reframing), ``"graph"`` solves the
      least-squares node-potential assignment from the per-node net
      occupancy (all cycle sums of λ — every RTT — conserved exactly).
    target: normalized occupancy setpoint (0 = half-full).

    Whatever the mode, each edge's logical latency shifts by EXACTLY the
    applied pointer shift and the occupancy moves with it — the
    frame-rotation invariant checked by the frame-level oracle.
    """
    t: float
    edges: Optional[Tuple[int, ...]] = None
    shift: Optional[object] = None
    mode: str = "per-edge"
    target: float = 0.0

    def __post_init__(self):
        if self.edges is not None:
            object.__setattr__(self, "edges", _ids(self.edges))
        if self.mode not in ("per-edge", "graph"):
            raise ValueError(f"unknown Reframe mode {self.mode!r}")
        if self.mode == "graph" and self.edges is not None:
            raise ValueError(
                "graph-mode Reframe rotates every edge (node potentials "
                "are global); leave edges=None")
        if self.shift is not None:
            sh = np.asarray(self.shift, np.float64)
            if np.any(sh != np.rint(sh)):
                raise ValueError("Reframe shifts are whole read-pointer "
                                 "steps; got non-integer values")

    def shifts_for(self, num_edges: int) -> np.ndarray:
        """(len(edges),) int64 explicit shifts (requires ``shift``)."""
        idx = self.edge_ids(num_edges)
        return np.broadcast_to(
            np.asarray(self.shift, np.int64), (len(idx),)).copy()

    def edge_ids(self, num_edges: int) -> Tuple[int, ...]:
        return tuple(range(num_edges)) if self.edges is None else self.edges


@dataclasses.dataclass(frozen=True)
class Scenario:
    """An ordered set of timed events over one simulation run.

    Events are applied in time order; simultaneous events compose in the
    listed order.  ``name`` labels telemetry and benchmark rows.
    """
    events: Tuple[object, ...]
    name: str = "scenario"

    def __post_init__(self):
        evs = tuple(sorted(self.events, key=lambda e: e.t))
        object.__setattr__(self, "events", evs)
        for e in evs:
            if e.t < 0:
                raise ValueError(f"event time {e.t} < 0")

    @property
    def horizon(self) -> float:
        """Latest event time (ramps count their end)."""
        t = 0.0
        for e in self.events:
            t = max(t, getattr(e, "t_end", e.t))
        return t

    @property
    def num_draws(self) -> Optional[int]:
        """Per-draw batch size implied by the events (None = shared).

        All per-draw events must agree on B; shared events broadcast.
        """
        return _one_draws(
            f"Scenario {self.name!r}",
            *[getattr(e, "num_draws", None) for e in self.events])

    def draw(self, b: int) -> "Scenario":
        """Scalarize every per-draw event to draw ``b``'s parameters.

        The returned single-draw scenario replays draw ``b`` standalone —
        the chaos campaign's shrink-to-repro export.
        """
        nd = self.num_draws
        if nd is not None and not (0 <= b < nd):
            raise IndexError(f"draw {b} out of range for {nd} draws")
        evs = tuple(e.draw(b) if getattr(e, "num_draws", None) is not None
                    else e for e in self.events)
        return Scenario(events=evs, name=f"{self.name}[draw {b}]")


def edges_between(topo, a: int, b: int) -> Tuple[int, ...]:
    """Indices of ALL directed edges between nodes a and b (both ways).

    A physical cable swap affects both directions of the link — pass the
    result to :class:`LatencyStep` / :class:`LinkDrop`.
    """
    src = np.asarray(topo.src)
    dst = np.asarray(topo.dst)
    hit = ((src == a) & (dst == b)) | ((src == b) & (dst == a))
    idx = tuple(int(e) for e in np.nonzero(hit)[0])
    if not idx:
        raise ValueError(f"no edges between nodes {a} and {b}")
    return idx
