"""Lower a Scenario into piecewise-constant parameter segments.

The simulation engines advance the frame model under *constant* physical
parameters (that is what lets one kernel launch fuse thousands of
control periods).  A dynamic scenario is therefore compiled into a list
of :class:`Segment`s — maximal runs of telemetry records over which every
parameter is constant — plus boundary actions (buffer re-establishment)
that the runner resolves against the live clock state.

Three compilation rules keep the whole scenario on ONE compiled kernel
per engine:

* **Record alignment.**  Event times snap to the telemetry record period
  ``cfg.dt · cfg.record_every`` (with a note if the snap moves an event
  by more than 1e-9 s).  Segments therefore tile the run exactly.
* **Uniform chunking.**  The kernels' grid length (``num_records``) is a
  compile key, so the runner replays fixed-size chunks: ``chunk_records``
  is the GCD of all segment lengths — every segment is a whole number of
  identically-shaped kernel launches, and the first launch's compilation
  serves all of them.
* **Global latency classes.**  The dense engines group edges into
  latency classes and the class *axis* keys the kernel shapes, so the
  compiler unions the latency values of every segment into one class
  vector (``lat_classes``).  A cable swap then only changes *which*
  class an edge occupies — traced data, not a shape.  If the union
  exceeds ``MAX_EXACT_CLASSES`` the values are quantum-merged globally
  and every segment's latencies are snapped to the merged grid (noted),
  keeping all engines consistent.

Ramps are discretized at record granularity: a :class:`DriftRamp`
becomes one single-record segment per record it spans, each stepping
ν_u by ``rate · record_period`` — piecewise-constant in the exact sense
the engines integrate.

Per-draw (chaos-campaign) lowering
----------------------------------
Events may carry per-draw magnitudes ((B,) step sizes / (B, K) swap
values) and per-draw victims (B per-draw node/edge tuples) — see
:mod:`repro_torch.scenarios.events`.  The compiler promotes each affected
rolling parameter to a (B, ·) array ONCE, before the first segment, so
the shape is constant across the whole scenario and every engine still
compiles exactly once:

* per-draw FreqStep/DriftRamp → ``dppm`` (B, N);
* per-draw LatencyStep → ``latency_s`` (B, E), with dense-engine
  support via *column-signature* classes: each distinct exact (B,)
  latency column is one global class, giving a per-draw class-value
  table ``per_draw_classes`` (B, C) plus per-segment edge→class maps
  ``seg_inv`` — traced data, never shapes;
* per-draw NodeHoldover/NodeReset → ``ctrl_mask`` (B, N);
* per-draw LinkDrop/LinkRestore → ``edge_w`` (B, E) (segment-sum or
  sparse engine — dense adjacency stacks are shared across draws).

``CompiledScenario.num_draws`` records the campaign batch (None for
plain shared scenarios — every shape then matches the pre-chaos
compiler bit-for-bit).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.frame_model import (LinkParams, PIPE_FRAMES,
                                    SIGNAL_VELOCITY, SimConfig)
from repro_torch.core.topology import Topology
from repro_torch.kernels.ops import MAX_EXACT_CLASSES, latency_classes

from .events import (DriftRamp, FreqStep, LatencyStep, LinkDrop, LinkRestore,
                     Mark, NodeHoldover, NodeReset, Reframe, Scenario)

__all__ = ["Segment", "CompiledScenario", "compile_scenario"]


@dataclasses.dataclass
class Segment:
    """A maximal run of records with constant physical parameters.

    ``latency_s`` keeps the base links' shape ((E,) or per-draw (B, E)).
    ``dppm`` / ``edge_w`` / ``ctrl_mask`` are (N,) / (E,) / (N,) shared
    rows, promoted to (B, ·) for the whole scenario when any event
    carries per-draw parameters for them.  ``reestablish`` lists edges
    whose elastic buffer re-initializes to its β0 setpoint at this
    segment's start — a shared tuple of edge ids, or B per-draw tuples
    when the triggering events had per-draw victims — resolved by the
    runner against the live ψ/ν state.  ``reframe`` lists the
    read-pointer rotations (:class:`repro_torch.scenarios.events.Reframe`)
    applied at this segment's start, likewise resolved against the live
    state when their shifts are implicit.  ``events`` are the events
    applied at the start (for reporting/plot annotation).
    """

    start_record: int
    records: int
    latency_s: np.ndarray
    dppm: np.ndarray                 # (N,)|(B,N) additive ν_u offset (ppm)
    edge_w: np.ndarray               # (E,)|(B,E) float32 error weights
    ctrl_mask: np.ndarray            # (N,)|(B,N) float32 controller enables
    reestablish: Tuple = ()
    reframe: Tuple[Reframe, ...] = ()
    events: Tuple[object, ...] = ()

    @property
    def t0_records(self) -> Tuple[int, int]:
        return self.start_record, self.start_record + self.records


@dataclasses.dataclass
class CompiledScenario:
    scenario: Scenario
    topo: Topology
    cfg: SimConfig
    segments: List[Segment]
    chunk_records: int
    lat_classes: Optional[np.ndarray]   # (C,) frames; None for (B, E) links
    notes: List[str]
    num_draws: Optional[int] = None     # campaign batch (None = shared)
    # Column-signature classes for per-draw (B, E) latencies: the (B, C)
    # class-value table + per-segment (E,) edge→class maps.  None when
    # latencies are shared (lat_classes applies) or when the per-draw
    # union exceeds MAX_EXACT_CLASSES (dense engines unavailable).
    per_draw_classes: Optional[np.ndarray] = None
    seg_inv: Optional[List[np.ndarray]] = None

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def total_records(self) -> int:
        return sum(s.records for s in self.segments)


def _snap_record(t: float, rec_period: float, total: int,
                 notes: List[str], what: str) -> int:
    r = int(round(t / rec_period))
    r = min(max(r, 0), total)
    if abs(r * rec_period - t) > 1e-9:
        notes.append(f"{what} at t={t:g}s snapped to record boundary "
                     f"t={r * rec_period:g}s")
    return r


def compile_scenario(scenario: Scenario, topo: Topology, links: LinkParams,
                     cfg: SimConfig) -> CompiledScenario:
    """Lower ``scenario`` to record-aligned piecewise-constant segments."""
    notes: List[str] = []
    rec_period = cfg.dt * cfg.record_every
    total = cfg.steps // cfg.record_every
    if total < 1:
        raise ValueError("cfg.steps must be >= cfg.record_every")
    if scenario.horizon > total * rec_period + 1e-12:
        notes.append(
            f"scenario horizon {scenario.horizon:g}s exceeds the simulated "
            f"{total * rec_period:g}s; late events are dropped")

    n, e = topo.num_nodes, topo.num_edges
    num_draws = scenario.num_draws
    if links.num_draws is not None:
        if num_draws not in (None, links.num_draws):
            raise ValueError(
                f"scenario per-draw events (B={num_draws}) disagree with "
                f"the links batch (B={links.num_draws})")
        num_draws = links.num_draws

    # Promote each rolling parameter to (B, ·) up front iff any event
    # carries per-draw values for it — the shape then never changes
    # across segments, preserving the one-compile guarantee.
    lat_pd = np.asarray(links.latency_s).ndim == 2
    dppm_pd = mask_pd = w_pd = False
    for ev in scenario.events:
        if getattr(ev, "num_draws", None) is None:
            continue
        if isinstance(ev, (FreqStep, DriftRamp)):
            dppm_pd = True
        elif isinstance(ev, LatencyStep):
            lat_pd = True
        elif isinstance(ev, (NodeHoldover, NodeReset)):
            mask_pd = True
        elif isinstance(ev, (LinkDrop, LinkRestore)):
            w_pd = True

    # Rolling parameter state, mutated as boundaries are applied in order.
    lat = np.array(np.asarray(links.latency_s, np.float64), copy=True)
    if lat_pd and lat.ndim == 1:
        lat = np.tile(lat, (num_draws, 1))
    dppm = np.zeros((num_draws, n) if dppm_pd else n, np.float64)
    edge_w = np.ones((num_draws, e) if w_pd else e, np.float32)
    mask = np.ones((num_draws, n) if mask_pd else n, np.float32)

    # record index -> ordered list of events to apply at that boundary.
    boundary_events: dict = {}

    def at(r: int, ev) -> None:
        boundary_events.setdefault(r, []).append(ev)

    for ev in scenario.events:
        if isinstance(ev, DriftRamp):
            r0 = _snap_record(ev.t, rec_period, total, notes, "DriftRamp")
            r1 = _snap_record(ev.t_end, rec_period, total, notes,
                              "DriftRamp end")
            rate = np.asarray(ev.rate_ppm_per_s, np.float64)
            step = rate * rec_period if rate.ndim else float(rate) * rec_period
            for r in range(r0, r1):
                # One constant ν_u step per record, applied at the record
                # start: a staircase that leads the true ramp by up to one
                # record period but lands on the exact total drift.
                at(r, FreqStep(t=r * rec_period, nodes=ev.nodes,
                               delta_ppm=step))
            continue
        r = _snap_record(ev.t, rec_period, total, notes,
                         type(ev).__name__)
        if r >= total:
            notes.append(f"{type(ev).__name__} at t={ev.t:g}s lands at or "
                         "after the end of the run; dropped")
            continue
        at(r, ev)

    def edge_cols(arr: np.ndarray, idx, values) -> None:
        """Assign new per-edge values into (E,) or per-draw (B, E) lat."""
        values = np.asarray(values, np.float64)
        if arr.ndim == 2 and values.ndim == 1:
            arr[:, list(idx)] = values[None, :]
        elif arr.ndim == 2:
            arr[:, list(idx)] = values
        else:
            arr[list(idx)] = values

    def set_sel(arr: np.ndarray, sel, value: float) -> None:
        """Assign into (X,)/(B, X) state under a shared or per-draw
        selection (B per-draw tuples)."""
        if _per_draw_sel(sel):
            for di, row in enumerate(sel):
                arr[di, list(row)] = value
        elif arr.ndim == 2:
            arr[:, list(sel)] = value
        else:
            arr[list(sel)] = value

    def bump_sel(arr: np.ndarray, sel, delta) -> None:
        """Add a shared or per-draw (B,) delta under a shared or
        per-draw selection."""
        d = np.asarray(delta, np.float64)
        if _per_draw_sel(sel):
            for di, row in enumerate(sel):
                arr[di, list(row)] += d[di] if d.ndim else d
        elif arr.ndim == 2 and d.ndim == 1:
            arr[:, list(sel)] += d[:, None]
        elif arr.ndim == 2:
            arr[:, list(sel)] += d
        else:
            arr[list(sel)] += d

    segments: List[Segment] = []
    boundaries = sorted(set(boundary_events) | {0, total})
    for bi, r in enumerate(boundaries[:-1]):
        evs = boundary_events.get(r, [])
        reest: List[Tuple] = []
        refr: List[Reframe] = []
        for ev in evs:
            if isinstance(ev, Mark):
                pass
            elif isinstance(ev, Reframe):
                # A rotation changes no engine parameter shape or value
                # that the compiler tracks — the runner resolves the λeff
                # rewrite against the live state at this boundary.
                refr.append(ev)
            elif isinstance(ev, LatencyStep):
                new = ev.new_latency_s(cfg.omega_nom, SIGNAL_VELOCITY,
                                       PIPE_FRAMES)
                edge_cols(lat, ev.edges, new)
                if ev.reestablish:
                    reest.append(ev.edges)
            elif isinstance(ev, FreqStep):
                bump_sel(dppm, ev.nodes, ev.delta_ppm)
            elif isinstance(ev, NodeHoldover):
                set_sel(mask, ev.nodes, 0.0)
            elif isinstance(ev, NodeReset):
                set_sel(mask, ev.nodes, 1.0)
            elif isinstance(ev, LinkDrop):
                set_sel(edge_w, ev.edges, 0.0)
            elif isinstance(ev, LinkRestore):
                set_sel(edge_w, ev.edges, 1.0)
                if ev.reestablish:
                    reest.append(ev.edges)
            else:
                raise TypeError(f"unknown event type {type(ev).__name__}")
        r_next = boundaries[bi + 1]
        segments.append(Segment(
            start_record=r, records=r_next - r,
            latency_s=lat.copy(), dppm=dppm.copy(),
            edge_w=edge_w.copy(), ctrl_mask=mask.copy(),
            reestablish=_merge_reest(reest, num_draws),
            reframe=tuple(refr),
            events=tuple(evs)))

    chunk = 0
    for s in segments:
        chunk = math.gcd(chunk, s.records)

    lat_classes, pd_classes, seg_inv = _global_classes(
        segments, cfg.omega_nom, notes)
    return CompiledScenario(scenario=scenario, topo=topo, cfg=cfg,
                            segments=segments, chunk_records=chunk,
                            lat_classes=lat_classes, notes=notes,
                            num_draws=num_draws,
                            per_draw_classes=pd_classes, seg_inv=seg_inv)


def _per_draw_sel(sel) -> bool:
    """True for per-draw selections (a tuple of B per-draw tuples)."""
    return bool(sel) and isinstance(sel[0], tuple)


def _merge_reest(sels: List[Tuple], num_draws: Optional[int]) -> Tuple:
    """Merge re-establish selections from one boundary's events.

    All-shared selections merge to one deduplicated edge tuple (the
    pre-chaos behaviour).  If any selection is per-draw, everything is
    promoted to B per-draw tuples (shared edges replicate into every
    draw's row).
    """
    if not sels:
        return ()
    if not any(_per_draw_sel(s) for s in sels):
        out: List[int] = []
        for s in sels:
            out.extend(s)
        return tuple(dict.fromkeys(out))
    rows: List[List[int]] = [[] for _ in range(num_draws)]
    for s in sels:
        if _per_draw_sel(s):
            for di, row in enumerate(s):
                rows[di].extend(row)
        else:
            for row in rows:
                row.extend(s)
    return tuple(tuple(dict.fromkeys(r)) for r in rows)


def _global_classes(segments: List[Segment], omega_nom: float,
                    notes: List[str]):
    """Union of every segment's latency values, as one global class set.

    Returns ``(lat_classes, per_draw_classes, seg_inv)``.  For shared
    latencies: the (C,) class vector in frames the dense engines compile
    against (quantum-merged above MAX_EXACT_CLASSES, with every
    segment's latencies snapped to the merged grid so all engines
    integrate identical values), and ``(None, None)`` for the per-draw
    fields.  For per-draw (B, E) latencies: ``lat_classes`` is None and
    the column-signature scheme of :func:`_per_draw_column_classes`
    provides the dense-engine class table instead.
    """
    if any(np.asarray(s.latency_s).ndim == 2 for s in segments):
        pd_classes, seg_inv = _per_draw_column_classes(
            segments, omega_nom, notes)
        return None, pd_classes, seg_inv
    frames = np.unique(np.concatenate(
        [np.asarray(s.latency_s, np.float64) * omega_nom for s in segments]))
    # One shared merge policy: the spread-adaptive quantum grouping lives
    # in repro_torch.kernels.ops.latency_classes (no-op below MAX_EXACT_CLASSES).
    merged = np.asarray(latency_classes(frames, warn=False)[0], np.float64)
    if len(merged) == len(frames):
        return frames, None, None
    notes.append(
        f"{len(frames)} distinct latencies across segments > "
        f"{MAX_EXACT_CLASSES} classes; quantum-merged to {len(merged)} "
        "(all engines integrate the merged grid)")
    for s in segments:
        f = np.asarray(s.latency_s, np.float64) * omega_nom
        snapped = merged[np.abs(f[:, None] - merged[None, :]).argmin(axis=1)]
        s.latency_s = snapped / omega_nom
    return merged, None, None


def _per_draw_column_classes(segments: List[Segment], omega_nom: float,
                             notes: List[str]):
    """Column-signature latency classes for per-draw (B, E) segments.

    Each distinct exact (B,) latency column — bitwise equality, no
    tolerance — is one class, shared globally across segments.  The
    dense engines then integrate a per-draw class-value table
    ``per_draw_classes`` (B, C) frames with per-segment edge→class maps
    ``seg_inv`` ((E,) int64): a cable swap moves an edge between
    columns of a fixed-shape table, traced data only.  Returns
    ``(None, None)`` with a note when the union exceeds
    MAX_EXACT_CLASSES (dense engines unavailable; segment-sum exact).
    """
    cols: dict = {}
    columns: List[np.ndarray] = []
    seg_inv: List[np.ndarray] = []
    for s in segments:
        lf = np.asarray(s.latency_s, np.float64) * omega_nom  # (B, E)
        inv = np.empty(lf.shape[1], np.int64)
        for ei in range(lf.shape[1]):
            key = lf[:, ei].tobytes()
            ci = cols.get(key)
            if ci is None:
                ci = cols[key] = len(columns)
                columns.append(lf[:, ei].copy())
            inv[ei] = ci
        seg_inv.append(inv)
    if len(columns) > MAX_EXACT_CLASSES:
        notes.append(
            f"{len(columns)} distinct per-draw latency columns across "
            f"segments > {MAX_EXACT_CLASSES} classes; dense engines "
            "unavailable (segment-sum runs exact)")
        return None, None
    return np.stack(columns, axis=1), seg_inv
