"""Execute a compiled scenario by chaining the simulation engines.

Port of ``repro.scenarios.runner``.  The runner walks the compiled
segments in order and, inside each segment, replays fixed-size chunks of
``chunk_records`` telemetry records through ONE simulation engine,
threading the full simulator state — ψ, ν, the controller state, and the
per-edge λeff constants — across every boundary.  Every segment
parameter (link latencies, λeff folds, edge weights, controller masks,
gains, ν_u) is data, never a kernel build key, so a whole scenario
selects each kernel variant once (``compile_stats`` in the trace).

Engines:

``segment-sum``   the edge-list simulator (:func:`repro_torch.core.simulate`
                  / ``simulate_ensemble``) — per-edge (T, E) β telemetry,
                  every controller kind, quantization, telemetry noise,
                  fully heterogeneous per-draw (B, E) links and per-draw
                  link drops.  The default.
``fused``/``tiled``/``auto``
                  the dense kernel lanes (``bittide_fused`` /
                  ``bittide_tiled``), driven at the engine layer — ν
                  telemetry plus, with ``Telemetry(beta=True)``, in-kernel
                  per-node net occupancy (T, N) β (frames); proportional
                  controller, shared base links (per-draw λeff from
                  re-establishment is supported).  Every segment's stack
                  is built ONCE up front in the kernels' layout
                  (:func:`_build_dense_stacks`: diff-updates between
                  segments, repeated parameter sets deduped, each unique
                  stack placed on the device a single time); ψ and ν stay
                  on the device between chunks, and only the records and
                  the guard's trip records come to the host.
``sparse``        the ELL lane (``bittide_sparse``) — the dense lanes'
                  telemetry and guard on slot tables built ONCE per unique
                  (latency, weight) set (:func:`_build_sparse_tables`) and
                  placed on the device once; the only kernel lane for
                  per-draw LinkDrop / LinkRestore victims and fully
                  heterogeneous per-draw latencies.  ``auto`` takes it
                  when the regime table, probed with the degree bound,
                  puts the network beyond the dense lanes.
``per-step``      the dense lanes' contract on ``bittide_perstep`` (one
                  draw per launch, one launch per period): the draws of a
                  chunk launch one after another, each with its own
                  ``lamsum`` row (no per-draw λeff stack), and when their
                  guard trips differ the draws that ran past the earliest
                  trip run again with the stop cap there (the host resync
                  that stands in for the batch-wide freeze).

λeff semantics (see :mod:`repro_torch.scenarios.events`): a plain
LatencyStep keeps λeff constant — occupancy is continuous through the
swap and the logical latency λ = λeff + ω·l shifts by exactly the
in-flight frame count (the paper's Table 2).  ``reestablish`` recomputes
λeff from the live state so the buffer restarts at its β0 setpoint.

Closed-loop buffer re-centering (``Telemetry(guard=...)``): on the kernel
lanes the guard runs inside the kernel — every measure pass compares the
per-node net occupancy against the per-draw degree-scaled band
``target ± (depth/2 − margin)`` and freezes the chunk at the first
tripping record, so the splice lands one record period after the
crossing, and the resumed partial chunk runs through the kernels' stop
cap.  On segment-sum the runner inspects each completed chunk's per-edge
record through the Laplacian pseudo-inverse (exposure up to one chunk).
When tripped, the runner splices an RTT-conserving pointer rotation
computed from the live threaded state
(:func:`repro_torch.core.reframing.shift_assignment`); the rotation
rewrites only data inputs (the ``lamsum`` fold on the kernel lanes,
``links.beta0`` on segment-sum).  Batched runs trip and rotate per draw.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.envelopes import laplacian, reframe_guard_margins
from repro_torch.core.frame_model import (EB_INIT, LinkParams, SimConfig,
                                          _convergence_time, broadcast_gain,
                                          simulate, simulate_ensemble)
from repro_torch.core.reframing import (ReframePolicy, edge_occupancy,
                                        node_net_occupancy, shift_assignment)
from repro_torch.core.topology import Topology
from repro_torch.kernels.api import EngineOptions, EngineOutputs
from repro_torch.kernels.bittide_sparse import ellify
from repro_torch.kernels.bittide_step import (TILE_J, select_engine,
                                              sparse_tile)
from repro_torch.kernels.ops import (_auto_is_sparse, _fused_engine,
                                     _host_watermarks, _lamsum_host,
                                     _perstep_engine, _resolve_mask,
                                     _sparse_engine, latency_classes)
from repro_torch.telemetry import Watermarks, coerce_trace, compile_stats
from repro_torch.telemetry.api import resolve_telemetry

from .compiler import CompiledScenario, compile_scenario
from .events import Scenario

__all__ = ["AppliedReframe", "ScenarioResult", "run_scenario"]

_DENSE_ENGINES = ("auto", "fused", "tiled", "per-step")


def _guard_band(b: int, target: float, guard_rows, dev):
    """(B,) float32 in-kernel guard band edges (frames per unit degree)."""
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    rows = np.broadcast_to(np.asarray(guard_rows, np.float64), (b,))
    return put(target - rows), put(target + rows)


@dataclasses.dataclass(frozen=True)
class AppliedReframe:
    """One pointer rotation the runner spliced into a scenario.

    record: global record index the rotation precedes (the shift is live
      from this record on); time: the same boundary in seconds.
    shift: integer read-pointer shifts in frames — (E,), or (B, E) when a
      batched run's draws rotated independently.  Δλ per edge equals the
      shift exactly (the frame-rotation invariant).
    auto: True for guard-band splices, False for explicit Reframe events.
    guard_latency: records of exposure between the guard crossing and the
      splice — 1 on the kernel lanes (the in-kernel guard freezes the
      chunk at the trip record, so the rotation lands one record period
      after the crossing), ``chunk − crossing_offset`` on the
      host-inspected segment-sum lane (the trip is only visible once the
      chunk returns), 0 for explicit Reframe events.
    """

    record: int
    time: float
    shift: np.ndarray
    auto: bool
    guard_latency: int = 0


@dataclasses.dataclass
class ScenarioResult:
    """Concatenated telemetry + final state of a scenario run.

    ``freq_ppm`` is (T, N) for a single run or (B, T, N) for an ensemble.

    ``beta`` is the occupancy telemetry in *frames* (empty when β
    recording is off):

    * segment-sum engine — per-edge, (T, E) / (B, T, E);
    * dense and sparse kernel lanes with ``record_beta=True`` — in-kernel
      per-node net occupancy Σ_{e→i} w_e·β_e, (T, N) / (B, T, N).
      Dropped links (weight 0) leave the aggregation, so the stream
      covers live links only.

    ``lam`` is the (S, E) logical-latency table per segment —
    ``rint(EB_INIT + λeff + ω·l)`` with draw-0 values when λeff is
    per-draw — whose successive differences are the Table-2 latency
    shifts.  Rows are segment-START snapshots: rotations
    ``auto_reframe`` splices mid-segment appear in ``reframes`` and in
    :attr:`lam_final`, not in ``lam`` (graph-mode rotations conserve
    every RTT, so ``rtt()`` is unaffected either way).
    """

    freq_ppm: np.ndarray
    beta: np.ndarray
    times: np.ndarray
    psi: np.ndarray
    nu: np.ndarray
    c_state: dict
    lam: np.ndarray
    lam_eff: np.ndarray
    segment_records: np.ndarray
    segment_times: np.ndarray
    topo: Topology
    links: LinkParams
    ctrl: ControllerConfig
    cfg: SimConfig
    compiled: CompiledScenario
    engine: str
    tile_j: int
    chunk_records: int
    num_launches: int
    # Pointer rotations spliced into the run (explicit Reframe events and
    # auto_reframe guard trips), in record order.
    reframes: List[AppliedReframe] = dataclasses.field(default_factory=list)
    # In-kernel O(N) excursion aggregates (``record_watermarks=True``) —
    # chunk-merged across the whole run, (N,)/(B, N) — else None.
    watermarks: Optional[Watermarks] = None
    # The flight-recorder RunTrace when the run was traced, else None.
    trace: object = None

    @property
    def scenario(self) -> Scenario:
        return self.compiled.scenario

    @property
    def total_reframe_shift(self) -> np.ndarray:
        """(E,) (or (B, E)) accumulated pointer shift over all rotations —
        the net λ the run traded for buffer headroom (zeros if none)."""
        total = np.zeros(self.topo.num_edges, np.int64)
        for r in self.reframes:
            total = total + np.asarray(r.shift, np.int64)
        return total

    def convergence_time(self, band_ppm: float = 1.0,
                         after_s: float = 0.0) -> float:
        """First recorded time >= after_s from which the frequency band
        stays within band_ppm — re-settling time when measured after an
        event.  Single-run results only (index draws for ensembles)."""
        if self.freq_ppm.ndim != 2:
            raise ValueError("convergence_time on an ensemble result: "
                             "slice a draw first (freq_ppm[b])")
        sel = self.times >= after_s
        spread = (self.freq_ppm[sel].max(axis=1)
                  - self.freq_ppm[sel].min(axis=1))
        return _convergence_time(spread, self.times[sel], band_ppm)

    @property
    def lam_final(self) -> np.ndarray:
        """(E,) logical latencies at the END of the run.

        Unlike ``lam[-1]`` (a segment-START snapshot), this is computed
        from the final λeff and therefore includes every rotation
        ``auto_reframe`` spliced mid-segment."""
        return _lam_table(self.lam_eff,
                          self.compiled.segments[-1].latency_s,
                          self.cfg.omega_nom)

    def rtt(self, seg: int = -1) -> np.ndarray:
        """(E,) round-trip logical latency table of one segment (start)."""
        lam = self.lam[seg]
        return lam + lam[self.topo.reverse_edge_index()]

    def lam_shift(self, seg_a: int = 0, seg_b: int = -1) -> np.ndarray:
        """(E,) per-edge logical-latency shift between two segments."""
        return self.lam[seg_b] - self.lam[seg_a]


def _lam_table(lam_eff, lat_s, omega_nom: float) -> np.ndarray:
    """(E,) logical latencies λ = rint(EB_INIT + λeff + ω·l), draw 0."""
    le = np.asarray(lam_eff, np.float64)
    ls = np.asarray(lat_s, np.float64)
    if le.ndim == 2:
        le = le[0]
    if ls.ndim == 2:
        ls = ls[0]
    return np.rint(EB_INIT + le + ls * omega_nom).astype(np.int64)


def _apply_reestablish(lam_eff, edges, beta0_base, psi, nu, lat_frames,
                       topo: Topology):
    """Recompute λeff of ``edges`` so β(t+) equals the β0 setpoint.

    Solves ψ_src − ν_src·ω·l + λeff − ψ_dst = β0 against the live state;
    promotes λeff to per-draw (B, E) when the state is batched (each
    draw's clocks re-establish at different phases).

    ``edges`` is a shared edge-id tuple, or — per-draw victims from a
    chaos campaign — a tuple of B per-row tuples, in which case each
    draw's rows re-establish independently against its own state.
    """
    psi = np.asarray(psi, np.float64)
    nu = np.asarray(nu, np.float64)
    lam_eff = np.asarray(lam_eff, np.float64)
    if edges and isinstance(edges[0], tuple):
        rows = psi.shape[0]
        if lam_eff.ndim == 1:
            lam_eff = np.tile(lam_eff, (rows, 1))
        lat2 = np.broadcast_to(np.asarray(lat_frames, np.float64),
                               lam_eff.shape)
        beta2 = np.broadcast_to(np.asarray(beta0_base, np.float64),
                                lam_eff.shape)
        for bi, row in enumerate(edges):
            if row:
                lam_eff[bi] = _apply_reestablish(
                    lam_eff[bi], row, beta2[bi], psi[bi], nu[bi], lat2[bi],
                    topo)
        return lam_eff
    if psi.ndim == 2 and lam_eff.ndim == 1:
        lam_eff = np.tile(lam_eff, (psi.shape[0], 1))
    idx = list(edges)
    src = np.asarray(topo.src)[idx]
    dst = np.asarray(topo.dst)[idx]
    target = np.asarray(beta0_base, np.float64)[..., idx]
    lf = np.asarray(lat_frames, np.float64)[..., idx]
    lam_eff[..., idx] = (target - psi[..., src] + nu[..., src] * lf
                         + psi[..., dst])
    return lam_eff


def _rotation_shifts(topo: Topology, lam_eff, psi, nu, lat_frames, edge_w,
                     mode: str, target: float, edges=None, explicit=None,
                     lap_pinv=None, rows_mask=None):
    """Resolve a pointer rotation against the live state.

    Args:
      lam_eff: live λeff fold, (E,) or per-draw (B, E) frames.
      psi, nu: live state, (N,) or (B, N) (exact threaded values — every
        engine computes identical shifts from them).
      lat_frames: physical latencies in frames, (E,) or (B, E).
      mode/target/edges/explicit: the rotation spec — explicit integer
        shifts, or state-computed "per-edge" (independent recentering to
        ``target``) / "graph" (RTT-conserving potential assignment from
        the per-node net occupancy) shifts.
      rows_mask: optional (B,) bool — rotate only these draws (the
        auto-reframe guard passes its per-draw trip vector); untripped
        rows keep their λeff and report zero shift.

    Returns ``(lam_eff_new, shift)``.  λeff is promoted to per-draw only
    when the shifts are state-dependent and the state is batched
    (explicit shifts stay shared across draws).
    """
    lam = np.asarray(lam_eff, np.float64)
    e = topo.num_edges
    idx = list(range(e)) if edges is None else list(edges)
    if explicit is not None:
        sh = np.zeros(e, np.int64)
        sh[idx] = np.broadcast_to(np.asarray(explicit, np.int64), (len(idx),))
        return lam + sh, sh
    psi = np.asarray(psi, np.float64)
    nu = np.asarray(nu, np.float64)
    batched = psi.ndim == 2
    if batched and lam.ndim == 1:
        lam = np.tile(lam, (psi.shape[0], 1))
    rows = psi.shape[0] if batched else 1
    lam_rows = lam.reshape(rows, e)
    psi_rows = psi.reshape(rows, -1)
    nu_rows = nu.reshape(rows, -1)
    lat_rows = np.broadcast_to(np.asarray(lat_frames, np.float64),
                               (rows, e))
    if rows_mask is not None:
        rows_mask = np.broadcast_to(
            np.asarray(rows_mask, bool).reshape(-1), (rows,))
    shifts = np.zeros((rows, e), np.int64)
    for bi in range(rows):
        if rows_mask is not None and not rows_mask[bi]:
            continue
        beta = edge_occupancy(topo, psi_rows[bi], nu_rows[bi], lat_rows[bi],
                              lam_rows[bi])
        # The ONE shift-assignment rule (shared with reframe_state);
        # the auto path reuses the guard's cached Laplacian pinv.
        shifts[bi] = shift_assignment(topo, beta, edge_w, mode, target,
                                      edges=edges, lap_pinv=lap_pinv)[1]
    lam_new = lam_rows + shifts
    if not batched:
        return lam_new[0], shifts[0]
    return lam_new, shifts


class _DenseStacks:
    """Per-segment dense stacks, built once per scenario run.

    ``a_t[si]`` is segment ``si``'s (C, N, N) float32 stack on the device
    in the kernels' source-major layout (``a_t[c, j, i] = A[c, i, j]``)
    over the scenario's global latency-class axis, and ``deg[si]`` its
    (N,) degree fold.  The builder walks the segments once on the host,
    diff-updating one master array — only the edges whose class or weight
    changed are touched — and dedupes identical parameter sets, so each
    unique stack is transferred and folded once per run however many
    chunks replay it.  No dense λeff tensor exists: the kernels fold λeff
    into the per-node ``lamsum`` rows.
    """

    def __init__(self, a_t: List, deg: List, classes, class_rows=None):
        self.a_t = a_t
        self.deg = deg
        self.classes = classes          # (C,) shared class values, or None
        self.class_rows = class_rows    # (B, C) per-draw values, or None


def _build_dense_stacks(topo: Topology, comp, cfg: SimConfig,
                        dev) -> _DenseStacks:
    """Build every segment's (C, N, N) stack up front (see
    :class:`_DenseStacks`).  Under per-draw column-signature latency
    classes the compiler has already assigned every segment's edges to
    the global class axis (``comp.seg_inv``)."""
    per_draw = comp.per_draw_classes
    if per_draw is not None:
        classes = None
        c = per_draw.shape[1]
    else:
        classes = np.asarray(comp.lat_classes, np.float64)
        c = len(classes)
    n = topo.num_nodes
    dst = np.asarray(topo.dst, np.int64)
    src = np.asarray(topo.src, np.int64)
    # float64 master: diff-updates subtract and re-add edge weights, which
    # stays exact for the 0/1-ish weights but would accumulate rounding in
    # float32 over many segments.
    master = np.zeros((c, n, n), np.float64)
    prev_inv = prev_w = None
    by_key, a_list, deg_list = {}, [], []
    for si, seg in enumerate(comp.segments):
        if per_draw is not None:
            inv = np.asarray(comp.seg_inv[si], np.int64)
        else:
            lat_frames = (np.asarray(seg.latency_s, np.float64)
                          * cfg.omega_nom)
            _, inv = latency_classes(lat_frames, lat_classes=classes)
            inv = np.asarray(inv, np.int64)
        w = np.asarray(seg.edge_w, np.float64)
        if prev_inv is None:
            np.add.at(master, (inv, src, dst), w)
        else:
            ch = np.nonzero((inv != prev_inv) | (w != prev_w))[0]
            if len(ch):
                np.add.at(master, (prev_inv[ch], src[ch], dst[ch]),
                          -prev_w[ch])
                np.add.at(master, (inv[ch], src[ch], dst[ch]), w[ch])
        prev_inv, prev_w = inv, w
        key = (inv.tobytes(), w.tobytes())
        if key not in by_key:
            a_t = torch.as_tensor(master.astype(np.float32), device=dev)
            by_key[key] = (a_t, a_t.sum(dim=(0, 1)))
        a_list.append(by_key[key][0])
        deg_list.append(by_key[key][1])
    return _DenseStacks(a_list, deg_list, classes, class_rows=per_draw)


def _prep_dense_segment(topo: Topology, links_seg: LinkParams, seg,
                        ctrl: ControllerConfig, ppm2d: np.ndarray,
                        engine: str, stacks: _DenseStacks, seg_index: int,
                        dev) -> dict:
    """Host-side prep for one dense segment (done once per segment).

    Picks up the precomputed stack, folds λeff into the (B, N) ``lamsum``
    rows (per-draw when re-establishment made λeff per-draw), and puts
    the class latencies, mask, ν_u and gains on the device.  The chunk
    loop then replays the engine on device-resident state with no further
    host work.
    """
    b, n = ppm2d.shape
    beta0 = np.asarray(links_seg.beta0, np.float64)
    beta0_rows = beta0 if beta0.ndim == 2 else beta0[None]
    a_t = stacks.a_t[seg_index]
    c = a_t.shape[0]
    chosen = select_engine(b, n, c)[0] if engine == "auto" else engine
    lamsum = np.broadcast_to(
        _lamsum_host(topo, beta0_rows, seg.edge_w, beta0_rows.shape[0]),
        (b, n))
    if stacks.class_rows is not None:
        lat = stacks.class_rows             # per-draw class values (B, C)
    else:
        lat = np.broadcast_to(np.asarray(stacks.classes, np.float32)[None],
                              (b, c))
    put = lambda x: torch.as_tensor(np.array(x, np.float32, order="C"),
                                    device=dev)
    kp = broadcast_gain(ctrl.kp, b)
    beta_off = broadcast_gain(ctrl.beta_off, b, "beta_off")
    return dict(
        a_t=a_t, deg=stacks.deg[seg_index], lamsum=put(lamsum), lat=put(lat),
        mask=put(_resolve_mask(seg.ctrl_mask, b, n)),
        nu_u=put(ppm2d * np.float32(1e-6)), kp=put(kp),
        beta_off=put(beta_off), kp_host=kp, beta_off_host=beta_off,
        engine=chosen,
        tile_j={"tiled": min(TILE_J, n), "per-step": 0}.get(chosen, n))


def _build_sparse_tables(topo: Topology, comp, cfg: SimConfig, dev):
    """Every segment's ELL slot tables, built once per scenario run.

    Returns ``(nbr, latf, w)``: the (K, N) int32 neighbour table, shared by
    every segment, and per segment ``latf[si]`` / ``w[si]``, its (R, K, N)
    slot latency (frames) and weight tables (R = 1 shared, B per-draw) on
    the device.  One :func:`ellify` and one device placement per unique
    (latency, weight) parameter set, so swap-back segments reuse one
    buffer.  Dropped links keep their slot at weight 0, so every shape is
    constant across the scenario."""
    nbr = None
    by_key, latf_list, w_list = {}, [], []
    for seg in comp.segments:
        lat_f = np.asarray(seg.latency_s, np.float64) * cfg.omega_nom
        w_np = np.asarray(seg.edge_w, np.float64)
        key = (lat_f.shape, lat_f.tobytes(), w_np.shape, w_np.tobytes())
        if key not in by_key:
            nbr_h, latf_h, w_h = ellify(topo, lat_f, edge_w=w_np)
            if nbr is None:
                nbr = torch.as_tensor(nbr_h, device=dev)
            by_key[key] = (torch.as_tensor(latf_h, device=dev),
                           torch.as_tensor(w_h, device=dev))
        latf_list.append(by_key[key][0])
        w_list.append(by_key[key][1])
    return nbr, latf_list, w_list


def _prep_sparse_segment(topo: Topology, links_seg: LinkParams, seg,
                         ctrl: ControllerConfig, ppm2d: np.ndarray,
                         tables, seg_index: int, dev) -> dict:
    """Host-side prep for one sparse segment (once per segment).

    Mirrors :func:`_prep_dense_segment`: picks up the precomputed slot
    tables and folds λeff into the (B, N) ``lamsum`` rows — per draw when
    re-establishment, a rotation or per-draw edge weights made the fold
    per-draw — and puts the mask, ν_u and gains on the device.
    """
    b, n = ppm2d.shape
    beta0 = np.asarray(links_seg.beta0, np.float64)
    w_np = np.asarray(seg.edge_w, np.float64)
    rows = b if (beta0.ndim == 2 or w_np.ndim == 2) else 1
    lamsum = np.broadcast_to(
        _lamsum_host(topo, beta0 if beta0.ndim == 2 else beta0[None], w_np,
                     rows), (b, n))
    put = lambda x: torch.as_tensor(np.array(x, np.float32, order="C"),
                                    device=dev)
    return dict(
        latf=tables[1][seg_index], w=tables[2][seg_index],
        lamsum=put(lamsum), mask=put(_resolve_mask(seg.ctrl_mask, b, n)),
        nu_u=put(ppm2d * np.float32(1e-6)),
        kp=put(broadcast_gain(ctrl.kp, b)),
        beta_off=put(broadcast_gain(ctrl.beta_off, b, "beta_off")),
        engine="sparse", tile_j=sparse_tile(n))


def _perstep_chunk(psi_d, nu_d, prep: dict, dt_frames: float, chunk: int,
                   record_every: int, record_beta: bool,
                   record_watermarks: bool, guard_on: bool, policy,
                   guard_rows, stop: int) -> EngineOutputs:
    """One chunk of the per-step lane for every draw, as one (B, ...)
    :class:`EngineOutputs` (``guard_state`` (B, 1) int32).

    The draws launch one after another, each with its own ``lamsum`` row,
    class latencies, mask row and gains.  The kernel lanes freeze the
    whole batch at its earliest trip t*; here each draw freezes at its
    own, so when the trips differ the draws that ran past t* run the chunk
    again from the same inputs with the stop cap at t* — a draw's records
    up to the cap do not depend on the cap, so the batch lands exactly at
    t*.
    """
    b = psi_d.shape[0]
    mask = prep["mask"]

    def launch(bi: int, stop_i: int) -> EngineOutputs:
        band = (None, None)
        if guard_on:
            band = (policy.target - guard_rows[bi],
                    policy.target + guard_rows[bi])
        return _perstep_engine(
            psi_d[bi], nu_d[bi], prep["nu_u"][bi], mask[bi % mask.shape[0]],
            prep["a_t"], prep["deg"], prep["lamsum"][bi], prep["lat"][bi],
            float(prep["kp_host"][bi]), float(prep["beta_off_host"][bi]),
            dt_frames, chunk, record_every, record_beta, record_watermarks,
            record_guard=guard_on, guard_lo=band[0], guard_hi=band[1],
            guard_stop=stop_i if guard_on else None)

    rows = [launch(bi, stop) for bi in range(b)]
    trips = None
    if guard_on:
        trips = torch.stack([r.guard_state for r in rows])
        trips_h = trips.cpu().numpy()
        tstar = int(trips_h.min())
        if tstar <= stop:
            for bi in np.flatnonzero(trips_h > tstar):
                rows[int(bi)] = launch(int(bi), tstar)
    stack = lambda xs: torch.stack(list(xs))
    return EngineOutputs(
        psi=stack(r.psi for r in rows), nu=stack(r.nu for r in rows),
        freq=stack(r.freq for r in rows).transpose(0, 1),
        beta=(stack(r.beta for r in rows).transpose(0, 1) if record_beta
              else None),
        watermarks=(tuple(stack(r.watermarks[k] for r in rows)
                          for k in range(4)) if record_watermarks else None),
        guard_state=None if trips is None else trips[:, None])


def _class_count(comp) -> Optional[int]:
    """The latency class count of the scenario's dense stacks, or None
    when its latencies form no classes."""
    if comp.per_draw_classes is not None:
        return int(comp.per_draw_classes.shape[1])
    return None if comp.lat_classes is None else len(comp.lat_classes)


def run_scenario(topo: Topology, links: LinkParams, ctrl: ControllerConfig,
                 ppm_u: np.ndarray, scenario: Scenario,
                 cfg: SimConfig = SimConfig(),
                 compiled: Optional[CompiledScenario] = None,
                 options: Optional[EngineOptions] = None,
                 telemetry=None, *, device=None) -> "ScenarioResult":
    """Run a dynamic-event scenario, chaining one engine across segments.

    Args:
      topo, links, ctrl, cfg: as for :func:`repro_torch.core.simulate`;
        ``links`` provides the t=0 physical parameters (per-draw (B, E)
        links are supported on the segment-sum engine).
      ppm_u: (N,) single run or (B, N) ensemble of oscillator draws —
        scenario events hit every draw at the same times.  When the
        scenario carries per-draw event parameters, B must equal the
        scenario's ``num_draws``.
      scenario: the event list (compiled here unless ``compiled`` given).
      compiled: reuse a previous :func:`compile_scenario` result.
      options: :class:`repro_torch.kernels.EngineOptions` — ``engine``
        ("segment-sum" by default here, a dense lane: "auto" | "fused" |
        "tiled" | "per-step", or "sparse") and ``chunk_records`` (records per
        engine call; must divide every segment's record count; default
        the compiler's GCD).
      telemetry: :class:`repro_torch.telemetry.Telemetry` — ``beta``
        (per-edge (T, E) on segment-sum, in-kernel per-node (T, N) on the
        kernel lanes), ``watermarks`` (chunk-merged into
        ``ScenarioResult.watermarks``), ``trace`` (the flight recorder)
        and ``guard`` (closed-loop re-centering: ``True`` or a
        :class:`repro_torch.core.reframing.ReframePolicy`).  Without
        ``telemetry`` segment-sum follows ``cfg.record_beta`` and the
        kernel lanes record ν only.
      device: where to run; None means the CUDA card (raises without one).

    Returns:
      ScenarioResult with concatenated telemetry, threaded final state,
      and the per-segment logical-latency table.
    """
    opts = EngineOptions(engine="segment-sum") if options is None else options
    if not isinstance(opts, EngineOptions):
        raise TypeError("options= must be a repro_torch.kernels."
                        f"EngineOptions, got {type(opts).__name__}")
    if opts.interpret:
        raise ValueError("repro_torch has no kernel interpreter; pass "
                         "device='cpu' to run the plain PyTorch versions")
    beta_explicit = telemetry is not None
    tel = resolve_telemetry(telemetry, "run_scenario")
    engine = opts.engine
    dense = engine in _DENSE_ENGINES
    sparse = engine == "sparse"
    if not dense and not sparse and engine != "segment-sum":
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    ppm_u = np.asarray(ppm_u, np.float32)
    single = ppm_u.ndim == 1
    comp = compiled or compile_scenario(scenario, topo, links, cfg)
    if engine == "auto" and _auto_is_sparse(
            topo, 1 if single else ppm_u.shape[0],
            lambda: _class_count(comp)):
        dense, sparse = False, True
    chunk = opts.chunk_records or comp.chunk_records
    for s in comp.segments:
        if chunk < 1 or s.records % chunk:
            raise ValueError(
                f"chunk_records={chunk} does not divide segment of "
                f"{s.records} records (compiler GCD: {comp.chunk_records})")
    if comp.num_draws is not None and (single
                                       or ppm_u.shape[0] != comp.num_draws):
        raise ValueError(
            f"scenario carries per-draw event parameters for "
            f"B={comp.num_draws} draws; ppm_u must be "
            f"({comp.num_draws}, N), got {ppm_u.shape}")
    if dense:
        if comp.lat_classes is None and comp.per_draw_classes is None:
            raise ValueError(
                "dense scenario engines need shared base links or per-draw "
                "latencies that collapse to few column-signature classes; "
                "fully heterogeneous (B, E) latencies run on the "
                "segment-sum engine" + "".join(
                    "\n  note: " + nt for nt in comp.notes))
        if any(np.asarray(s.edge_w).ndim == 2 for s in comp.segments):
            raise ValueError(
                "per-draw LinkDrop/LinkRestore victims need the "
                "segment-sum or sparse engine (the dense (C, N, N) "
                "adjacency stacks are shared across draws)")
    if dense or sparse:
        kind = "dense" if dense else "sparse"
        if ctrl.kind != "proportional":
            raise ValueError(
                f"{kind} engines implement the proportional controller; "
                f"{ctrl.kind!r} runs on the segment-sum engine")
        if cfg.quantize_beta or cfg.telemetry_noise_ppm:
            raise ValueError(
                "quantize_beta / telemetry noise are segment-sum features")

    rb_seg = tel.beta if beta_explicit else cfg.record_beta
    rb_dense = tel.beta if beta_explicit else False
    rw = tel.watermarks
    tr = coerce_trace(tel.trace, name="run_scenario")
    cs0 = dict(compile_stats()) if tr else None

    guard_on = bool(tel.guard)
    policy: Optional[ReframePolicy] = None
    guard_rows = None        # (B,) per-draw trip thresholds (frames/degree)
    if guard_on:
        policy = (tel.guard if isinstance(tel.guard, ReframePolicy)
                  else ReframePolicy())
        b_g = 1 if single else ppm_u.shape[0]
        if policy.margin is None:
            # Per-draw margins: each draw's OWN gain and disturbance bound.
            kp_rows = np.asarray(broadcast_gain(ctrl.kp, b_g), np.float64)
            ppm_rows = np.broadcast_to(
                np.abs(np.atleast_2d(ppm_u)).max(axis=1), (b_g,))
            dppm_rows = np.zeros(b_g, np.float64)
            for s in comp.segments:
                d = np.abs(np.asarray(s.dppm, np.float64))
                dppm_rows = np.maximum(
                    dppm_rows, d.max(axis=1) if d.ndim == 2 else d.max())
            lat_max = max(float(np.asarray(s.latency_s).max())
                          for s in comp.segments) * cfg.omega_nom
            margins = reframe_guard_margins(
                topo, kp_rows, cfg.dt, cfg.record_every,
                (ppm_rows + dppm_rows) * 1e-6, lat_max, cfg.omega_nom)
        else:
            margins = np.full(b_g, float(policy.margin))
        guard_rows = np.asarray(policy.guard(margins),
                                np.float64).reshape(-1)

    rec_period = cfg.dt * cfg.record_every
    beta0_base = np.asarray(links.beta0, np.float64)
    lam_eff = np.array(beta0_base, copy=True)
    b = 1 if single else ppm_u.shape[0]
    state = None                 # segment-sum: result object with .psi/.nu
    psi_d = nu_d = None          # dense lanes: (B, N) state on the device
    freq_chunks, beta_chunks = [], []
    wm_acc: Optional[Watermarks] = None
    lam_rows, launches = [], 0
    reframes: List[AppliedReframe] = []
    guard_cache: dict = {}     # edge_w bytes -> (deg_w, Laplacian pinv)
    gband = None               # kernel-lane guard band (lo, hi), (B,) each
    rec_done, total = 0, comp.total_records
    eng_label, tile_j = engine, 0
    # All segments' dense stacks or slot tables, built once (the chunk
    # loop never re-densifies, re-scatters or re-transfers them).
    stacks = _build_dense_stacks(topo, comp, cfg, dev) if dense else None
    tables = _build_sparse_tables(topo, comp, cfg, dev) if sparse else None
    kernel_lane = dense or sparse
    host = lambda x: x.cpu().numpy()

    def live_state():
        """Exact threaded (ψ, ν) — (N,)/(B, N) host views.  Every engine
        resolves rotations/re-establishments against these, so the
        spliced λeff rewrites agree across lanes to state precision."""
        if state is None and psi_d is None:
            return (np.zeros_like(ppm_u, np.float64),
                    ppm_u.astype(np.float64) * 1e-6)
        if kernel_lane:
            psi_now, nu_now = host(psi_d), host(nu_d)
            return (psi_now[0], nu_now[0]) if single else (psi_now, nu_now)
        return state.psi, state.nu

    for si, seg in enumerate(comp.segments):
        lat_frames = np.asarray(seg.latency_s, np.float64) * cfg.omega_nom
        if seg.reestablish:
            psi_now, nu_now = live_state()
            lam_eff = _apply_reestablish(
                lam_eff, seg.reestablish, beta0_base, psi_now, nu_now,
                lat_frames, topo)
        for ev in seg.reframe:
            # Explicit Reframe events: resolved at the boundary against
            # the live state (like re-establishment), applied as a λeff
            # rewrite whose Δλ is exactly the pointer shift.
            psi_now, nu_now = live_state()
            lam_eff, shift = _rotation_shifts(
                topo, lam_eff, psi_now, nu_now, lat_frames, seg.edge_w,
                ev.mode, ev.target, edges=ev.edges, explicit=ev.shift)
            reframes.append(AppliedReframe(
                record=seg.start_record, time=seg.start_record * rec_period,
                shift=shift, auto=False))
            tr.event("reframe", record=int(seg.start_record), auto=False,
                     segment=si, max_shift=int(np.abs(shift).max()))
        dppm32 = np.asarray(seg.dppm, np.float32)
        ppm_seg = (ppm_u + dppm32 if (single or dppm32.ndim == 2)
                   else ppm_u + dppm32[None])
        links_seg = LinkParams(latency_s=seg.latency_s,
                               beta0=np.array(lam_eff, copy=True))
        lam_rows.append(_lam_table(lam_eff, seg.latency_s, cfg.omega_nom))
        if policy is not None:
            # Guard preparation: the per-edge estimate inverts the
            # Laplacian fold the shifts solve (β̂_e = p_src − p_dst with
            # L p = −(net − target·deg)); the O(N³) pseudo-inverse is
            # cached on the edge-weight vector.
            wkey = np.asarray(seg.edge_w, np.float64).tobytes()
            if wkey not in guard_cache:
                deg_c = np.zeros(topo.num_nodes, np.float64)
                np.add.at(deg_c, np.asarray(topo.dst),
                          np.asarray(seg.edge_w, np.float64))
                guard_cache[wkey] = (deg_c, np.linalg.pinv(
                    laplacian(topo, np.asarray(seg.edge_w, np.float64))))
            deg_w, lap_pinv = guard_cache[wkey]
            src_np, dst_np = np.asarray(topo.src), np.asarray(topo.dst)

            def edge_estimates(net_records):
                """Per-draw per-record max |β̂_e| of (..., T, N) net rows,
                as (B_eff, T)."""
                dev_rows = np.asarray(net_records, np.float64) \
                    - policy.target * deg_w
                pot = dev_rows @ lap_pinv.T
                est = np.abs(pot[..., src_np] - pot[..., dst_np])
                return np.atleast_2d(est.max(axis=-1))

        if kernel_lane:
            # Segment prep happens ONCE per segment; the chunk loop below
            # replays the engine on device-resident state.
            def prep_segment(links_seg):
                if sparse:
                    return _prep_sparse_segment(
                        topo, links_seg, seg, ctrl, np.atleast_2d(ppm_seg),
                        tables, si, dev)
                return _prep_dense_segment(
                    topo, links_seg, seg, ctrl, np.atleast_2d(ppm_seg),
                    engine, stacks, si, dev)

            prep = prep_segment(links_seg)
            chosen = eng_label = prep["engine"]
            tile_j = prep["tile_j"]
            if sparse:
                k = int(tables[0].shape[0])
                tr.event("engine_dispatch", segment=si, engine="sparse",
                         tile_j=int(tile_j), b=int(b),
                         n=int(topo.num_nodes), k=k,
                         table_bytes=int(4 * k * topo.num_nodes * (
                             1 + prep["latf"].shape[0]
                             + prep["w"].shape[0])))
            else:
                c_stack = int(prep["a_t"].shape[0])
                tr.event("engine_dispatch", segment=si, engine=chosen,
                         tile_j=int(tile_j), b=int(b),
                         n=int(topo.num_nodes), c=c_stack,
                         stack_bytes=int(4 * c_stack * topo.num_nodes ** 2))
            if psi_d is None:
                psi_d, nu_d = torch.zeros_like(prep["nu_u"]), prep["nu_u"]
            dt_frames = float(cfg.omega_nom * cfg.dt)
            if guard_on and gband is None:
                gband = _guard_band(b, policy.target, guard_rows, dev)
            seg_done = 0
            while seg_done < seg.records:
                # Stop cap: a post-splice partial chunk keeps num_records
                # and runs only up to the cap.
                stop = min(chunk, seg.records - seg_done) - 1
                guard_kw = dict(record_guard=guard_on,
                                guard_lo=gband[0] if guard_on else None,
                                guard_hi=gband[1] if guard_on else None,
                                guard_stop=stop if guard_on else None)
                with tr.span("chunk", engine=chosen, segment=si,
                             launch=launches, records=int(stop + 1)):
                    if chosen == "per-step":
                        out = _perstep_chunk(
                            psi_d, nu_d, prep, dt_frames, int(chunk),
                            int(cfg.record_every), rb_dense, rw, guard_on,
                            policy, guard_rows, stop)
                    elif sparse:
                        out = _sparse_engine(
                            psi_d, nu_d, prep["nu_u"], prep["kp"],
                            prep["beta_off"], prep["mask"], tables[0],
                            prep["latf"], prep["w"], prep["lamsum"],
                            dt_frames, int(chunk), int(cfg.record_every),
                            rb_dense, rw, **guard_kw)
                    else:
                        out = _fused_engine(
                            psi_d, nu_d, prep["nu_u"], prep["kp"],
                            prep["beta_off"], prep["mask"], prep["a_t"],
                            prep["deg"], prep["lamsum"], prep["lat"],
                            dt_frames, int(chunk), int(cfg.record_every),
                            chosen, rb_dense, rw, **guard_kw)
                    psi_d, nu_d = out.psi, out.nu
                    trips = host(out.guard_state)[:, 0] if guard_on else None
                    tstar = int(trips.min()) if guard_on else chunk
                    valid = min(tstar, stop) + 1
                    if rb_dense:
                        beta_chunks.append(
                            host(out.beta[:valid]).transpose(1, 0, 2))
                    if rw:
                        wm_c = _host_watermarks(out.watermarks, valid)
                    freq_chunks.append(
                        host(out.freq[:valid] * 1e6).transpose(1, 0, 2))
                if rw:
                    wm_acc = wm_c if wm_acc is None else wm_acc.merge(wm_c)
                launches += 1
                seg_done += valid
                rec_done += valid
                tripped_now = guard_on and tstar <= stop
                if guard_on:
                    tr.event("guard_eval", record=int(rec_done),
                             guard=float(guard_rows.min()),
                             tripped=(int(np.count_nonzero(trips == tstar))
                                      if tripped_now else 0))
                if tripped_now and rec_done < total:
                    # In-kernel guard trip: only the draws that tripped AT
                    # the freeze record rotate; their batchmates keep λeff
                    # bit-exactly and log a zero shift row.
                    psi_now, nu_now = live_state()
                    lam_eff, shift = _rotation_shifts(
                        topo, lam_eff, psi_now, nu_now, lat_frames,
                        seg.edge_w, "graph", policy.target,
                        lap_pinv=lap_pinv, rows_mask=(trips == tstar))
                    reframes.append(AppliedReframe(
                        record=rec_done, time=rec_done * rec_period,
                        shift=shift, auto=True, guard_latency=1))
                    tr.event("reframe", record=int(rec_done), auto=True,
                             segment=si,
                             max_shift=int(np.abs(shift).max()))
                    # The rotation rewrites only the lamsum fold; on a
                    # segment's final record the next segment's prep picks
                    # the shifted λeff up.
                    if seg_done < seg.records:
                        prep = prep_segment(LinkParams(
                            latency_s=seg.latency_s,
                            beta0=np.array(lam_eff, copy=True)))
            continue

        tr.event("engine_dispatch", segment=si, engine="segment-sum",
                 records=int(seg.records))
        for _ in range(seg.records // chunk):
            # Per-launch derived seed: telemetry-noise streams must differ
            # across chunks (no effect when noise is off, so splitting
            # stays bit-identical).  Watermarks and the guard need the β
            # record even when the result does not carry it.
            cfg_chunk = dataclasses.replace(
                cfg, steps=chunk * cfg.record_every,
                seed=cfg.seed + 104729 * launches,
                record_beta=rb_seg or rw or guard_on)
            with tr.span("chunk", engine="segment-sum", segment=si,
                         launch=launches, records=int(chunk)):
                if single:
                    res = simulate(topo, links_seg, ctrl, ppm_seg, cfg_chunk,
                                   init=state, edge_w=seg.edge_w,
                                   ctrl_mask=seg.ctrl_mask, device=dev)
                else:
                    res = simulate_ensemble(topo, links_seg, ctrl, ppm_seg,
                                            cfg_chunk, init=state,
                                            edge_w=seg.edge_w,
                                            ctrl_mask=seg.ctrl_mask,
                                            device=dev)
            state = res
            freq_chunks.append(res.freq_ppm)
            beta_chunks.append(res.beta)
            launches += 1
            rec_done += chunk
            if rw:
                # Host-side watermark fold of the per-edge record's
                # destination aggregation.
                net_wm = node_net_occupancy(topo, res.beta, seg.edge_w)
                wm_c = Watermarks.from_record(np.asarray(net_wm),
                                              res.freq_ppm)
                wm_acc = wm_c if wm_acc is None else wm_acc.merge(wm_c)
            if policy is not None and rec_done < total:
                # Host-side trigger, per draw and per record; the earliest
                # crossing's offset inside the chunk prices the exposure.
                net = node_net_occupancy(topo, res.beta, seg.edge_w)
                hit = edge_estimates(net) >= guard_rows[:, None]
                tripped = hit.any(axis=1)
                tr.event("guard_eval", record=int(rec_done),
                         guard=float(guard_rows.min()),
                         tripped=int(np.count_nonzero(tripped)))
                if tripped.any():
                    first = int(np.flatnonzero(hit.any(axis=0))[0])
                    lam_eff, shift = _rotation_shifts(
                        topo, lam_eff, res.psi, res.nu, lat_frames,
                        seg.edge_w, "graph", policy.target,
                        lap_pinv=lap_pinv, rows_mask=tripped)
                    reframes.append(AppliedReframe(
                        record=rec_done, time=rec_done * rec_period,
                        shift=shift, auto=True,
                        guard_latency=int(chunk - first)))
                    tr.event("reframe", record=int(rec_done), auto=True,
                             segment=si,
                             max_shift=int(np.abs(shift).max()))
                    links_seg = LinkParams(latency_s=seg.latency_s,
                                           beta0=np.array(lam_eff, copy=True))

    axis = 1 if (kernel_lane or not single) else 0
    freq = np.concatenate(freq_chunks, axis=axis)
    if kernel_lane:
        if single:
            freq = freq[0]
        psi_f, nu_f = host(psi_d), host(nu_d)
        if rb_dense:
            beta = np.concatenate(beta_chunks, axis=1)
            if single:
                beta = beta[0]
        else:
            beta = np.zeros(freq.shape[:-1] + (0,), np.float32)
        if single:
            psi_f, nu_f = psi_f[0], nu_f[0]
        c_state = {}
    else:
        beta = (np.concatenate(beta_chunks, axis=axis) if rb_seg
                else np.zeros(freq.shape[:-1] + (0,), np.float32))
        psi_f, nu_f, c_state = state.psi, state.nu, state.c_state

    wm_res = wm_acc
    if wm_res is not None and single and kernel_lane:
        wm_res = wm_res[0]
    if tr:
        cs1 = compile_stats()
        tr.event("compile_stats", before=cs0, after=cs1,
                 delta={k: cs1[k] - cs0[k] for k in cs1})

    times = (np.arange(1, total + 1)) * rec_period
    return ScenarioResult(
        freq_ppm=freq, beta=beta, times=times, psi=psi_f, nu=nu_f,
        c_state=c_state, lam=np.stack(lam_rows), lam_eff=lam_eff,
        segment_records=np.array([s.start_record for s in comp.segments]),
        segment_times=np.array([s.start_record * rec_period
                                for s in comp.segments]),
        topo=topo, links=links, ctrl=ctrl, cfg=cfg, compiled=comp,
        engine=eng_label, tile_j=tile_j, chunk_records=chunk,
        num_launches=launches, reframes=reframes,
        watermarks=wm_res, trace=(tr if tr else None))
