"""Frame-level discrete-event simulator (validation oracle).

Numpy copy of ``repro.core.frame_level``; its events are the port's
(``repro_torch.scenarios.events``).

Unlike the abstract frame model (which *assumes* constant logical latency),
this simulator moves individual sequence-numbered frames through wires and
FIFOs, exactly like the hardware datapath: every localtick a node pops one
frame from each incoming elastic buffer and pushes one frame onto each
outgoing wire.  It is the ground truth used to validate:

  * logical-latency constancy (λ per frame is the same for every frame),
  * elastic-buffer boundedness under clock control,
  * over/underflow when control is disabled (the paper's motivation),
  * dynamic events: a mid-run cable swap (``repro_torch.scenarios.LatencyStep``)
    re-fills the wire at the new length — in-flight/in-buffer frames keep
    their λ, and λ jumps by exactly the inserted in-flight frame count at
    the splice (the paper's §5.6 fiber-spool experiment, Table 2);
  * frame rotation (``repro_torch.scenarios.Reframe``, arXiv:2504.07044): the
    read pointer of an elastic buffer jumps by δ frames, splicing the
    sequence stream contiguously — occupancy AND logical latency both
    shift by exactly δ, frames behind the pointer are untouched (zero
    loss from the post-splice stream), and λ stays constant within each
    epoch.  This is the ground truth for the closed-loop buffer
    re-centering subsystem (``run_scenario(auto_reframe=...)``).

Pure numpy, event-accurate, intended for small N (tests and examples).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional, Sequence

import numpy as np

from .topology import Topology
from .frame_model import LinkParams, OMEGA_NOM

__all__ = ["FrameLevelResult", "simulate_frames"]


@dataclasses.dataclass
class FrameLevelResult:
    lam: np.ndarray          # (E,) latest measured logical latency per edge
    lam_constant: bool       # λ constant per edge within each event epoch
    occupancy_min: np.ndarray  # (E,)
    occupancy_max: np.ndarray  # (E,)
    underflow: bool
    overflow: bool
    ticks: np.ndarray        # (N,) total localticks executed
    # Dynamic-event bookkeeping (empty when events is None):
    # per-edge ordered list of distinct λ values observed (one per epoch),
    # the net in-flight frames inserted by LatencySteps per edge, and the
    # net read-pointer rotation applied by Reframe events per edge.
    lam_epochs: list = dataclasses.field(default_factory=list)
    inserted: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    rotated: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))


def simulate_frames(
    topo: Topology,
    links: LinkParams,
    ppm_u: np.ndarray,
    duration_s: float,
    depth: int = 32,
    init_occ: int = 18,
    controller: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    control_period_s: float = 1e-4,
    omega_nom: float = OMEGA_NOM,
    sim_rate_scale: float = 1e-5,
    events: Optional[Sequence] = None,
) -> FrameLevelResult:
    """Run a frame-accurate simulation.

    To keep runtimes sane the nominal tick rate is scaled by
    ``sim_rate_scale`` (link latencies are specified in *frames*, via
    ``links``, so logical quantities are unaffected — only wall-clock density
    of events changes).

    Args:
      controller: maps (N,) summed occupancy error -> (N,) relative frequency
        corrections.  None = uncontrolled (paper §3.1: buffers then drift to
        over/underflow).
      events: optional list of scenario events (or a Scenario), applied at
        their times (in the same scaled clock as ``duration_s``).  The
        frame level supports ``LatencyStep`` — the wire is re-filled at
        the new length with sequence numbers counting back contiguously
        from the sender's current localtick, so occupancy is continuous,
        frames already in flight keep their λ, and λ jumps by exactly the
        inserted in-flight frame count at the splice — ``FreqStep``
        (oscillator rate change), and ``Reframe`` (read-pointer rotation:
        occupancy and λ shift by exactly the applied per-edge shift, the
        stream splices contiguously with zero loss).  Other event types
        are abstract-model constructs; passing them raises.
    """
    n, e = topo.num_nodes, topo.num_edges
    rate_nom = omega_nom * sim_rate_scale
    ppm = np.asarray(ppm_u, np.float64).copy()
    rates = rate_nom * (1.0 + ppm * 1e-6)
    lat_s = np.asarray(links.latency_s, np.float64) / sim_rate_scale

    # Per-edge FIFOs hold (send_seq) of frames; wires are heaps of
    # (arrival_time, send_seq).  Matching the hardware boot (§4.1): links run
    # before the shared trigger, so at t=0 each wire already carries its
    # in-flight frames and each buffer holds `init_occ` older ones; sequence
    # numbers count back from the trigger (θ == 0 at t == 0).
    inflight = [int(np.floor(l * rate_nom)) for l in lat_s]
    fifos = [list(range(-(init_occ + fl_), -fl_)) for fl_ in inflight]
    wires = []
    for ei in range(e):
        w = [(lat_s[ei] - k / rate_nom, -k) for k in range(inflight[ei], 0, -1)]
        heapq.heapify(w)
        wires.append(w)
    sent = np.zeros(n, np.int64)     # localtick counter θ_i == frames sent
    popped = np.zeros(e, np.int64)   # frames popped per edge
    lam_seen = [None] * e
    lam_epochs = [[] for _ in range(e)]
    lam_const = True
    occ_min = np.full(e, init_occ, np.int64)
    occ_max = np.full(e, init_occ, np.int64)
    underflow = overflow = False
    inserted = np.zeros(e, np.int64)
    rotated = np.zeros(e, np.int64)
    # edge -> pending first-seqs of post-event wire regimes (a second swap
    # can land while the first regime's frames are still in flight, so
    # this is a queue, ordered by construction: seqs only grow).
    splice_seq: dict = {}

    pending = []
    _LatencyStep = _FreqStep = _Reframe = None
    if events is not None:
        # Lazy import: events live in repro_torch.scenarios (which
        # imports core).
        from repro_torch.scenarios.events import (FreqStep, LatencyStep, Reframe,
                                            Scenario)
        _LatencyStep, _FreqStep, _Reframe = LatencyStep, FreqStep, Reframe
        evs = list(events.events) if isinstance(events, Scenario) \
            else list(events)
        for ev in sorted(evs, key=lambda x: x.t):
            if not isinstance(ev, (LatencyStep, FreqStep, Reframe)):
                raise ValueError(
                    f"frame-level oracle supports LatencyStep, FreqStep "
                    f"and Reframe events, got {type(ev).__name__}")
            pending.append(ev)

    out_edges = [np.nonzero(topo.src == i)[0] for i in range(n)]
    in_edges = [np.nonzero(topo.dst == i)[0] for i in range(n)]

    def deliver(ei, t):
        """Move due frames from wire ``ei`` into its FIFO tail."""
        w = wires[ei]
        while w and w[0][0] <= t:
            _, seq = heapq.heappop(w)
            fifos[ei].append(seq)

    def apply_latency_step(ev, t):
        """Cable swap: re-fill the wire at the new length.

        The new wire carries sequence numbers counting back contiguously
        from the sender's current localtick — exactly the boot
        construction (§4.1) at the new latency.  Occupancy is continuous
        (the FIFO is untouched), frames already delivered keep their λ,
        and the splice inserts ``inflight_new − inflight_old`` frames:
        the λ jump the paper measures as the Table-2 RTT shift.
        """
        from .frame_model import PIPE_FRAMES, SIGNAL_VELOCITY
        new_lat = ev.new_latency_s(omega_nom, SIGNAL_VELOCITY,
                                   PIPE_FRAMES) / sim_rate_scale
        for k, ei in enumerate(ev.edges):
            deliver(ei, t)          # don't lose frames that are already due
            lat_s[ei] = float(new_lat[k])
            fl_new = int(np.floor(lat_s[ei] * rate_nom))
            s_hi = int(sent[topo.src[ei]])
            ins = fl_new - len(wires[ei])
            inserted[ei] += ins
            w = [(t + lat_s[ei] - kk / rate_nom, s_hi - kk)
                 for kk in range(fl_new, 0, -1)]
            heapq.heapify(w)
            wires[ei] = w
            if ins != 0:
                # λ-neutral swaps (sub-frame latency change) splice the
                # sequence contiguously: no epoch boundary to expect, and
                # registering one would mask a later real violation.
                splice_seq.setdefault(ei, []).append(s_hi - fl_new)

    def apply_reframe(ev, t):
        """Read-pointer rotation: splice the sequence stream by δ frames.

        The FIFO + wire of an edge hold the contiguous sequence range
        [next_pop, sent_src − 1].  Rotating the read pointer by δ > 0
        re-opens δ already-consumed frames (the head extends down to
        next_pop − δ: occupancy and λ grow by δ); δ < 0 advances the
        pointer past δ buffered frames (occupancy and λ shrink by δ).
        Frames behind the pointer — the whole post-splice stream — are
        untouched, so no frame of it is lost, and the splice is
        registered so the λ-epoch accounting sees a rotation, not a
        constancy violation.
        """
        idx = list(ev.edge_ids(e))
        for ei in idx:
            deliver(ei, t)          # pointer state must be current
        if ev.shift is not None:
            sh = ev.shifts_for(e)
        else:
            occ = np.array([len(fifos[ei]) for ei in idx], np.float64)
            setpoint = depth / 2.0 + ev.target
            if ev.mode == "per-edge":
                sh = np.rint(setpoint - occ).astype(np.int64)
            else:
                # Graph mode: RTT-conserving potential assignment from the
                # per-node net occupancy (idx is all edges here).
                from .reframing import graph_shifts
                net = np.zeros(n, np.float64)
                np.add.at(net, topo.dst[idx], occ - setpoint)
                sh = graph_shifts(topo, net)[1]
        for k, ei in enumerate(idx):
            d = int(sh[k])
            if d == 0:
                continue
            next_pop = int(sent[topo.src[ei]]) - len(wires[ei]) - len(fifos[ei])
            if d > 0:
                fifos[ei][:0] = list(range(next_pop - d, next_pop))
            else:
                if len(fifos[ei]) < -d:
                    raise RuntimeError(
                        f"reframe shift {d} exceeds buffer occupancy "
                        f"{len(fifos[ei])} on edge {ei}")
                del fifos[ei][:-d]
            rotated[ei] += d
            # First post-rotation pop has seq == next_pop − d, whatever
            # the sign: that is where the new λ epoch begins.
            splice_seq.setdefault(ei, []).append(next_pop - d)
            occ_now = len(fifos[ei])
            occ_min[ei] = min(occ_min[ei], occ_now)
            occ_max[ei] = max(occ_max[ei], occ_now)

    corr = np.zeros(n, np.float64)
    next_control = control_period_s
    t_end = duration_s
    # Event loop over node ticks (heap of (time, node)).
    heap = [(0.0, i) for i in range(n)]
    heapq.heapify(heap)

    while heap:
        t, i = heapq.heappop(heap)
        if t > t_end:
            break
        while pending and t >= pending[0].t:
            ev = pending.pop(0)
            if isinstance(ev, _FreqStep):
                ppm[list(ev.nodes)] += ev.delta_ppm
                rates = rate_nom * (1.0 + ppm * 1e-6)
            elif isinstance(ev, _Reframe):
                apply_reframe(ev, t)
            else:
                apply_latency_step(ev, t)
        if controller is not None and t >= next_control:
            occ = np.array([len(f) for f in fifos], np.float64) - depth / 2
            err = np.zeros(n, np.float64)
            np.add.at(err, topo.dst, occ)
            corr = controller(err)
            next_control = t + control_period_s

        # Deliver due frames from wires into FIFO tails.
        for ei in in_edges[i]:
            deliver(ei, t)

        # One localtick at node i: pop head of each in-FIFO...
        for ei in in_edges[i]:
            if fifos[ei]:
                seq = fifos[ei].pop(0)
                lam = sent[i] - seq  # arrival localtick − send localtick
                if lam_seen[ei] is None:
                    lam_seen[ei] = lam
                    lam_epochs[ei].append(lam)
                elif lam != lam_seen[ei] and seq >= 0:
                    sp = splice_seq.get(ei)
                    if sp and seq >= sp[0]:
                        # A post-event regime reaching the buffer head: a
                        # new λ epoch, not a constancy violation.  Drop
                        # every pending splice this pop has reached (a
                        # rapid re-swap can overtake an unconsumed one).
                        while sp and seq >= sp[0]:
                            sp.pop(0)
                        if not sp:
                            del splice_seq[ei]
                        lam_seen[ei] = lam
                        lam_epochs[ei].append(lam)
                    else:
                        lam_const = False
                popped[ei] += 1
            else:
                underflow = True
            occ = len(fifos[ei])
            occ_min[ei] = min(occ_min[ei], occ)
            occ_max[ei] = max(occ_max[ei], occ)
            if occ > depth:
                overflow = True

        # ...and push one new frame on each outgoing wire.
        for ei in out_edges[i]:
            heapq.heappush(wires[ei], (t + lat_s[ei], sent[i]))
        sent[i] += 1

        rate = rates[i] * (1.0 + corr[i])
        heapq.heappush(heap, (t + 1.0 / rate, i))

    lam = np.array([x if x is not None else -1 for x in lam_seen], np.int64)
    return FrameLevelResult(
        lam=lam, lam_constant=lam_const, occupancy_min=occ_min,
        occupancy_max=occ_max, underflow=underflow, overflow=overflow,
        ticks=sent, lam_epochs=lam_epochs, inserted=inserted,
        rotated=rotated)
