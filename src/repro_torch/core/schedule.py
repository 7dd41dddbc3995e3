"""Ahead-of-time scheduling on a logical synchrony network (paper §1.4).

Pure-Python copy of ``repro.core.schedule``.

Constant logical latencies make communication *schedulable before any code
runs*: if node j sends a frame at its localtick s, node i consumes it at
localtick s + λ_{j→i} — exactly, no error bars.  This module builds static
timetables for the collective/pipeline patterns a training runtime uses and
verifies the elastic-buffer bound that logical synchrony requires (no over-
or underflow ⇒ the execution graph stays acyclic, [7]).

Ticks here are *per-node localticks*; the timetable never references a global
clock, matching the paper's model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .topology import Topology

__all__ = [
    "LogicalSynchronyNetwork",
    "CommEvent",
    "StaticSchedule",
    "ring_allreduce_schedule",
    "pipeline_schedule",
    "verify_bounded",
]


@dataclasses.dataclass(frozen=True)
class LogicalSynchronyNetwork:
    """The abstraction applications see (paper §1.4): a graph + λ per edge."""

    topo: Topology
    lam: np.ndarray  # (E,) logical latency per directed edge, localticks

    def edge_index(self) -> Dict[Tuple[int, int], int]:
        return {(int(s), int(d)): e
                for e, (s, d) in enumerate(zip(self.topo.src, self.topo.dst))}

    def latency(self, src: int, dst: int) -> int:
        return int(self.lam[self.edge_index()[(src, dst)]])


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One scheduled transfer: src emits `frames` starting at its localtick
    `send_tick`; dst consumes them starting at localtick `recv_tick`."""

    src: int
    dst: int
    send_tick: int
    recv_tick: int
    frames: int
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class StaticSchedule:
    events: List[CommEvent]
    makespan_ticks: int  # completion tick at the last receiver's clock


def ring_allreduce_schedule(
    lsn: LogicalSynchronyNetwork,
    ring: Sequence[int],
    chunk_frames: int,
    combine_ticks: int,
    start_tick: int = 0,
) -> StaticSchedule:
    """Reduce-scatter + all-gather ring, fully ahead-of-time.

    Classic 2(n−1)-step ring; each hop's send tick is fixed at schedule-build
    time from λ alone (no barriers, no acks — the bittide property).  Every
    node starts the schedule at the same *localtick offset* from the agreed
    epoch; epochs need no global clock because only differences matter.
    """
    n = len(ring)
    events: List[CommEvent] = []
    # ready[k] = localtick at which node ring[k] has its next chunk ready.
    ready = {v: start_tick for v in ring}
    for step in range(2 * (n - 1)):
        reducing = step < (n - 1)
        new_ready = dict(ready)
        for k, v in enumerate(ring):
            nxt = ring[(k + 1) % n]
            lam = lsn.latency(v, nxt)
            send = ready[v]
            recv = send + lam
            consume = recv + (combine_ticks if reducing else 0) + chunk_frames
            events.append(CommEvent(v, nxt, send, recv, chunk_frames,
                                    tag=f"{'rs' if reducing else 'ag'}{step}"))
            new_ready[nxt] = max(new_ready.get(nxt, 0), consume)
        ready = new_ready
    return StaticSchedule(events=events,
                          makespan_ticks=max(ready.values()) - start_tick)


def pipeline_schedule(
    lsn: LogicalSynchronyNetwork,
    stages: Sequence[int],
    num_microbatches: int,
    fwd_ticks: int,
    bwd_ticks: int,
    activation_frames: int,
    start_tick: int = 0,
) -> StaticSchedule:
    """GPipe-style forward/backward pipeline as a static bittide timetable.

    `stages` is the chain of node ids.  Each microbatch's activation transfer
    is a CommEvent whose receive tick is exact; stage s may therefore start
    microbatch m's forward at a precomputed localtick with no handshake.
    """
    S = len(stages)
    events: List[CommEvent] = []
    # fwd_done[s][m]: localtick at stage s when microbatch m's fwd completes.
    fwd_done = np.zeros((S, num_microbatches), np.int64)
    for m in range(num_microbatches):
        for s, v in enumerate(stages):
            if s == 0:
                begin = start_tick + m * fwd_ticks
            else:
                prev = stages[s - 1]
                lam = lsn.latency(prev, v)
                arrive = fwd_done[s - 1, m] + lam + activation_frames
                begin = max(arrive, fwd_done[s, m - 1] if m else 0)
                events.append(CommEvent(prev, v, int(fwd_done[s - 1, m]),
                                        int(fwd_done[s - 1, m] + lam),
                                        activation_frames, tag=f"fwd{m}"))
            fwd_done[s, m] = begin + fwd_ticks
    bwd_done = np.zeros((S, num_microbatches), np.int64)
    for m in range(num_microbatches):
        for si in range(S - 1, -1, -1):
            v = stages[si]
            if si == S - 1:
                begin = max(fwd_done[si, m], bwd_done[si, m - 1] if m else 0)
            else:
                nxt = stages[si + 1]
                lam = lsn.latency(nxt, v)
                arrive = bwd_done[si + 1, m] + lam + activation_frames
                begin = max(arrive, bwd_done[si, m - 1] if m else 0, fwd_done[si, -1])
                events.append(CommEvent(nxt, v, int(bwd_done[si + 1, m]),
                                        int(bwd_done[si + 1, m] + lam),
                                        activation_frames, tag=f"bwd{m}"))
            bwd_done[si, m] = begin + bwd_ticks
    return StaticSchedule(events=events,
                          makespan_ticks=int(bwd_done[0, -1]) - start_tick)


def verify_bounded(schedule: StaticSchedule, lsn: LogicalSynchronyNetwork,
                   depth_frames: int) -> bool:
    """Check per-edge in-flight occupancy never exceeds the buffer depth.

    Counts frames that have arrived (receiver clock) but not yet been
    consumed; schedulability requires max occupancy ≤ depth (paper §1.5:
    the whole mechanism exists to keep this invariant).
    """
    per_edge: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for ev in schedule.events:
        per_edge.setdefault((ev.src, ev.dst), []).append((ev.recv_tick, ev.frames))
    for (_, _), arrivals in per_edge.items():
        arrivals.sort()
        occ = 0
        prev_t = None
        for t, f in arrivals:
            if prev_t is not None and t > prev_t:
                # consumption is one frame per localtick between arrivals
                occ = max(0, occ - (t - prev_t))
            occ += f
            if occ > depth_frames:
                return False
            prev_t = t
    return True
