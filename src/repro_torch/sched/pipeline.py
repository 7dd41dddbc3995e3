"""bittide-scheduled pipeline parallelism (the paper's §1.4 application;
port of ``repro.sched.pipeline``).

In a logically synchronous cluster, stage-to-stage activation transfers
have *constant logical latency*, so the pipeline schedule is a static
timetable computed before execution (``core.schedule.pipeline_schedule``)
— no handshakes, acks, or barriers; each stage issues its microbatch at
a precomputed localtick and the receive tick is exact.

On ``torch.distributed`` the same structure is a static unrolled step
loop of point-to-point hops (``batch_isend_irecv`` on the stage axis's
group), where the reference runs ``lax.ppermute`` inside ``shard_map``.
:func:`plan` computes / verifies the timetable; :func:`pipeline_apply`
executes it.  This module is the explicit-collectives exception, as in
the reference: AOT-scheduled point-to-point movement *is* the paper's
contribution mapped to training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch._tree import tree_map
from repro_torch.core.schedule import (LogicalSynchronyNetwork,
                                       StaticSchedule, pipeline_schedule,
                                       verify_bounded)

__all__ = ["PipelinePlan", "plan", "pipeline_apply"]


@dataclasses.dataclass
class PipelinePlan:
    num_stages: int
    num_microbatches: int
    schedule: StaticSchedule
    bounded: bool
    queue_depth_frames: int

    @property
    def makespan_ticks(self) -> int:
        return self.schedule.makespan_ticks

    @property
    def bubble_fraction(self) -> float:
        """Fill/drain bubble of the static schedule (GPipe: (S-1)/(S-1+M))."""
        s, m = self.num_stages, self.num_microbatches
        return (s - 1) / (s - 1 + m)


def plan(lsn: LogicalSynchronyNetwork, stages, num_microbatches: int,
         fwd_ticks: int, bwd_ticks: int, activation_frames: int,
         queue_depth_frames: int = 1 << 16) -> PipelinePlan:
    sched = pipeline_schedule(lsn, stages, num_microbatches, fwd_ticks,
                              bwd_ticks, activation_frames)
    return PipelinePlan(
        num_stages=len(stages), num_microbatches=num_microbatches,
        schedule=sched,
        bounded=verify_bounded(sched, lsn, queue_depth_frames),
        queue_depth_frames=queue_depth_frames)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str, num_microbatches: int) -> torch.Tensor:
    """GPipe-style forward pipeline over mesh axis ``axis`` (a
    ``DeviceMesh`` and one of its dimension names); every rank of the
    mesh calls it.

    ``stage_fn(params_slice, h) -> h`` is applied by each of the S ranks
    along ``axis`` to the microbatch currently resident; microbatches
    enter at stage 0 and exit at stage S-1 after S-1 hops each.

    ``stage_params``: tree of tensors with leading dim S (one slice per
    stage), the same on every rank; rank i of the axis uses slice i.
    ``x``: (M, mb, ...) microbatched input, the same on every rank
    (stage 0 selects its microbatch by index).

    Returns (M, mb, ...) outputs in microbatch order, on every rank.
    """
    import torch.distributed as dist
    s = mesh.size(mesh.mesh_dim_names.index(axis))
    m = num_microbatches
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    peer = lambda i: dist.get_global_rank(group, i)
    params_local = tree_map(lambda p: p[idx], stage_params)
    h = torch.zeros_like(x[0])
    outs = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    for t in range(m + s - 1):  # static unroll == the AOT timetable
        # stage 0 ingests microbatch t (if any); others take the wire
        if idx == 0 and t < m:
            h = x[t]
        h = stage_fn(params_local, h)
        # stage S-1 retires microbatch t-(S-1)
        if idx == s - 1 and t >= s - 1:
            outs[t - (s - 1)] = h
        # the scheduled hop: stage i -> i+1; stage 0 receives zeros, as
        # ppermute gives a device that nothing sends to
        ops = []
        if idx < s - 1:
            ops.append(dist.P2POp(dist.isend, h.contiguous(), peer(idx + 1),
                                  group))
        wire = torch.zeros_like(h)
        if idx > 0:
            ops.append(dist.P2POp(dist.irecv, wire, peer(idx - 1), group))
        for req in (dist.batch_isend_irecv(ops) if ops else []):
            req.wait()
        h = wire
    # collect results from the last stage
    if idx != s - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs
