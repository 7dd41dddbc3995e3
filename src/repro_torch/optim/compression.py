"""Error-feedback int8 gradient compression for the DP all-reduce (port
of ``repro.optim.compression``).

Classic EF-SGD: quantize (g + e) to int8 with a per-tensor scale, keep
the quantization residual e locally, and re-inject it next step.  The
payload a shard contributes is an int8 tensor and one f32 scale: 4x
fewer wire bytes than f32 (2x than bf16) at equal asymptotic
convergence.

``compress`` / ``decompress`` / ``ef_roundtrip`` are elementwise and one
reduction in plain PyTorch (the reference has no Pallas kernel here):
``torch.round`` rounds half to even as ``jnp.round`` does, and f32
division is correctly rounded in both, so q, the scale and the residual
equal the reference's bit for bit.  :func:`compressed_psum` is the
collective, on a ``torch.distributed`` group where the reference runs
``psum`` inside ``shard_map``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch._tree import tree_map

__all__ = ["compress", "decompress", "ef_roundtrip", "compressed_psum",
           "init_error_state"]


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(tree: Any) -> Any:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def ef_roundtrip(g: torch.Tensor, e: torch.Tensor):
    """(g, error) -> (decompressed payload, new error). Pure single-node
    version used by tests and by the non-distributed reference path."""
    q, s = compress(g.to(torch.float32) + e)
    deq = decompress(q, s)
    return deq, (g.to(torch.float32) + e) - deq


def _group(group):
    """A process group, or a ``(DeviceMesh, axis name)`` pair's group."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(axis)
    return group


def compressed_psum(g: torch.Tensor, e: torch.Tensor, group):
    """Error-feedback compressed all-reduce (mean) over ``group``: a
    process group, or a ``(DeviceMesh, axis name)`` pair.  Every rank of
    the group calls it.

    Each shard contributes s_i * q_i with q_i int8 and s_i a scalar; the
    sum of the decompressed f32 payloads is all-reduced and divided by
    the group's size, as the reference's ``psum``.  The quantization
    residual stays local in the returned error and is re-injected next
    step (error feedback keeps convergence unbiased).
    """
    import torch.distributed as dist
    pg = _group(group)
    gf = g.to(torch.float32) + e
    q, s = compress(gf)
    deq = decompress(q, s)
    new_e = gf - deq
    dist.all_reduce(deq, group=pg)
    return deq / dist.get_world_size(pg), new_e
