"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
``torch.distributed`` state.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, which the caller initializes (``init_process_group``
with its own store, rank and world size); building a mesh is collective
over that group, so every rank builds the same meshes in the same order.

``device_type=None`` means ``"cuda"`` and raises without a card, as every
entry point of the port does; the CPU tests pass ``"cpu"`` (gloo or the
fake backend).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device

__all__ = ["make_production_mesh", "make_mesh_from_devices", "dp_axes_of"]


def _device_type(device_type: Optional[str]) -> str:
    return resolve_device(device_type).type


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks for the multi-pod
    run.  Raises unless the default group holds exactly that many."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dtype = _device_type(device_type)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks; the default group has {world}")
    return init_device_mesh(dtype, shape, mesh_dim_names=axes)


def make_mesh_from_devices(ranks: Sequence[int], shape: Tuple[int, ...],
                           axes: Tuple[str, ...],
                           device_type: Optional[str] = None):
    """A mesh whose rank array is ``ranks`` reshaped to ``shape`` — the
    elastic-rescale path (``ft.elastic``) re-meshes the survivors with
    it."""
    from torch.distributed.device_mesh import DeviceMesh
    dtype = _device_type(device_type)
    grid = torch.tensor([int(r) for r in ranks], dtype=torch.int).reshape(
        tuple(shape))
    return DeviceMesh(dtype, grid, mesh_dim_names=tuple(axes))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    """The batch ('data-parallel') axes of a mesh: every axis except
    model."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")
