"""Parameter descriptors + elementary layers (port of ``repro.models.layers``).

Every weight is declared once as a :class:`ParamDef` (shape, logical
sharding tags, init); ``materialize`` turns a tree of them (nested dicts)
into tensors.  The logical ``spec`` tags ('model': the tensor-parallel
axis; 'fsdp': weights and optimizer state sharded over the data axis for
big archs; 'dp': batch) are mapped to mesh axes by :func:`resolve_spec`,
as in the reference, so that the same defs serve a (16, 16) and a
(2, 16, 16) mesh.  A spec is a tuple with one entry per tensor dimension:
None, an axis name, or a tuple of axis names — what the reference's
``PartitionSpec`` holds, canonicalized as it canonicalizes (a 1-tuple is
its name, an empty tuple None).  :func:`spec_placements` turns one into
DTensor placements on a ``DeviceMesh``.  ``abstract`` (sharded shapes
for the dry run) waits for the dry-run slice.

``materialize`` draws from a ``torch.Generator`` and cannot reproduce
``jax.random``'s bits: parity with the reference comes from carrying its
weights across (:func:`repro_torch.convert.model_params`), not from init.

Activations are bf16 and norms compute in f32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map

__all__ = ["ParamDef", "materialize", "stack_defs", "tree_map", "pspec_tree",
           "resolve_spec", "fit_spec_to_shape", "spec_placements", "rmsnorm",
           "layernorm", "swiglu", "gelu_mlp", "rope", "dtype_of"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]   # logical tags per dim
    init: str = "normal"              # normal | zeros | ones
    std: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.spec):
            raise ValueError(f"spec rank mismatch: {self.shape} vs {self.spec}")


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


Spec = Tuple[Any, ...]


def _canonical(entry):
    """A spec entry as ``PartitionSpec`` stores it."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def resolve_spec(tags: Sequence[Optional[str]], *, use_fsdp: bool,
                 dp_axes: Tuple[str, ...], use_tp: bool = True,
                 fsdp_axes: Optional[Tuple[str, ...]] = None) -> Spec:
    """The mesh axes of each dimension for the logical ``tags``."""
    if fsdp_axes is None:
        fsdp_axes = ("data",) if use_fsdp else ()
    axes = []
    for t in tags:
        if t is None:
            axes.append(None)
        elif t == "model":
            axes.append("model" if use_tp else None)
        elif t == "fsdp":
            axes.append(tuple(fsdp_axes))
        elif t == "dp":
            axes.append(tuple(dp_axes))
        else:
            raise ValueError(f"unknown sharding tag {t!r}")
    return tuple(_canonical(a) for a in axes)


def fit_spec_to_shape(shape, spec: Spec, mesh) -> Spec:
    """Drop sharding axes that do not evenly divide a dimension.

    Small dims (e.g. global_batch=1 in long_500k) fall back to
    replication on the offending axes.  Axis tuples are trimmed from the
    right so ('pod', 'data') degrades to ('pod',) before giving up
    entirely.  ``mesh`` is a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        while axes:
            if dim % math.prod(sizes[a] for a in axes) == 0:
                break
            axes = axes[:-1]
        out.append(_canonical(tuple(axes)))
    return tuple(out)


def spec_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` for ``spec``: for each mesh
    dimension ``Shard(d)`` if the spec names that axis at tensor
    dimension ``d``, else ``Replicate()``.  A dimension named over several
    axes is split over them in mesh order, the first axis major — the
    row-major layout ``NamedSharding`` gives ``('pod', 'data')``; axes
    listed out of mesh order, or named twice, raise."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} lists axes out of the "
                             f"mesh's order {names}")
        for m in dims:
            if not placements[m].is_replicate():
                raise ValueError(f"mesh axis {names[m]!r} named twice in "
                                 f"{spec!r}")
            placements[m] = Shard(d)
    return tuple(placements)


def pspec_tree(defs, *, use_fsdp: bool = False,
               dp_axes: Tuple[str, ...] = ("data",),
               use_tp: bool = True) -> Any:
    """The spec of every ``ParamDef`` in ``defs``."""
    return tree_map(
        lambda d: resolve_spec(d.spec, use_fsdp=use_fsdp, dp_axes=dp_axes,
                               use_tp=use_tp), defs)


def materialize(defs, generator: torch.Generator, dtype: torch.dtype,
                device=None) -> Any:
    """Initialized tensors for a tree of :class:`ParamDef`.

    Normal inits are drawn in float32 from ``generator`` on the
    generator's own device, one leaf after another in sorted-key order,
    then cast to ``dtype`` on ``device``; None means the CUDA card
    (raises without one).
    """
    dev = resolve_device(device)

    def make(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * d.std
        return w.to(device=dev, dtype=dtype)

    return tree_map(make, defs)


def stack_defs(defs, n: int) -> Any:
    """Prepend a layer dimension for stacked-layer parameters."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (None,) + d.spec, d.init, d.std),
        defs)


# ---------------- elementary ops (activations in bf16, norms in f32) -------

def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.float()
    return out.to(x.dtype)


def layernorm(x, gamma, beta, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


def swiglu(x, w1, w3, w2):
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def gelu_mlp(x, w1, w2):
    """``jax.nn.gelu``'s default is the tanh approximation."""
    return F.gelu(x @ w1, approximate="tanh") @ w2


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq   # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]          # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
