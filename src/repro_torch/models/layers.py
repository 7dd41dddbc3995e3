"""Parameter descriptors + elementary layers (port of ``repro.models.layers``).

Every weight is declared once as a :class:`ParamDef` (shape, logical
sharding tags, init); ``materialize`` turns a tree of them (nested dicts)
into tensors.  The logical ``spec`` tags are kept so that a tree of defs
equals the reference's; the sharding helpers that read them belong to the
launch slice.

``materialize`` draws from a ``torch.Generator`` and cannot reproduce
``jax.random``'s bits: parity with the reference comes from carrying its
weights across (:func:`repro_torch.convert.model_params`), not from init.

Activations are bf16 and norms compute in f32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map

__all__ = ["ParamDef", "materialize", "stack_defs", "tree_map", "rmsnorm",
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
