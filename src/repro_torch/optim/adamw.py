"""AdamW, functional (port of ``repro.optim.adamw``).

Parameters, gradients and moments are trees of tensors (nested dicts);
an update returns new trees and leaves its inputs as they were, so a
snapshot of the old state stays valid.  Moments are stored in
``moment_dtype`` (f32, or bf16 as arctic's ``opt_moment_dtype``); the
update is computed in float32 regardless, written out as the reference
writes it (``torch.optim.AdamW`` orders the decay and the step
differently, so its bits would part).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves, in sorted-key order, of Σ leaf²), in f32."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in tree_leaves(tree)))


def adamw_init(params, cfg: AdamWConfig):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_update(grads, state, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One step: (new params, new state, the gradients' global norm).

    Gradients are clipped to ``clip_norm`` by their global norm;
    ``lr_scale`` (a float or a 0-d f32 tensor) scales ``cfg.lr``."""
    with torch.no_grad():
        count = state["count"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
        b1c = 1.0 - torch.pow(cfg.b1, count.float())
        b2c = 1.0 - torch.pow(cfg.b2, count.float())
        lr = cfg.lr * lr_scale

        def upd(p, g, mu, nu):
            g = g.float() * scale
            mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
            nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
            step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
            step = step + cfg.weight_decay * p.float()
            new_p = p.float() - lr * step
            return new_p.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        pick = lambda i: tree_map(lambda t: t[i], out)
        # tree_map recurses into dicts only, so the (p, mu, nu) tuples
        # are leaves here
        return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}, gnorm
