"""Mixture-of-Experts block: GShard-style grouped one-hot dispatch (port of
``repro.models.moe``).

Routing is dense one-hot matmuls (dispatch and combine tensors).  Tokens
are processed in groups of ``moe_group_size`` with per-group capacity
C = ceil(cf * group * k / E); over-capacity tokens are dropped, slots
taken in (token, choice) order (the GShard cumsum).  Padded experts are
masked out of the router.

The top-k choice keeps the lower expert index on ties, as
``jax.lax.top_k`` does: router logits are computed in bf16 before the f32
cast, so ties are real, and ``torch.topk`` promises no order on them;
:func:`top_k` gives the reference's order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import ParamDef

__all__ = ["moe_defs", "moe_apply", "padded_experts", "top_k"]


def padded_experts(num_experts: int, tp: int = 16) -> int:
    """Pad expert count up to a multiple of the model-axis size."""
    return int(np.ceil(num_experts / tp) * tp)


def moe_defs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    e = padded_experts(cfg.num_experts)
    defs = {
        "router": ParamDef((d, e), (None, None), std=0.02),
        "w1": ParamDef((e, d, ff), ("model", "fsdp", None)),
        "w3": ParamDef((e, d, ff), ("model", "fsdp", None)),
        "w2": ParamDef((e, ff, d), ("model", None, "fsdp")),
    }
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        defs["shared_w1"] = ParamDef((d, sff), ("fsdp", "model"))
        defs["shared_w3"] = ParamDef((d, sff), ("fsdp", "model"))
        defs["shared_w2"] = ParamDef((sff, d), ("model", "fsdp"))
    if cfg.moe_dense_residual:
        dff = cfg.d_ff_dense or ff
        defs["dense_w1"] = ParamDef((d, dff), ("fsdp", "model"))
        defs["dense_w3"] = ParamDef((d, dff), ("fsdp", "model"))
        defs["dense_w2"] = ParamDef((dff, d), ("model", "fsdp"))
    return defs


def top_k(logits, k: int):
    """The k largest along the last axis in ``jax.lax.top_k``'s order: the
    lower index first on ties, and +0.0 above -0.0.

    Two stable sorts: by sign bit (index order kept within each sign),
    then by value, descending; equal values keep the first sort's order.
    """
    order = torch.sort(torch.signbit(logits).to(torch.uint8), dim=-1,
                       stable=True).indices
    vals, idx = torch.sort(torch.gather(logits, -1, order), dim=-1,
                           descending=True, stable=True)
    return vals[..., :k], torch.gather(order, -1, idx[..., :k])


def moe_apply(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B,S,d), aux load-balance loss (scalar))."""
    b, s, d = x.shape
    e = params["w1"].shape[0]
    k = cfg.num_experts_per_tok
    gs = min(cfg.moe_group_size, b * s)
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    if t % gs:
        raise ValueError(f"tokens {t} not divisible by group size {gs}")
    g = t // gs
    xg = tokens.reshape(g, gs, d)

    logits = (xg @ params["router"].to(xg.dtype)).float()
    if cfg.num_experts < e:  # router-mask padded (inert) experts
        pad_mask = torch.arange(e, device=x.device) >= cfg.num_experts
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)

    gate_logits, idx = top_k(logits, k)                    # (g, gs, k)
    gates = torch.softmax(gate_logits, dim=-1)             # over the top-k

    cap = int(np.ceil(cfg.moe_capacity_factor * gs * k / e))
    onehot = F.one_hot(idx, e).float()                     # (g, gs, k, e)
    # slot position of each (token, choice) within its expert, priority by
    # (token, choice) order — the classic GShard cumsum.
    flat = onehot.reshape(g, gs * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                 # (g, gs*k, e)
    pos = pos.reshape(g, gs, k, e)
    keep = (pos < cap) * onehot                            # drop over-capacity
    slot = F.one_hot((pos * keep).long(), cap).float() * keep[..., None]
    # dispatch: (g, gs, e, cap); combine adds the gate weights
    dispatch = slot.sum(dim=2).to(x.dtype)
    combine = (slot * gates[..., None, None]).sum(dim=2).to(x.dtype)

    ex_in = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", ex_in, params["w1"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", ex_in, params["w3"].to(x.dtype))
    ex_out = torch.einsum("gecf,efd->gecd", h, params["w2"].to(x.dtype))
    out = torch.einsum("gecd,gsec->gsd", ex_out, combine)

    if "shared_w1" in params:
        hs = F.silu(xg @ params["shared_w1"].to(x.dtype))
        hs = hs * (xg @ params["shared_w3"].to(x.dtype))
        out = out + hs @ params["shared_w2"].to(x.dtype)
    if "dense_w1" in params:
        hd = F.silu(xg @ params["dense_w1"].to(x.dtype))
        hd = hd * (xg @ params["dense_w3"].to(x.dtype))
        out = out + hd @ params["dense_w2"].to(x.dtype)

    # Switch-style load-balance aux loss over the real experts.
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = onehot.sum(dim=2).mean(dim=1)            # (g, e)
    frac_probs = probs.mean(dim=1)
    aux = (frac_tokens * frac_probs).sum(dim=-1).mean() * cfg.num_experts

    return out.reshape(b, s, d), aux.float()
