"""Mixture-of-Experts block: GShard-style grouped one-hot dispatch (port of
``repro.models.moe``).

Routing is dense one-hot matmuls (dispatch and combine tensors).  Tokens
are processed in groups of ``moe_group_size`` with per-group capacity
C = ceil(cf * group * k / E); over-capacity tokens are dropped, slots
taken in (token, choice) order (the GShard cumsum).  Padded experts are
masked out of the router.

On a mesh the groups are the reference's over the global batch, whose
rank-local slices a step computes (``batch_split``): a group that spans
data ranks offsets each rank's slots by the counts of the ranks before
it.  Under tensor-parallel compute (``tp``) each rank of the "model"
group computes its share of the experts and of the shared and dense
MLPs, and routes every token itself (``models.parallel``).

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
from .parallel import copy_to_model, gather_from_batch, reduce_from_model

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


def _group_size(cfg, t: int, batch_split) -> Tuple[int, int]:
    """(gs, span): the reference's group size over the global batch of
    the ranks in ``batch_split`` (``t`` tokens each), and the number of
    those ranks one group spans (1 where every rank holds whole
    groups)."""
    n = 1 if batch_split is None else batch_split.ranks
    gs = min(cfg.moe_group_size, t * n)
    if gs <= t:
        if t % gs:
            raise ValueError(f"tokens {t} not divisible by group size {gs}"
                             + (f" on each of {n} data ranks" if n > 1
                                else ""))
        return gs, 1
    if gs % t:
        raise ValueError(f"a group of {gs} tokens straddles data ranks of "
                         f"{t} tokens each")
    return gs, gs // t


def _spanning_counts(onehot, probs, batch_split, span: int, gs: int, cfg):
    """For one group of ``gs`` tokens over ``span`` data ranks, this
    rank's tokens being one slice of it: (the (token, choice) count per
    expert of the ranks before this one in the group, the reference's
    load-balance term over every global group).  One all-gather over
    the batch axes of each rank's counts and probability sums per
    expert; counts are whole numbers, exact in f32."""
    e = onehot.shape[-1]
    mine = torch.cat([onehot.sum(dim=(0, 1, 2)), probs.sum(dim=(0, 1))])
    every = gather_from_batch(mine, batch_split)            # (ranks, 2e)
    q = batch_split.index
    offset = every[q - q % span:q, :e].sum(dim=0)
    per_group = every.reshape(-1, span, 2 * e).sum(dim=1) / gs
    aux = (per_group[:, :e] * per_group[:, e:]).sum(dim=-1).mean()
    return offset, aux * cfg.num_experts


def moe_apply(params, x, cfg, tp=None,
              batch_split=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B,S,d), aux load-balance loss (scalar)).

    ``batch_split`` (``models.parallel.BatchSplit``): the data ranks a
    mesh step split the batch over, ``x`` being this rank's slice.
    Groups and capacity are the reference's over the global batch: where
    a group spans ranks, this rank's slots follow the counts of the
    ranks before it (a serving step's; a train step raises, since the
    load-balance term's gradient would need the group's probabilities
    from every rank).

    ``tp`` (``models.parallel.TensorParallel``): ``w1`` / ``w3`` /
    ``w2`` hold this rank's experts where ``tp.experts``, the shared and
    dense MLPs their columns / rows where ``tp.shared`` / ``tp.dense``;
    the output is the plain one on every rank.  Routing is whole on
    every rank; the one-hot is sliced to this rank's experts before the
    slot cumsum (a column's slots depend on that column alone)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    k = cfg.num_experts_per_tok
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gs, span = _group_size(cfg, t, batch_split)
    g = t // gs if span == 1 else 1
    xg = tokens.reshape(g, -1, d)

    logits = (xg @ params["router"].to(xg.dtype)).float()
    if cfg.num_experts < e:  # router-mask padded (inert) experts
        pad_mask = torch.arange(e, device=x.device) >= cfg.num_experts
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)

    gate_logits, idx = top_k(logits, k)                    # (g, gs, k)
    gates = torch.softmax(gate_logits, dim=-1)             # over the top-k
    probs = torch.softmax(logits, dim=-1)

    cap = int(np.ceil(cfg.moe_capacity_factor * gs * k / e))
    onehot = F.one_hot(idx, e).float()                     # (g, gs, k, e)
    if span > 1:
        if torch.is_grad_enabled() and logits.requires_grad:
            raise ValueError(
                f"the MoE token group of {gs} tokens spans {span} data "
                f"ranks ({t} tokens each): a train step would compute the "
                "load-balance term on each rank's tokens, not the group's; "
                f"give each data rank a whole group ({gs} tokens or a "
                "multiple)")
        offset, aux = _spanning_counts(onehot, probs, batch_split, span, gs,
                                       cfg)
    experts = tp is not None and tp.experts
    lo, hi = ((tp.rank * e // tp.size, (tp.rank + 1) * e // tp.size)
              if experts else (0, e))
    mine = onehot[..., lo:hi]                              # this rank's
    # slot position of each (token, choice) within its expert, priority by
    # (token, choice) order — the classic GShard cumsum.
    flat = mine.reshape(g, -1, hi - lo)
    pos = torch.cumsum(flat, dim=1) - flat                 # (g, gs*k, e)
    if span > 1:
        pos = pos + offset[lo:hi]
    pos = pos.reshape(mine.shape)
    keep = (pos < cap) * mine                              # drop over-capacity
    slot = F.one_hot((pos * keep).long(), cap).float() * keep[..., None]
    # dispatch: (g, gs, e, cap); combine adds the gate weights, whose
    # gradient each rank sees for its experts only: summed over "model"
    if experts:
        gates = copy_to_model(gates, tp)
    dispatch = slot.sum(dim=2).to(x.dtype)
    combine = (slot * gates[..., None, None]).sum(dim=2).to(x.dtype)

    # the experts', shared and dense inputs (not the router's) carry
    # their gradient's partial sums over "model" where they split
    xc = copy_to_model(xg, tp) if tp is not None and (
        tp.experts or tp.shared or tp.dense) else xg
    ex_in = torch.einsum("gsec,gsd->gecd", dispatch, xc if experts else xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", ex_in, params["w1"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", ex_in, params["w3"].to(x.dtype))
    ex_out = torch.einsum("gecf,efd->gecd", h, params["w2"].to(x.dtype))
    terms = [(torch.einsum("gecd,gsec->gsd", ex_out, combine), experts)]

    for kind in ("shared", "dense"):
        if f"{kind}_w1" in params:
            split = tp is not None and getattr(tp, kind)
            src = xc if split else xg
            hs = F.silu(src @ params[f"{kind}_w1"].to(x.dtype))
            hs = hs * (src @ params[f"{kind}_w3"].to(x.dtype))
            terms.append((hs @ params[f"{kind}_w2"].to(x.dtype), split))
    # the split partials summed, then reduced once; whole terms after
    out = None
    for term, split in terms:
        if split:
            out = term if out is None else out + term
    if out is not None:
        out = reduce_from_model(out, tp)
    for term, split in terms:
        if not split:
            out = term if out is None else out + term

    if span == 1:
        # Switch-style load-balance aux loss over the real experts.
        frac_tokens = onehot.sum(dim=2).mean(dim=1)        # (g, e)
        frac_probs = probs.mean(dim=1)
        aux = (frac_tokens * frac_probs).sum(dim=-1).mean() * cfg.num_experts

    return out.reshape(b, s, d), aux.float()
