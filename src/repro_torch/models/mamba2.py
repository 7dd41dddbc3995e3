"""Mamba2 (SSD — state-space duality) block, matmul-form chunked scan
(port of ``repro.models.mamba2``).

The SSD recurrence per head (state N, head dim P):

    h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t ⊗ B_t
    y_t = C_t^T h_t + D x_t

is evaluated in the chunked dual form: within a chunk of Q timesteps the
output is a masked (Q, Q) matmul; across chunks the per-chunk states are
combined by a linear recurrence, a Python loop over the S/Q chunks (the
reference's ``lax.scan``).  The f32 casts sit where the reference puts
them: ``C·B``, the inter-chunk term, the state update and the state.

Decode is the O(1) recurrence on a carried (B, H, P, N) state plus a
(B, k-1, conv_dim) causal-conv tail.

Under tensor-parallel compute (``tp`` with ``tp.ssm``,
``models.parallel``) each rank computes its heads: ``in_proj`` and the
conv are the rank's column ranges (``parallel.ssm_column_ranges``), B
and C are made whole by one all-gather after the projection, the gated
RMSNorm's Σy² is summed over the group and ``out_proj`` is
row-parallel.  The state (prefill's out, decode's in and out) holds the
rank's heads; the conv tail holds every channel (prefill gathers its x
channels, decode the new token's raw [x | B | C]).  A group of one runs
the plain path.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDef, rmsnorm
from .parallel import (copy_to_model, gather_from_model, gather_to_model,
                       reduce_from_model, ssm_column_ranges, sum_over_model)

__all__ = ["ssm_dims", "mamba_defs", "mamba_apply", "mamba_decode_step",
           "mamba_cache_defs"]


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, nheads, conv_dim


def mamba_defs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    n = cfg.ssm_state
    return {
        # fused in-projection: [z, x, B, C, dt]
        "in_proj": ParamDef((d, 2 * d_inner + 2 * n + nheads), ("fsdp", "model")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), (None, "model")),
        "conv_b": ParamDef((conv_dim,), ("model",), init="zeros"),
        "A_log": ParamDef((nheads,), ("model",), init="zeros"),
        "D": ParamDef((nheads,), ("model",), init="ones"),
        "dt_bias": ParamDef((nheads,), ("model",), init="zeros"),
        "norm_g": ParamDef((d_inner,), ("model",), init="ones"),
        "out_proj": ParamDef((d_inner, d), ("model", "fsdp")),
    }


def _split(tp) -> bool:
    """Whether ``tp`` splits the Mamba2 block over more than one rank."""
    return tp is not None and tp.ssm and tp.size > 1


def _in_proj(params, x, cfg, tp=None):
    """(z, raw xbc, dt); under a split, the rank's columns: raw xbc is
    then [x_r | B_r | C_r]."""
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    m = tp.size if _split(tp) else 1
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    return torch.split(zxbcdt, [d_inner // m, conv_dim // m, nheads // m],
                       dim=-1)


def _split_xbc(xbc, cfg):
    n = cfg.ssm_state
    return torch.split(xbc, [xbc.shape[-1] - 2 * n, n, n], dim=-1)  # xs, B, C


def _rank_major(t, widths, m):
    """``t``'s last dimension holds m ranks' parts of ``widths`` each,
    rank after rank ([a_0 b_0 | a_1 b_1 | ...]): regrouped part after
    part ([a_0 a_1 ... | b_0 b_1 ...])."""
    lead = t.shape[:-1]
    parts = torch.split(t.reshape(*lead, m, sum(widths)), list(widths), -1)
    return torch.cat([p.reshape(*lead, m * w)
                      for p, w in zip(parts, widths)], -1)


def _whole_bc(xbc, cfg, tp):
    """This rank's raw [x_r | B_r | C_r] as [x_r | B | C]: B and C
    gathered over the group (their gradient summed, then this rank's
    share)."""
    n, m = cfg.ssm_state, tp.size
    xr, bc = torch.split(xbc, [xbc.shape[-1] - 2 * n // m, 2 * n // m], -1)
    bc = _rank_major(gather_to_model(bc, -1, tp), (n // m, n // m), m)
    return torch.cat([xr, bc], -1)


def _rank_channels(t, cfg, tp):
    """The conv channels [x_r | B | C] of this rank from every channel."""
    ranges = ssm_column_ranges(cfg, tp.size, tp.rank)["conv"]
    return torch.cat([t[..., lo:hi] for lo, hi in ranges], -1)


def _gated_norm(y, z, gamma, cfg, tp, eps: float = 1e-6):
    """``rmsnorm(y * silu(z), gamma)`` over d_inner; under a split over
    the rank's slice of it, Σy² summed over the group."""
    h = y * F.silu(z)
    if not _split(tp):
        return rmsnorm(h, gamma)
    hf = h.float()
    var = sum_over_model(torch.sum(hf * hf, -1, keepdim=True), tp)
    var = var / ssm_dims(cfg)[0]
    return (hf * torch.rsqrt(var + eps) * gamma.float()).to(h.dtype)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv, kernel k, via k shifted adds (no gather)."""
    k = conv_w.shape[0]
    pads = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pads[:, i:i + xbc.shape[1], :] * conv_w[i][None, None, :]
              for i in range(k))
    return F.silu(out + conv_b[None, None, :])


def _ssd_chunked(xh, dt, a_log, bmat, cmat, chunk):
    """Chunked SSD scan.

    xh: (B,S,H,P) inputs; dt: (B,S,H) softplus'd step sizes;
    a_log: (H,) with A = -exp(a_log); bmat/cmat: (B,S,N).
    Returns y: (B,S,H,P) and final state (B,H,P,N).
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)

    A = -torch.exp(a_log.float())                            # (H,)
    dta = dt.float() * A[None, None, :]                      # (B,S,H) ≤ 0
    dtx = xh * dt[..., None].to(xh.dtype)                    # Δx

    s_orig = s
    if s % q:  # pad the tail: Δ=0 pads are exact no-ops in the recurrence
        pad = q - s % q
        padfn = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        dta, dtx, bmat, cmat = map(padfn, (dta, dtx, bmat, cmat))
        s = s + pad
    nc = s // q

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        dta_c, bc, cc, xc = dta[:, sl], bmat[:, sl], cmat[:, sl], dtx[:, sl]
        cum = torch.cumsum(dta_c, dim=1)                     # (B,Q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,H)
        # exp of the masked segment sums: the same values as the
        # reference's where(tri, exp(seg), 0), but above the diagonal
        # exp(seg) overflows for long chunks (seg grows with Q), and the
        # reference's gradient takes 0 · inf = NaN there
        L = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
        # intra-chunk: y = ((C B^T) ∘ L) @ Δx
        cb = torch.einsum("bin,bjn->bij", cc.float(), bc.float())  # (B,Q,Q)
        w = cb[..., None] * L                                # (B,Q,Q,H)
        y_c = torch.einsum("bijh,bjhp->bihp", w.to(xh.dtype), xc)
        # inter-chunk: y_i += (C_i · S_prev) * exp(cum_i)
        y_c = y_c + torch.einsum(
            "bin,bhpn,bih->bihp", cc.float(), state,
            torch.exp(cum).float()).to(xh.dtype)
        # state update: S = exp(cum_Q) S_prev + Σ_j exp(cum_Q − cum_j) B_j ⊗ Δx_j
        decay_out = torch.exp(cum[:, -1:, :] - cum)          # (B,Q,H)
        sc = torch.einsum("bjn,bjh,bjhp->bhpn", bc.float(),
                          decay_out.float(), xc.float())
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + sc
        ys.append(y_c)
    y = torch.cat(ys, dim=1)                                 # (B,S,H,P)
    return y[:, :s_orig], state


def mamba_apply(params, x, cfg, tp=None,
                with_cache: bool = True) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 block.

    x: (B,S,d) -> (y (B,S,d), cache {conv tail (raw xbc), ssm state}, or
    None without ``with_cache``).  Under a split (``tp``) the parameters
    are the rank's columns and rows, the state the rank's heads and the
    conv tail every channel.
    """
    b, s, d = x.shape
    split = _split(tp)
    if split:
        x = copy_to_model(x, tp)
    z, xbc_raw, dt = _in_proj(params, x, cfg, tp)
    if split:
        xbc_raw = _whole_bc(xbc_raw, cfg, tp)
    conv_tail = xbc_raw[:, -(cfg.ssm_conv - 1):, :] if with_cache else None
    if split and with_cache:   # the x channels of every rank
        n2 = 2 * cfg.ssm_state
        xr, bc = torch.split(conv_tail, [conv_tail.shape[-1] - n2, n2], -1)
        conv_tail = torch.cat([gather_from_model(xr, -1, tp), bc], -1)
    xbc = _causal_conv(xbc_raw, params["conv_w"].to(x.dtype),
                       params["conv_b"].to(x.dtype))
    xs, bmat, cmat = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    xh = xs.reshape(b, s, -1, cfg.ssm_head_dim)
    y, state = _ssd_chunked(xh, dt, params["A_log"], bmat, cmat,
                            cfg.ssm_chunk)
    y = y + params["D"].to(x.dtype)[None, None, :, None] * xh
    y = _gated_norm(y.reshape(b, s, -1), z, params["norm_g"], cfg, tp)
    out = y @ params["out_proj"].to(x.dtype)
    if split:
        out = reduce_from_model(out, tp)
    cache = {"conv": conv_tail, "state": state} if with_cache else None
    return out, cache


def mamba_cache_defs(cfg, batch: int) -> dict:
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    return {
        "conv": ParamDef((batch, cfg.ssm_conv - 1, conv_dim),
                         ("dp", None, "model"), init="zeros"),
        "state": ParamDef((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                          ("dp", "model", None, None), init="zeros"),
    }


def mamba_decode_step(params, cache, x, cfg, tp=None):
    """One-token decode. x: (B,1,d); cache: {conv (B,k-1,C), state (B,H,P,N)}.

    Under a split (``tp``) the state is the rank's heads and the conv
    tail every channel, in and out: one all-gather makes the new token's
    raw [x | B | C] whole."""
    b = x.shape[0]
    split = _split(tp)
    z, xbc, dt = _in_proj(params, x, cfg, tp)                # (B,1,...)
    if split:
        n, m = cfg.ssm_state, tp.size
        xbc = _rank_major(gather_from_model(xbc, -1, tp),
                          (xbc.shape[-1] - 2 * n // m, n // m, n // m), m)
    window = torch.cat([cache["conv"].to(x.dtype), xbc], dim=1)
    conv_w = params["conv_w"].to(x.dtype)
    mine = _rank_channels(window, cfg, tp) if split else window
    y = (mine * conv_w[None, :, :]).sum(dim=1, keepdim=True)
    xbc_t = F.silu(y + params["conv_b"].to(x.dtype)[None, None, :])
    xs, bmat, cmat = _split_xbc(xbc_t, cfg)
    dt = F.softplus(dt.float() + params["dt_bias"].float())  # (B,1,H)
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt[:, 0, :] * A[None, :])              # (B,H)
    xh = xs.reshape(b, -1, cfg.ssm_head_dim)
    dx = xh * dt[:, 0, :, None].to(xh.dtype)
    state = (cache["state"] * decay[:, :, None, None] +
             torch.einsum("bn,bhp->bhpn", bmat[:, 0].float(), dx.float()))
    yh = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), state)
    yh = yh.to(x.dtype) + params["D"].to(x.dtype)[None, :, None] * xh
    y = _gated_norm(yh.reshape(b, 1, -1), z, params["norm_g"], cfg, tp)
    out = y @ params["out_proj"].to(x.dtype)
    if split:
        out = reduce_from_model(out, tp)
    new_cache = {"conv": window[:, 1:, :].to(cache["conv"].dtype),
                 "state": state}
    return out, new_cache
