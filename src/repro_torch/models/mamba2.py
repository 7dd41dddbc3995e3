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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDef, rmsnorm

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


def _in_proj(params, x, cfg):
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    return torch.split(zxbcdt, [d_inner, conv_dim, nheads], dim=-1)


def _split_xbc(xbc, cfg):
    d_inner, _, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    return torch.split(xbc, [d_inner, n, n], dim=-1)  # xs, B, C


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


def mamba_apply(params, x, cfg) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 block.

    x: (B,S,d) -> (y (B,S,d), cache {conv tail (raw xbc), ssm state}).
    """
    b, s, d = x.shape
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    z, xbc_raw, dt = _in_proj(params, x, cfg)
    conv_tail = xbc_raw[:, -(cfg.ssm_conv - 1):, :]
    xbc = _causal_conv(xbc_raw, params["conv_w"].to(x.dtype),
                       params["conv_b"].to(x.dtype))
    xs, bmat, cmat = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    xh = xs.reshape(b, s, nheads, cfg.ssm_head_dim)
    y, state = _ssd_chunked(xh, dt, params["A_log"], bmat, cmat,
                            cfg.ssm_chunk)
    y = y + params["D"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(b, s, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm_g"])
    cache = {"conv": conv_tail, "state": state}
    return y @ params["out_proj"].to(x.dtype), cache


def mamba_cache_defs(cfg, batch: int) -> dict:
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    return {
        "conv": ParamDef((batch, cfg.ssm_conv - 1, conv_dim),
                         ("dp", None, "model"), init="zeros"),
        "state": ParamDef((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                          ("dp", "model", None, None), init="zeros"),
    }


def mamba_decode_step(params, cache, x, cfg):
    """One-token decode. x: (B,1,d); cache: {conv (B,k-1,C), state (B,H,P,N)}."""
    b = x.shape[0]
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    z, xbc, dt = _in_proj(params, x, cfg)                    # (B,1,...)
    window = torch.cat([cache["conv"].to(x.dtype), xbc], dim=1)
    conv_w = params["conv_w"].to(x.dtype)
    y = (window * conv_w[None, :, :]).sum(dim=1, keepdim=True)
    xbc_t = F.silu(y + params["conv_b"].to(x.dtype)[None, None, :])
    xs, bmat, cmat = _split_xbc(xbc_t, cfg)
    dt = F.softplus(dt.float() + params["dt_bias"].float())  # (B,1,H)
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt[:, 0, :] * A[None, :])              # (B,H)
    xh = xs.reshape(b, nheads, cfg.ssm_head_dim)
    dx = xh * dt[:, 0, :, None].to(xh.dtype)
    state = (cache["state"] * decay[:, :, None, None] +
             torch.einsum("bn,bhp->bhpn", bmat[:, 0].float(), dx.float()))
    yh = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), state)
    yh = yh.to(x.dtype) + params["D"].to(x.dtype)[None, :, None] * xh
    y = yh.reshape(b, 1, d_inner)
    y = rmsnorm(y * F.silu(z), params["norm_g"])
    out = y @ params["out_proj"].to(x.dtype)
    new_cache = {"conv": window[:, 1:, :].to(cache["conv"].dtype),
                 "state": state}
    return out, new_cache
