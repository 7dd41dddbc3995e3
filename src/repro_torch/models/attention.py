"""GQA attention: full, query-chunked, and decode paths (port of
``repro.models.attention``), and decode over a cache whose slots are
split across the "model" group (:func:`decode_attention_split`).

All shapes are (batch, seq, heads, head_dim).  GQA reshapes the queries
into (kv_head, group) and never repeats K/V.  Scores and the softmax are
f32; the probabilities are cast to the activation dtype before they
meet V, as in the reference.  The math is written out in einsums so that
the mask convention (``NEG_INF``) and the order of the arithmetic are the
reference's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .parallel import model_all_reduce

__all__ = ["attention", "chunked_attention", "decode_attention",
           "decode_attention_split"]

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q: (B,Sq,H,D), k: (B,Sk,Kh,D) -> f32 scores (B, Kh, G, Sq, Sk).

    The product is rounded to the inputs' dtype and then divided in f32,
    as the reference's division by a float32 numpy scalar promotes it."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    return (torch.einsum("bskgd,btkd->bkgst", qg, k).float()
            / float(np.float32(np.sqrt(d))))


def _gqa_out(probs, v):
    """probs: (B,Kh,G,Sq,Sk), v: (B,Sk,Kh,D) -> (B,Sq,H,D)."""
    b, kh, g, sq, sk = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, kh * g, -1)


def _causal_mask(scores, q0: int):
    """Mask keys after each query; query rows start at position ``q0``."""
    sq, sk = scores.shape[-2], scores.shape[-1]
    qpos = torch.arange(sq, device=scores.device) + q0
    mask = qpos[:, None] >= torch.arange(sk, device=scores.device)[None, :]
    return torch.where(mask, scores, NEG_INF)


def attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Unchunked reference attention (small sequences / smoke tests)."""
    scores = _gqa_scores(q, k)
    if causal:
        scores = _causal_mask(scores, q_offset)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v)


def chunked_attention(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0,
                      causal_unroll: bool = False):
    """Query-chunked attention; memory O(chunk * Sk).

    The reference scans the query chunks; here they are a Python loop, each
    chunk against the full K/V.  ``causal_unroll`` slices K/V to each
    chunk's causal prefix instead, skipping the fully masked blocks.
    """
    b, sq, h, d = q.shape
    if sq <= chunk:
        return attention(q, k, v, causal=causal, q_offset=q_offset)
    if sq % chunk:
        raise ValueError(f"seq {sq} not divisible by chunk {chunk}")
    nq = sq // chunk
    outs = []
    if causal and causal_unroll and q_offset == 0 and k.shape[1] == sq:
        for i in range(nq):
            hi = (i + 1) * chunk
            outs.append(attention(q[:, i * chunk:hi], k[:, :hi], v[:, :hi],
                                  causal=True, q_offset=i * chunk))
        return torch.cat(outs, dim=1)
    for i in range(nq):
        scores = _gqa_scores(q[:, i * chunk:(i + 1) * chunk], k)
        if causal:
            scores = _causal_mask(scores, i * chunk + q_offset)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(_gqa_out(probs, v))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, valid_len: Optional[int] = None):
    """Single-token decode: q (B,1,H,D) against a (B,S,Kh,D) cache."""
    scores = _gqa_scores(q, k_cache)   # (B,Kh,G,1,S)
    if valid_len is not None:
        mask = torch.arange(k_cache.shape[1], device=q.device) < valid_len
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v_cache)


def decode_attention_split(q, k_shard, v_shard, start: int, tp,
                           valid_len: Optional[int] = None):
    """:func:`decode_attention` over a cache whose S slots lie split
    across the "model" group ``tp``: this rank holds slots
    [start, start + S_r) of every kv head (``k_shard`` / ``v_shard``:
    (B, S_r, Kh, D), S_r ≥ 1) and the whole q (B, 1, H, D);
    ``valid_len`` masks global positions.  Flash-decoding's combine:
    each rank takes its max m_r of the f32 scores, l_r = Σ exp(s − m_r)
    and o_r = Σ exp(s − m_r)·v; then M = max over ranks of m_r,
    L = Σ l_r·exp(m_r − M), O = Σ o_r·exp(m_r − M) (three all-reduces,
    no atomics), and the output is O / L in q's dtype.  A group of one
    issues no collective and is :func:`decode_attention` itself.

    Rounding against the plain softmax: there each probability is
    divided by the row's sum before its cast to q's dtype and the
    product with V is rounded once to q's dtype; here the unnormalised
    exp(s − m_r) (relative to this rank's max) is cast to q's dtype,
    each rank's product is rounded to q's dtype, the partials are
    rescaled and summed in f32, and the division by L and the cast to
    q's dtype come last."""
    if tp.size == 1:
        return decode_attention(q, k_shard, v_shard, valid_len)
    scores = _gqa_scores(q, k_shard)   # (B,Kh,G,1,S_r)
    if valid_len is not None:
        pos = torch.arange(start, start + k_shard.shape[1], device=q.device)
        scores = torch.where(pos < valid_len, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    big_m = model_all_reduce(m, tp, "max")
    e = torch.exp(scores - m)
    scale = torch.exp(m - big_m)       # (B,Kh,G,1,1)
    big_l = model_all_reduce(e.sum(-1, keepdim=True) * scale, tp)
    part = _gqa_out(e.to(q.dtype), v_shard)           # (B,1,H,D)
    b, kh, g = scale.shape[:3]
    per_head = lambda t: t.reshape(b, kh * g)[:, None, :, None]
    big_o = model_all_reduce(part.float() * per_head(scale), tp)
    return (big_o / per_head(big_l)).to(q.dtype)
