"""Sequence-chunked cross-entropy (port of ``repro.models.losses``).

The (B, S, V) logits are the largest activation of LM training.  The
loss takes one sequence chunk at a time, each under a non-reentrant
checkpoint that saves only the chunk's inputs (the reference's
``nothing_saveable`` scan body), so that forward and backward hold one
chunk's (B, chunk, V) f32 logits at a time.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_xent"]


def _chunk_sum(hc, head_w, yc, pad_mask):
    """Σ over one chunk of logsumexp(logits) − the gold logit, in f32."""
    logits = (hc @ head_w.to(hc.dtype)).float()
    if pad_mask is not None:
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_xent(hidden, head_w, labels, chunk: int, valid_vocab: int = 0):
    """hidden: (B,S,d) bf16; head_w: (d,V); labels: (B,S) int -> scalar.

    `valid_vocab`: logical vocab size; padded classes (sharding alignment)
    are masked out of the softmax.
    """
    b, s, d = hidden.shape
    v = head_w.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss_chunk {chunk} != 0")
    pad_mask = (torch.arange(v, device=hidden.device) >= valid_vocab
                if 0 < valid_vocab < v else None)
    body = _chunk_sum
    if torch.is_grad_enabled():
        body = functools.partial(checkpoint, _chunk_sum, use_reentrant=False,
                                 preserve_rng_state=False)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(hidden[:, sl], head_w, labels[:, sl], pad_mask)
    return total / (b * s)
