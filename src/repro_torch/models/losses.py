"""Sequence-chunked cross-entropy (port of ``repro.models.losses``).

The (B, S, V) logits are the largest activation of LM training.  The
loss takes one sequence chunk at a time, each under a non-reentrant
checkpoint that saves only the chunk's inputs (the reference's
``nothing_saveable`` scan body), so that forward and backward hold one
chunk's (B, chunk, V) f32 logits at a time.

Under tensor-parallel compute (``tp``, ``models.parallel``) the head is
this rank's shard: split on the vocabulary, the loss is
vocabulary-parallel (the max and the sum of exponentials all-reduced,
the gold logit from the rank that owns the class, the pad mask on this
rank's classes); the tied ``embed.T`` split on d is row-parallel, its
logits all-reduced.  A chunk's recompute re-runs its collectives in
order on every rank.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .parallel import (copy_to_model, reduce_from_model, vocab_gold,
                       vocab_logsumexp)

__all__ = ["chunked_xent", "head_logits"]


def head_logits(h, head_w, tp=None):
    """f32 logits of the hidden states ``h`` against ``head_w`` (d, V):
    whole, or under ``tp`` this rank's classes (``tp.head == "vocab"``:
    ``head_w`` is this rank's columns) or the row-parallel sum over the
    group (``"rows"``: ``head_w`` is this rank's rows of d)."""
    head = tp.head if tp is not None else None
    if head is not None:
        h = copy_to_model(h, tp)
    if head == "rows":
        n = head_w.shape[0]
        h = h.narrow(-1, tp.rank * n, n)
    logits = (h @ head_w.to(h.dtype)).float()
    if head == "rows":
        logits = reduce_from_model(logits, tp)
    return logits


def _chunk_sum(hc, head_w, yc, pad_mask, tp=None):
    """Σ over one chunk of logsumexp(logits) − the gold logit, in f32."""
    logits = head_logits(hc, head_w, tp)
    if pad_mask is not None:
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    if tp is not None and tp.head == "vocab":
        lse = vocab_logsumexp(logits, tp)
        gold = vocab_gold(logits, yc, tp.rank * logits.shape[-1], tp)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_xent(hidden, head_w, labels, chunk: int, valid_vocab: int = 0,
                 tp=None):
    """hidden: (B,S,d) bf16; head_w: (d,V); labels: (B,S) int -> scalar.

    `valid_vocab`: logical vocab size; padded classes (sharding alignment)
    are masked out of the softmax.  Under ``tp`` (see above) ``head_w``
    is this rank's (d, V / size) columns (``tp.head == "vocab"``) or
    (d / size, V) rows (``"rows"``).
    """
    b, s, d = hidden.shape
    v = head_w.shape[-1]
    vocab = tp is not None and tp.head == "vocab"
    lo, full_v = (tp.rank * v, tp.size * v) if vocab else (0, v)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss_chunk {chunk} != 0")
    pad_mask = (torch.arange(lo, lo + v, device=hidden.device) >= valid_vocab
                if 0 < valid_vocab < full_v else None)
    body = _chunk_sum
    if torch.is_grad_enabled():
        body = functools.partial(checkpoint, _chunk_sum, use_reentrant=False,
                                 preserve_rng_state=False)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(hidden[:, sl], head_w, labels[:, sl], pad_mask,
                             tp)
    return total / (b * s)
