"""Decoder-only stack covering dense / moe / ssm / hybrid / vlm, plus the
encoder-decoder (port of ``repro.models.transformer``): the training
forward, prefill and the decode step.

Layer weights are stacked on a leading L axis, as in the reference, so a
tree of parameters matches ``model_defs`` leaf for leaf; the reference's
``lax.scan`` over layers is a Python loop over that axis here, so
``cfg.unroll_layers`` changes nothing.  In ``mode="train"`` the forward
builds no caches and checkpoints activations where the reference puts
``jax.checkpoint`` (each layer; the hybrid's whole group; the encoder
and decoder layers), by ``cfg.remat_policy``: ``"nothing"`` saves only
each body's inputs, ``"dots"`` saves the matmul outputs too, ``"none"``
saves everything.  The policy changes memory, not values.

Cache conventions (decode): the KV cache holds ``S`` slots; the decode
step writes the new token's K/V at slot S-1 and attends over all S.
After a prefill of S tokens the caller widens the cache by one slot per
generated token (as ``examples/serve_decode.py`` does).  With
``cfg.kv_cache_dtype="float8_e4m3fn"`` the cache is stored in f8,
converted as ``ml_dtypes`` does (:func:`to_kv_dtype`).

Under tensor-parallel compute (``tp``, ``models.parallel``; every
family) the forward paths take each rank's shards of the split leaves;
decode takes each rank's slice of the K/V caches' sequence (the
hybrid's ``shared_kv`` too) where ``tp.kv_seq`` says so and of the
encoder-decoder's ``cross_kv`` where ``tp.cross_seq`` does, the SSM and
hybrid families' state caches on the rank's heads, and its batch's
slice on a mesh.  On a mesh
the MoE block forms its token groups over the global batch
(``batch_split``, ``models.moe``), and the stacked leaves stored
sharded over the batch axes (FSDP) come as this rank's shards, each
layer's slice gathered inside its body (``fsdp``, ``models.fsdp``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import (chunked_attention, decode_attention,
                        decode_attention_split)
from .layers import ParamDef, rmsnorm, rope, stack_defs, swiglu
from .mamba2 import (mamba_apply, mamba_cache_defs, mamba_decode_step,
                     mamba_defs)
from .moe import moe_apply, moe_defs
from .parallel import (copy_to_model, gather_from_model, gather_kv_heads,
                       reduce_from_model)

__all__ = ["attn_defs", "mlp_defs", "block_defs", "model_defs", "lm_forward",
           "lm_decode_step", "cache_defs", "hidden_for_tokens",
           "to_kv_dtype", "widen_caches"]

# float8_e4m3fn's largest finite value is 448; ml_dtypes rounds |x| up to
# 464 (the tie, to even) onto it and gives NaN beyond (there is no inf),
# where torch's cast saturates to ±448.
_F8_E4M3FN_OVERFLOW = 464.0


def to_kv_dtype(t, dtype: torch.dtype):
    """Cast to the cache's dtype; into float8_e4m3fn as ``ml_dtypes``
    (the reference's ``astype``) does: NaN past the rounding range."""
    if dtype == torch.float8_e4m3fn:
        t = torch.where(t.float().abs() > _F8_E4M3FN_OVERFLOW,
                        float("nan"), t)
    return t.to(dtype)


def widen_caches(caches: dict, slots: int = 1) -> dict:
    """Append ``slots`` empty slots to every self-attention K/V cache
    (``kv`` / ``shared_kv``; the encoder's ``cross_kv`` keeps its length):
    one slot per token a decode step is about to write."""
    out = dict(caches)
    for k in ("kv", "shared_kv"):
        if k in out:
            out[k] = torch.nn.functional.pad(out[k],
                                             (0, 0, 0, 0, 0, slots))
    return out


def _stack(items):
    """Stack per-layer outputs (tensors or dicts of them) on a new axis 0."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def _unstack(tree) -> list:
    """A tree of stacked parameters or caches as a list of per-layer
    trees (views).  One ``unbind`` per leaf: its gradient is one stack,
    where indexing layer by layer would build a zero-filled full-size
    gradient per layer."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


# ----------------------------------------------------------------- attention

def attn_defs(cfg, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, h * hd), ("fsdp", "model")),
        "wk": ParamDef((d, kh * hd), ("fsdp", "model")),
        "wv": ParamDef((d, kh * hd), ("fsdp", "model")),
        "wo": ParamDef((h * hd, d), ("model", "fsdp")),
    }


def _qkv(params, x, cfg):
    """Q, K, V for the heads the weights hold: all of them, or this
    rank's under tensor-parallel compute."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, kh = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, kh, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, kh, hd)
    return q, k, v


def attn_apply(params, x, cfg, *, causal: bool = True, pos0: int = 0,
               use_rope: bool = True, tp=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)).

    Under ``tp`` with a split attention block the weights are this rank's
    heads (``wo`` its rows): (k, v) hold this rank's kv heads and the
    output is all-reduced over the "model" group."""
    b, s, _ = x.shape
    split = tp is not None and tp.attn != "gathered"
    if split:
        x = copy_to_model(x, tp)
    q, k, v = _qkv(params, x, cfg)
    if use_rope:
        positions = torch.arange(s, device=x.device) + pos0
        q = rope(q, positions[None, :], cfg.rope_theta)
        k = rope(k, positions[None, :], cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                            q_offset=pos0, causal_unroll=cfg.attn_causal_unroll)
    out = out.reshape(b, s, -1) @ params["wo"].to(x.dtype)
    if split:
        out = reduce_from_model(out, tp)
    return out, (k, v)


def attn_decode_apply(params, x, cfg, kv_cache, *, use_rope: bool = True,
                      tp=None):
    """One-token decode. kv_cache: (2, B, S, Kh, hd); writes slot S-1 of a
    copy (the caller's cache is left as it was).

    Under ``tp`` with a split attention block the weights are this
    rank's heads: q, k and v are computed column-parallel and gathered
    along the heads, and ``wo`` (this rank's rows) takes this rank's
    slice of the whole output, all-reduced over the group.  With
    ``tp.kv_seq`` the cache is this rank's slice of the S = ``kv_seq``
    slots: only the rank that holds slot S-1 writes it, and attention
    is :func:`~repro_torch.models.attention.decode_attention_split`."""
    b, s_new, _ = x.shape
    if s_new != 1:
        raise ValueError(f"decode takes one token per sequence, got {s_new}")
    q, k, v = _qkv(params, x, cfg)
    split = tp is not None and tp.attn != "gathered"
    if split:
        q = gather_from_model(q, 2, tp)
        k, v = gather_kv_heads(k, tp, cfg), gather_kv_heads(v, tp, cfg)
    held = kv_cache.shape[2]
    seq_split = tp is not None and tp.kv_seq is not None
    slot = (tp.kv_seq if seq_split else held) - 1
    start = tp.rank * held if seq_split else 0
    if use_rope:
        positions = torch.full((1, 1), slot, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    new_kv = kv_cache.clone()   # this rank's slots only, under kv_seq
    if start <= slot < start + held:
        new_kv[0, :, slot - start] = to_kv_dtype(k[:, 0], kv_cache.dtype)
        new_kv[1, :, slot - start] = to_kv_dtype(v[:, 0], kv_cache.dtype)
    k_all, v_all = new_kv[0].to(x.dtype), new_kv[1].to(x.dtype)
    out = (decode_attention_split(q, k_all, v_all, start, tp) if seq_split
           else decode_attention(q, k_all, v_all)).reshape(b, 1, -1)
    if split:
        n = params["wo"].shape[0]
        out = out.narrow(-1, tp.rank * n, n) @ params["wo"].to(x.dtype)
        return reduce_from_model(out, tp), new_kv
    return out @ params["wo"].to(x.dtype), new_kv


def cross_attn_apply(params, x, cfg, memory=None, kv_cache=None, tp=None):
    """Encoder-decoder cross attention; memory (B, S_src, d) or cached K/V
    (2, B, S_src, Kh, hd), which decode reads and never writes.

    Under ``tp`` with a split attention block the weights are this
    rank's heads (``wo`` its rows).  With ``memory``: q from ``x`` and
    k / v from ``memory``, each through ``copy_to_model``; the returned
    (k, v) hold this rank's kv heads and the output is all-reduced over
    the "model" group.  With ``kv_cache`` (decode): q is computed
    column-parallel and gathered along the heads, and ``wo`` takes this
    rank's slice of the whole output, all-reduced.  With
    ``tp.cross_seq`` the cache is this rank's slice of the S_src =
    ``cross_seq`` slots and attention is
    :func:`~repro_torch.models.attention.decode_attention_split`."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    split = tp is not None and tp.attn != "gathered"
    decode = kv_cache is not None
    if split and not decode:
        x, memory = copy_to_model(x, tp), copy_to_model(memory, tp)
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, -1, hd)
    if decode:
        if split:
            q = gather_from_model(q, 2, tp)
        k, v = kv_cache[0].to(x.dtype), kv_cache[1].to(x.dtype)
        new_cache = kv_cache
    else:
        sk = memory.shape[1]
        k = (memory @ params["wk"].to(x.dtype)).reshape(b, sk, -1, hd)
        v = (memory @ params["wv"].to(x.dtype)).reshape(b, sk, -1, hd)
        new_cache = (k, v)
    if decode and tp is not None and tp.cross_seq is not None:
        out = decode_attention_split(q, k, v, tp.rank * k.shape[1], tp)
    else:
        out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    out = out.reshape(b, s, -1)
    if split and decode:
        n = params["wo"].shape[0]
        out = out.narrow(-1, tp.rank * n, n)
    out = out @ params["wo"].to(x.dtype)
    return (reduce_from_model(out, tp) if split else out), new_cache


# ----------------------------------------------------------------------- mlp

def mlp_defs(cfg, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": ParamDef((d, ff), ("fsdp", "model")),
        "w3": ParamDef((d, ff), ("fsdp", "model")),
        "w2": ParamDef((ff, d), ("model", "fsdp")),
    }


def mlp_apply(params, x, tp=None):
    """SwiGLU; under ``tp`` with a split MLP, ``w1`` / ``w3`` are this
    rank's columns and ``w2`` its rows, and the output is all-reduced
    over the "model" group."""
    split = tp is not None and tp.mlp
    if split:
        x = copy_to_model(x, tp)
    out = swiglu(x, params["w1"].to(x.dtype), params["w3"].to(x.dtype),
                 params["w2"].to(x.dtype))
    return reduce_from_model(out, tp) if split else out


# -------------------------------------------------------------------- blocks

def block_defs(cfg) -> dict:
    """One decoder layer's defs, by family."""
    d = cfg.d_model
    if cfg.family in ("dense", "vlm"):
        return {"ln1": ParamDef((d,), (None,), init="ones"),
                "attn": attn_defs(cfg),
                "ln2": ParamDef((d,), (None,), init="ones"),
                "mlp": mlp_defs(cfg)}
    if cfg.family == "moe":
        return {"ln1": ParamDef((d,), (None,), init="ones"),
                "attn": attn_defs(cfg),
                "ln2": ParamDef((d,), (None,), init="ones"),
                "moe": moe_defs(cfg)}
    if cfg.family in ("ssm", "hybrid"):
        return {"ln1": ParamDef((d,), (None,), init="ones"),
                "mamba": mamba_defs(cfg)}
    raise ValueError(cfg.family)


def shared_attn_defs(cfg) -> dict:
    """zamba2's shared attention block: consumes concat(x, x0)."""
    d = cfg.d_model
    return {"w_in": ParamDef((2 * d, d), ("fsdp", "model")),
            "ln1": ParamDef((d,), (None,), init="ones"),
            "attn": attn_defs(cfg),
            "ln2": ParamDef((d,), (None,), init="ones"),
            "mlp": mlp_defs(cfg)}


def block_apply(params, x, cfg, mode: str, kv_cache=None, tp=None,
                batch_split=None):
    """Apply one layer (``mode`` "train", "prefill" or "decode"; ``tp``
    the tensor-parallel compute;
    ``batch_split`` the data ranks of the MoE block's token groups).
    Returns (x, new cache or None in train mode, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        h = rmsnorm(x, params["ln1"])
        if mode == "decode":
            a, new_kv = attn_decode_apply(params["attn"], h, cfg, kv_cache,
                                          tp=tp)
        else:
            a, kv = attn_apply(params["attn"], h, cfg, causal=True, tp=tp)
            new_kv = torch.stack(kv) if mode == "prefill" else None
        x = x + a
        h = rmsnorm(x, params["ln2"])
        if cfg.family == "moe":
            m, aux = moe_apply(params["moe"], h, cfg, tp, batch_split)
        else:
            m = mlp_apply(params["mlp"], h, tp)
        return x + m, new_kv, aux
    # ssm / hybrid mamba layer
    h = rmsnorm(x, params["ln1"])
    if mode == "decode":
        m, new_state = mamba_decode_step(params["mamba"], kv_cache, h, cfg,
                                         tp)
    else:
        m, new_state = mamba_apply(params["mamba"], h, cfg, tp,
                                   with_cache=mode == "prefill")
    return x + m, new_state, aux


def shared_attn_apply(params, x, x0, cfg, mode: str, kv_cache=None,
                      tp=None):
    """zamba2's shared block on ``concat(x, x0)``.  Under ``tp`` with
    ``tp.embed`` (d split), ``w_in`` is this rank's columns of its
    output d, and the projection is gathered along d over the "model"
    group (as the embedding); attention and the MLP split as the dense
    blocks."""
    h = torch.cat([x, x0], dim=-1)
    split = tp is not None and tp.embed
    if split:
        h = copy_to_model(h, tp)
    h = h @ params["w_in"].to(x.dtype)
    if split:
        h = gather_from_model(h, -1, tp)
    h1 = rmsnorm(h, params["ln1"])
    if mode == "decode":
        a, new_kv = attn_decode_apply(params["attn"], h1, cfg, kv_cache,
                                      tp=tp)
    else:
        a, kv = attn_apply(params["attn"], h1, cfg, causal=True, tp=tp)
        new_kv = torch.stack(kv) if mode == "prefill" else None
    h = h + a
    h = h + mlp_apply(params["mlp"], rmsnorm(h, params["ln2"]), tp)
    return x + h, new_kv


# -------------------------------------------------------------- model (defs)

def hybrid_layout(cfg) -> Tuple[int, int, int]:
    """(num_groups, layers_per_group, tail_layers) for zamba2-style stacks."""
    k = cfg.shared_attn_every
    groups = cfg.num_layers // k
    tail = cfg.num_layers - groups * k
    return groups, k, tail


def model_defs(cfg) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab()
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), (None, "model")),
        "final_norm": ParamDef((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, v), ("fsdp", "model"))
    if cfg.family == "encdec":
        enc_block = {"ln1": ParamDef((d,), (None,), init="ones"),
                     "attn": attn_defs(cfg),
                     "ln2": ParamDef((d,), (None,), init="ones"),
                     "mlp": mlp_defs(cfg)}
        dec_block = {"ln1": ParamDef((d,), (None,), init="ones"),
                     "attn": attn_defs(cfg),
                     "lnx": ParamDef((d,), (None,), init="ones"),
                     "xattn": attn_defs(cfg),
                     "ln2": ParamDef((d,), (None,), init="ones"),
                     "mlp": mlp_defs(cfg)}
        defs["encoder"] = stack_defs(enc_block, cfg.encoder_layers)
        defs["decoder"] = stack_defs(dec_block, cfg.decoder_layers)
        defs["enc_final_norm"] = ParamDef((d,), (None,), init="ones")
        return defs
    if cfg.family == "hybrid":
        groups, k, tail = hybrid_layout(cfg)
        defs["shared_attn"] = shared_attn_defs(cfg)
        defs["groups"] = stack_defs(stack_defs(block_defs(cfg), k), groups)
        if tail:
            defs["tail"] = stack_defs(block_defs(cfg), tail)
        return defs
    defs["layers"] = stack_defs(block_defs(cfg), cfg.num_layers)
    return defs


def cache_defs(cfg, batch: int, seq: int) -> dict:
    """Decode-cache defs (zero-initialized)."""
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    kv = lambda l: ParamDef((l, 2, batch, seq, kh, hd),
                            (None, None, "dp", "model", None, None),
                            init="zeros")
    if cfg.family in ("dense", "vlm", "moe"):
        return {"kv": kv(cfg.num_layers)}
    if cfg.family == "ssm":
        return {"mamba": stack_defs(mamba_cache_defs(cfg, batch), cfg.num_layers)}
    if cfg.family == "hybrid":
        groups, k, tail = hybrid_layout(cfg)
        out = {"mamba": stack_defs(stack_defs(mamba_cache_defs(cfg, batch), k), groups),
               "shared_kv": kv(groups)}
        if tail:
            out["mamba_tail"] = stack_defs(mamba_cache_defs(cfg, batch), tail)
        return out
    if cfg.family == "encdec":
        return {"kv": kv(cfg.decoder_layers),
                "cross_kv": ParamDef((cfg.decoder_layers, 2, batch, seq, kh, hd),
                                     (None, None, "dp", "model", None, None),
                                     init="zeros")}
    raise ValueError(cfg.family)


# ------------------------------------------------------------- model (apply)

def hidden_for_tokens(params, tokens, cfg, tp=None):
    """Embedding lookup; activations are always bf16.  Under ``tp`` with
    the embedding split on d, this rank's slice of d is looked up and
    gathered along d over the "model" group."""
    x = params["embed"][tokens.long()].to(torch.bfloat16)
    if tp is not None and tp.embed:
        x = gather_from_model(x, -1, tp)
    return x


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the matmuls'
    outputs, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, cfg, mode: str):
    """``body`` under activation checkpointing per ``cfg.remat_policy``
    when it trains (``mode="train"`` with gradients on), else as it is.
    The parameters reach ``body`` as arguments or through its closure;
    only the non-reentrant checkpoint sees the latter."""
    if mode != "train" or not torch.is_grad_enabled():
        return body
    if cfg.remat_policy == "none":
        return body
    if cfg.remat_policy == "nothing":
        kw = {}
    elif cfg.remat_policy == "dots":
        kw = dict(context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    else:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}")
    return functools.partial(checkpoint, body, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _gathered(body, gather):
    """``body`` taking a layer's parameters as ``gather`` turns them into
    the tensors it computes with (``models.fsdp``: this rank's shards
    gathered over the axes that hold them); ``body`` itself where
    ``gather`` is None."""
    if gather is None:
        return body
    return lambda lp, *args: body(gather(lp), *args)


def _gather_at(fsdp, key: str):
    """``fsdp``'s gather of one layer of the stack ``key``, or None."""
    return None if fsdp is None else fsdp.at(key)


def _run_layers(layers_params, x, cfg, mode, caches=None, remat=True,
                tp=None, batch_split=None, gather=None):
    """Apply stacked layers in order, threading per-layer caches in and
    out.  Returns (x, stacked new caches or None in train mode, summed
    aux).  ``gather`` (``models.fsdp``): each layer's parameters are
    gathered from this rank's shards inside the layer's body.  A
    layer's recompute under its checkpoint runs its collectives (and its
    gather) again, in the same order on every rank."""
    body = _gathered(block_apply, gather)
    body = _remat(body, cfg, mode) if remat else body
    layers = _unstack(layers_params)
    caches = [None] * len(layers) if caches is None else _unstack(caches)
    new, aux = [], 0.0
    for lp, cache in zip(layers, caches):
        x, c, a = body(lp, x, cfg, mode, cache, tp, batch_split)
        new.append(c)
        aux = aux + a
    return x, (_stack(new) if mode != "train" else None), aux


def lm_forward(params, inputs: Dict[str, Any], cfg, mode: str = "train",
               tp=None, batch_split=None, fsdp=None):
    """Forward over a full sequence, ``mode`` "train" or "prefill".

    Returns (hidden (B,S,d), caches (prefill) or None (train), aux).
    `inputs`: tokens (B,S) [+ patch_embeds for vlm | src_embeds for encdec].
    ``tp`` (:class:`~repro_torch.models.parallel.TensorParallel`, every
    family): the parameters are this rank's shards of the split leaves,
    the hidden states the full ones (the VLM's patch embeddings
    overwrite the first positions after the embedding's gather, on every
    rank; the encoder-decoder's encoder output too), prefill's K/V
    caches (the hybrid's ``shared_kv``, the encoder-decoder's
    ``cross_kv``) hold this rank's kv heads and its SSM states this
    rank's heads (the conv tails every channel).  ``batch_split``
    (:class:`~repro_torch.models.parallel.BatchSplit`): the data ranks
    ``inputs`` is this rank's slice of, for the MoE block's groups.
    ``fsdp`` (:class:`~repro_torch.models.fsdp.LayerGather`): the
    stacked leaves it names are this rank's shards, gathered layer by
    layer.
    """
    _check_tp(tp, cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"lm_forward: mode={mode!r}")
    if cfg.family == "encdec":
        return _encdec_forward(params, inputs, cfg, mode, tp, fsdp)

    x = hidden_for_tokens(params, inputs["tokens"], cfg, tp)
    if cfg.family == "vlm" and cfg.num_patch_tokens and "patch_embeds" in inputs:
        pe = inputs["patch_embeds"].to(x.dtype)
        x = x.clone()
        x[:, :pe.shape[1]] = pe   # patch embeddings overwrite the first slots

    if cfg.family == "hybrid":
        return _hybrid_forward(params, x, cfg, mode, tp, fsdp)

    x, new_caches, aux = _run_layers(params["layers"], x, cfg, mode, tp=tp,
                                     batch_split=batch_split,
                                     gather=_gather_at(fsdp, "layers"))
    x = rmsnorm(x, params["final_norm"])
    if mode == "train":
        return x, None, aux
    key = "kv" if cfg.family in ("dense", "vlm", "moe") else "mamba"
    return x, {key: new_caches}, aux


def _hybrid_forward(params, x, cfg, mode, tp=None, fsdp=None):
    """The shared block then a group of Mamba2 layers, group by group
    (each group one checkpoint: its recompute issues the group's
    collectives, and gathers its layers, again, in the same order on
    every rank), then the tail."""
    tail = hybrid_layout(cfg)[2]
    x0 = x
    gather = _gather_at(fsdp, "groups")

    def group_body(gp, x):
        x, kv = shared_attn_apply(params["shared_attn"], x, x0, cfg, mode,
                                  tp=tp)
        x, st, a = _run_layers(gp, x, cfg, mode, remat=False, tp=tp,
                               gather=gather)
        return x, kv, st, a

    group_body = _remat(group_body, cfg, mode)
    shared, states, aux = [], [], 0.0
    for gp in _unstack(params["groups"]):
        x, kv, st, a = group_body(gp, x)
        shared.append(kv)
        states.append(st)
        aux = aux + a
    if tail:
        x, tail_states, a = _run_layers(params["tail"], x, cfg, mode, tp=tp,
                                        gather=_gather_at(fsdp, "tail"))
        aux = aux + a
    x = rmsnorm(x, params["final_norm"])
    if mode == "train":
        return x, None, aux
    caches = {"mamba": _stack(states), "shared_kv": _stack(shared)}
    if tail:
        caches["mamba_tail"] = tail_states
    return x, caches, aux


def _enc_layer(lp, x, cfg, tp=None):
    a, _ = attn_apply(lp["attn"], rmsnorm(x, lp["ln1"]), cfg, causal=False,
                      tp=tp)
    x = x + a
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), tp)


def _dec_layer(lp, x, memory, cfg, mode, tp=None):
    a, kv = attn_apply(lp["attn"], rmsnorm(x, lp["ln1"]), cfg, causal=True,
                       tp=tp)
    x = x + a
    a, xkv = cross_attn_apply(lp["xattn"], rmsnorm(x, lp["lnx"]), cfg,
                              memory=memory, tp=tp)
    x = x + a
    x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), tp)
    if mode == "train":
        return x, None
    return x, (torch.stack(kv), torch.stack(xkv))


def _encdec_forward(params, inputs, cfg, mode, tp=None, fsdp=None):
    """The encoder over ``src_embeds``, then the decoder over ``tokens``
    attending to the encoder's output; each encoder and decoder layer one
    checkpoint, whose recompute issues its collectives (and its gather)
    again, in the same order on every rank."""
    memory = inputs["src_embeds"].to(torch.bfloat16)
    enc_body = _remat(_gathered(_enc_layer, _gather_at(fsdp, "encoder")),
                      cfg, mode)
    for lp in _unstack(params["encoder"]):
        memory = enc_body(lp, memory, cfg, tp)
    memory = rmsnorm(memory, params["enc_final_norm"])

    x = hidden_for_tokens(params, inputs["tokens"], cfg, tp)
    dec_body = _remat(_gathered(_dec_layer, _gather_at(fsdp, "decoder")),
                      cfg, mode)
    caches = []
    for lp in _unstack(params["decoder"]):
        x, c = dec_body(lp, x, memory, cfg, mode, tp)
        caches.append(c)
    x = rmsnorm(x, params["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x, None, aux
    return x, {"kv": torch.stack([c[0] for c in caches]),
               "cross_kv": torch.stack([c[1] for c in caches])}, aux


# ------------------------------------------------------------------- decode

def _check_tp(tp, cfg):
    if tp is not None and cfg.family not in ("dense", "vlm", "moe", "ssm",
                                             "hybrid", "encdec"):
        raise ValueError(f"tensor-parallel compute covers the dense, VLM, "
                         f"MoE, SSM, hybrid and encoder-decoder families, "
                         f"not {cfg.family!r}")


def lm_decode_step(params, caches, inputs, cfg, tp=None, batch_split=None,
                   fsdp=None):
    """One-token decode. inputs: tokens (B,1). Returns (hidden, new caches).

    ``tp`` (every family): the parameters are this rank's shards of the
    split leaves and, with ``tp.kv_seq``, the K/V caches (the hybrid's
    ``shared_kv``) this rank's slice of their sequence, returned so;
    with ``tp.cross_seq`` the encoder-decoder's ``cross_kv`` this
    rank's slice of the source's sequence, returned as it came; the SSM
    states (the hybrid's groups' and tail's) this rank's heads and the
    conv tails every channel.
    ``batch_split`` and ``fsdp``: as :func:`lm_forward`'s."""
    _check_tp(tp, cfg)
    x = hidden_for_tokens(params, inputs["tokens"], cfg, tp)

    if cfg.family in ("dense", "vlm", "moe"):
        x, new_kv, _ = _run_layers(params["layers"], x, cfg, "decode",
                                   caches["kv"], tp=tp,
                                   batch_split=batch_split,
                                   gather=_gather_at(fsdp, "layers"))
        return rmsnorm(x, params["final_norm"]), {"kv": new_kv}

    if cfg.family == "ssm":
        x, new_st, _ = _run_layers(params["layers"], x, cfg, "decode",
                                   caches["mamba"], tp=tp,
                                   gather=_gather_at(fsdp, "layers"))
        return rmsnorm(x, params["final_norm"]), {"mamba": new_st}

    if cfg.family == "hybrid":
        tail = hybrid_layout(cfg)[2]
        x0 = x
        kvs, states = [], []
        gather = _gather_at(fsdp, "groups")
        for gp, kv, st in zip(_unstack(params["groups"]),
                              _unstack(caches["shared_kv"]),
                              _unstack(caches["mamba"])):
            x, kv = shared_attn_apply(params["shared_attn"], x, x0, cfg,
                                      "decode", kv, tp)
            x, st, _ = _run_layers(gp, x, cfg, "decode", st, tp=tp,
                                   gather=gather)
            kvs.append(kv)
            states.append(st)
        new_caches = {"shared_kv": torch.stack(kvs), "mamba": _stack(states)}
        if tail:
            x, new_caches["mamba_tail"], _ = _run_layers(
                params["tail"], x, cfg, "decode", caches["mamba_tail"],
                tp=tp, gather=_gather_at(fsdp, "tail"))
        return rmsnorm(x, params["final_norm"]), new_caches

    if cfg.family == "encdec":
        kvs = []
        gather = _gather_at(fsdp, "decoder") or (lambda lp: lp)
        for lp, kv, xkv in zip(_unstack(params["decoder"]),
                               _unstack(caches["kv"]),
                               _unstack(caches["cross_kv"])):
            lp = gather(lp)
            a, kv = attn_decode_apply(lp["attn"], rmsnorm(x, lp["ln1"]), cfg,
                                      kv, tp=tp)
            x = x + a
            a, _ = cross_attn_apply(lp["xattn"], rmsnorm(x, lp["lnx"]), cfg,
                                    kv_cache=xkv, tp=tp)
            x = x + a
            x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"]), tp)
            kvs.append(kv)
        return (rmsnorm(x, params["final_norm"]),
                {"kv": torch.stack(kvs), "cross_kv": caches["cross_kv"]})

    raise ValueError(cfg.family)
