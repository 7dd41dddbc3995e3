"""Fusion-aware analytic HBM-traffic model (port of
``repro.launch.memmodel``, number for number).

The dry run's per-op byte count (``launch.hloanalysis``: every dispatched
operation's inputs and outputs, nothing fused) overstates what a device
reads and writes: elementwise chains, softmax and flash-style attention
keep their intermediates on chip.  For the roofline's "deployable
bound" this module gives an analytic per-device traffic model instead:

  train:   weights (fwd read + bwd read [+ remat re-read] + grad write)
         + optimizer (read+write moments, write params)
         + saved residual activations (write fwd, read bwd) × remat factor
         + logits chunks (write+read, f32)
  prefill: weights read + KV cache write + residual write
  decode:  weights read + KV/state cache read (the dominant stream)

Everything is derived from the ArchConfig + ShapeSpec + sharding profile;
nothing is traced.  The constants (a model axis of 16, ``tp=16``) are the
production meshes' (16, 16) and (2, 16, 16) shapes, the same in both
packages.  This is a *lower-bound-flavored* estimate (perfect fusion);
reality sits between it and the per-op figure.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["analytic_hbm_bytes"]

_DT = {"float32": 4, "bfloat16": 2, "float8_e4m3fn": 1}


def _dp_chips(cfg: ArchConfig, chips: int, tp: int = 16) -> int:
    if cfg.sharding_profile in ("dp", "zero3"):
        return chips
    return chips // tp


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeSpec, chips: int = 256) -> float:
    """Per-chip HBM bytes per step under perfect fusion."""
    pbytes = cfg.param_count() * _DT[cfg.param_dtype]
    w_dev = pbytes / chips  # weights are fully sharded in every profile
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    l = cfg.num_layers
    dp = _dp_chips(cfg, chips)
    b_loc = max(1, b // dp)

    if shape.kind == "train":
        mdt = _DT[cfg.opt_moment_dtype]
        opt = 2 * (cfg.param_count() / chips) * mdt * 2  # r+w of mu and nu
        grads = w_dev  # write (reduce output)
        remat_reads = w_dev if cfg.remat_policy != "none" else 0.0
        weights = 2 * w_dev + remat_reads + grads + opt + w_dev  # + param write
        acts_saved = l * b_loc * s * d * 2  # residual carries, bf16
        remat_factor = 2.0 if cfg.remat_policy != "none" else 1.0
        acts = acts_saved * (1 + remat_factor)  # write fwd + read(s) bwd
        v_loc = cfg.padded_vocab() / (1 if cfg.sharding_profile != "tp" else 16)
        logits = 2 * b_loc * s * v_loc * 4 / (dp / dp)  # w+r, f32, per chip
        return weights + acts + logits

    if shape.kind == "prefill":
        kh, hd = max(cfg.num_kv_heads, 1), max(cfg.head_dim, 1)
        kv_write = l * b_loc * s * kh * hd * 2 * _DT[cfg.kv_cache_dtype]
        acts = l * b_loc * s * d * 2
        return w_dev + kv_write / 16 + acts  # cache seq-sharded over model

    # decode: weights + cache streams
    kh, hd = max(cfg.num_kv_heads, 1), max(cfg.head_dim, 1)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        layers = cfg.decoder_layers if cfg.family == "encdec" else l
        cache = layers * 2 * b_loc * s * kh * hd * _DT[cfg.kv_cache_dtype]
        cache = cache / 16  # seq dim sharded over model axis
        if cfg.family == "encdec":
            cache *= 2  # + cross-attention cache
    elif cfg.family == "ssm":
        d_inner = cfg.ssm_expand * d
        nheads = d_inner // cfg.ssm_head_dim
        cache = l * b_loc * (nheads * cfg.ssm_head_dim * cfg.ssm_state * 4 +
                             (cfg.ssm_conv - 1) * (d_inner + 2 * cfg.ssm_state) * 2)
    else:  # hybrid
        d_inner = cfg.ssm_expand * d
        nheads = d_inner // cfg.ssm_head_dim
        groups = l // max(1, cfg.shared_attn_every)
        cache = (l * b_loc * nheads * cfg.ssm_head_dim * cfg.ssm_state * 4 +
                 groups * 2 * b_loc * s * kh * hd * _DT[cfg.kv_cache_dtype] / 16)
    # MoE decode reads only the active experts' weights
    if cfg.family == "moe":
        w_dev = cfg.active_param_count() * _DT[cfg.param_dtype] / chips
    return w_dev + cache
