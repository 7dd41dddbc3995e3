"""Model zoo API of the port: the entry points of
``repro.models.model_zoo``.

    zoo = ModelZoo(cfg)
    defs   = zoo.param_defs()                   # ParamDef tree
    params = materialize(defs, generator, torch.float32)   # on the card
    batch  = zoo.input_defs(shape)              # InputDef tree (+ dtypes)
    loss   = zoo.train_loss(params, batch)      # differentiable scalar
    logits, caches = zoo.prefill(params, batch)
    logits, caches = zoo.decode(params, widen_caches(caches), {"tokens": t})
    flops  = zoo.model_flops(shape)             # 6·N·D train, 2·N·D serve

The tensors handed to the forward paths carry the device;
``materialize`` runs on the CUDA card unless called with ``device="cpu"``,
and raises with no card.  ``train_loss`` is differentiated with
``torch.autograd`` (``repro_torch.launch.train.value_and_grad``);
``prefill`` builds the decode caches, and serving may run it and
``decode`` under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

from .losses import chunked_xent, head_logits
from .parallel import gather_from_model
from .transformer import cache_defs, lm_decode_step, lm_forward, model_defs

__all__ = ["ModelZoo", "InputDef"]


@dataclasses.dataclass(frozen=True)
class InputDef:
    """Like ParamDef but with an explicit dtype (tokens are int32)."""
    shape: Tuple[int, ...]
    spec: Tuple[Any, ...]
    dtype: Any


class ModelZoo:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ------------------------------------------------------------ structure
    def param_defs(self):
        return model_defs(self.cfg)

    def cache_defs(self, shape: ShapeSpec):
        return cache_defs(self.cfg, shape.global_batch, shape.seq_len)

    def input_defs(self, shape: ShapeSpec) -> Dict[str, InputDef]:
        cfg = self.cfg
        b = shape.global_batch
        s = 1 if shape.kind == "decode" else shape.seq_len
        toks = InputDef((b, s), ("dp", None), torch.int32)
        out = {"tokens": toks}
        if shape.kind == "train":
            out["labels"] = InputDef((b, s), ("dp", None), torch.int32)
        if cfg.family == "vlm" and shape.kind != "decode":
            n = min(cfg.num_patch_tokens, shape.seq_len)
            out["patch_embeds"] = InputDef((b, n, cfg.d_model),
                                           ("dp", None, None), torch.bfloat16)
        if cfg.family == "encdec" and shape.kind != "decode":
            out["src_embeds"] = InputDef((b, shape.seq_len, cfg.d_model),
                                         ("dp", None, None), torch.bfloat16)
        return out

    # ------------------------------------------------------------- fwd paths
    def train_loss(self, params, batch, tp=None, batch_split=None,
                   fsdp=None) -> torch.Tensor:
        """Mean next-token cross-entropy over the batch (``tokens``,
        ``labels``, and the family's embeddings) + 0.01 · the MoE
        balance term.  ``tp``: tensor-parallel compute over "model"
        (``models.parallel``; ``params`` then holds this rank's shards
        of the split leaves); the loss is the same on every rank.
        ``batch_split``: the data ranks ``batch`` is this rank's slice
        of (``models.parallel.BatchSplit``; the MoE block's groups).
        ``fsdp`` (``models.fsdp.LayerGather``): the stacked leaves it
        names are this rank's shards, gathered layer by layer."""
        cfg = self.cfg
        hidden, _, aux = lm_forward(params, batch, cfg, mode="train", tp=tp,
                                    batch_split=batch_split, fsdp=fsdp)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        loss = chunked_xent(hidden, head, batch["labels"], cfg.loss_chunk,
                            valid_vocab=cfg.vocab_size, tp=tp)
        return loss + 0.01 * aux

    def prefill(self, params, batch, tp=None, batch_split=None, fsdp=None):
        """Full-sequence forward: (last-position logits (B, 1, vocab) f32,
        caches).  Under ``tp`` the logits are whole on every rank and the
        K/V caches hold this rank's kv heads."""
        hidden, caches, _ = lm_forward(params, batch, self.cfg,
                                       mode="prefill", tp=tp,
                                       batch_split=batch_split, fsdp=fsdp)
        return self._last_logits(params, hidden, tp), caches

    def decode(self, params, caches, batch, tp=None, batch_split=None,
               fsdp=None):
        """One token per sequence against ``caches`` (widened by the
        caller): (logits (B, 1, vocab) f32, new caches).  Under ``tp``
        the logits are whole on every rank and, with ``tp.kv_seq``, the
        K/V caches this rank's slice of their sequence."""
        hidden, new_caches = lm_decode_step(params, caches, batch, self.cfg,
                                            tp, batch_split, fsdp)
        return self._last_logits(params, hidden, tp), new_caches

    def _last_logits(self, params, hidden, tp=None):
        cfg = self.cfg
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = head_logits(hidden[:, -1:, :], head, tp)
        if tp is not None and tp.head == "vocab":
            logits = gather_from_model(logits, -1, tp)
        return logits[:, :, :cfg.vocab_size]  # drop sharding-pad classes

    # ------------------------------------------------------ analytic model
    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N active params."""
        n = self.cfg.active_param_count()
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            return 6.0 * n * tokens
        if shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            return 2.0 * n * tokens
        return 2.0 * n * shape.global_batch  # decode: one token per sequence
