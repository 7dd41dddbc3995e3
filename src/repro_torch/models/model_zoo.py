"""Model zoo API of the port: the analytic part of ``repro.models.model_zoo``.

    zoo = ModelZoo(cfg)
    flops = zoo.model_flops(shape)   # 6·N·D train, 2·N·D prefill / decode

``param_defs``, ``input_defs``, ``train_loss``, ``prefill`` and ``decode``
(the forward paths on the model stack) come with the ModelZoo slice; the
serving simulator needs only the FLOP accounting.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["ModelZoo"]


class ModelZoo:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

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
