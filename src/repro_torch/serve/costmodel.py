"""Analytic prefill/decode step costs from the ModelZoo FLOP model.

Port of ``repro.serve.costmodel``.  The serving simulator does not run
forward passes per tick; it prices each scheduler action with the
``MODEL_FLOPS`` accounting of :meth:`repro_torch.models.ModelZoo.model_flops`:
2·N_active FLOPs per inference token.

Costs are per WORKER step of a *simulated* serving cluster: the model is
sharded across the bittide ensemble's workers, so one global decode step
needs a step from every worker and the pacing discipline decides how their
clocks compose (see :mod:`repro_torch.serve.pacing`).  ``hw_flops`` and the
MFU defaults are parameters of that simulated cluster's accelerators, not
figures of the card the ensemble runs on (nor of a TPU).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import ModelZoo

__all__ = ["StepCostModel"]


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Wall-clock prices of the scheduler's two actions, at nominal rate.

    decode_step_s: one continuous-batching decode step with every slot
      occupied (one token per occupied sequence).
    prefill_token_s: per prompt token of chunked prefill.
    arch: architecture name the costs were derived from (labels only).
    """

    decode_step_s: float
    prefill_token_s: float
    arch: str = "analytic"

    def __post_init__(self):
        if self.decode_step_s <= 0 or self.prefill_token_s <= 0:
            raise ValueError("step costs must be positive")

    @classmethod
    def from_zoo(cls, arch: str | ArchConfig, *, decode_slots: int,
                 hw_flops: float = 1.0e14,
                 mfu_decode: float = 0.08,
                 mfu_prefill: float = 0.45) -> "StepCostModel":
        """Price steps for ``arch`` on a simulated accelerator of
        ``hw_flops``.

        MODEL_FLOPS / (hw_flops · MFU): decode is memory-bound (low MFU),
        prefill compute-bound (high MFU) — the defaults are the usual
        published serving efficiencies, overridable per experiment.
        """
        cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
        zoo = ModelZoo(cfg)
        decode = ShapeSpec("serve_decode", "decode", seq_len=1,
                           global_batch=max(decode_slots, 1))
        prefill = ShapeSpec("serve_prefill", "prefill", seq_len=1,
                            global_batch=1)
        return cls(
            decode_step_s=zoo.model_flops(decode) / (hw_flops * mfu_decode),
            prefill_token_s=zoo.model_flops(prefill)
            / (hw_flops * mfu_prefill),
            arch=cfg.name)

    def tick_seconds(self, occupied_slots: int, prefill_tokens: int,
                     total_slots: int) -> float:
        """Price one scheduler tick at nominal (rate-1) clocks.

        The decode matmuls launch at batch = total_slots whenever any
        slot is live (the continuous-batching kernel shape is static);
        prefill chunks share the tick (Orca/vLLM-style piggybacking), so
        their token cost adds on top.
        """
        dec = self.decode_step_s if occupied_slots > 0 else 0.0
        del total_slots  # static kernel shape: cost independent of fill
        return dec + prefill_tokens * self.prefill_token_s
