"""Config registry: one module per assigned architecture.

A copy of ``repro.configs`` (pure Python: ``base`` imports only
``dataclasses``), so that the port imports nothing of the reference.  The
serving cost model (:mod:`repro_torch.serve.costmodel`) reads it.
"""
from . import base
from .base import ArchConfig, ShapeSpec, SHAPES, applicable, skip_reason

from . import (phi3_medium_14b, internlm2_1_8b, smollm_135m, llama3_8b,
               seamless_m4t_large_v2, arctic_480b, qwen2_moe_a2_7b,
               mamba2_370m, pixtral_12b, zamba2_7b)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (phi3_medium_14b, internlm2_1_8b, smollm_135m, llama3_8b,
              seamless_m4t_large_v2, arctic_480b, qwen2_moe_a2_7b,
              mamba2_370m, pixtral_12b, zamba2_7b)
}

ARCH_NAMES = sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _REGISTRY[name]
