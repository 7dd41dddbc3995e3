"""repro_torch: the bittide reproduction on PyTorch and CUDA (NVIDIA H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and never imports it or jax.  Slice 1 holds the
segment-sum core (``repro_torch.core``), the dense fused lane on a
hand-written Hopper kernel (``repro_torch.kernels``), the telemetry types
(``repro_torch.telemetry``) and ``repro_torch.convert``, which carries the
reference's objects across.  Entry points run on the CUDA card unless
called with ``device="cpu"``.
"""
from . import convert, core, kernels, telemetry

__all__ = ["convert", "core", "kernels", "telemetry"]
