"""repro_torch: the bittide reproduction on PyTorch and CUDA (NVIDIA H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and never imports it or jax.  It holds the
segment-sum core and the paper facade (``repro_torch.core``:
``BittideNetwork``, latency, schedules, DDC, the frame-level oracle),
the fused, tiled, sparse and per-step lanes on hand-written Hopper
kernels (``repro_torch.kernels``), the scenario
layer (``repro_torch.scenarios``), the telemetry types
(``repro_torch.telemetry``) and ``repro_torch.convert``, which carries the
reference's objects across.  Entry points run on the CUDA card unless
called with ``device="cpu"``.
"""
from . import convert, core, kernels, scenarios, telemetry

__all__ = ["convert", "core", "kernels", "scenarios", "telemetry"]
