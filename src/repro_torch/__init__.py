"""repro_torch: the bittide reproduction on PyTorch and CUDA (NVIDIA H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and never imports it or jax.  It holds the
segment-sum core and the paper facade (``repro_torch.core``:
``BittideNetwork``, latency, schedules, DDC, the frame-level oracle),
the fused, tiled, sparse and per-step lanes on hand-written Hopper
kernels (``repro_torch.kernels``), the scenario
layer (``repro_torch.scenarios``), the telemetry types
(``repro_torch.telemetry``), the bittide-paced serving simulator
(``repro_torch.serve``, on the copied ``configs`` and
``models.ModelZoo.model_flops``), straggler pacing (``repro_torch.ft``),
the model stack (``repro_torch.models``: every family's training loss,
prefill and decode), the training path (``repro_torch.optim``: AdamW;
``repro_torch.data``: the synthetic stream; ``repro_torch.checkpoint``;
``repro_torch.launch``: the train step) and ``repro_torch.convert``,
which carries the reference's objects (a model's weights, caches and
optimizer state too) across.  The
reference's one-release legacy engine kwargs warn once per process
(``repro_torch._compat``).
Entry points run on the CUDA card unless called with ``device="cpu"``.
"""
from . import (checkpoint, configs, convert, core, data, ft, kernels, launch,
               models, optim, scenarios, serve, telemetry)

__all__ = ["checkpoint", "configs", "convert", "core", "data", "ft",
           "kernels", "launch", "models", "optim", "scenarios", "serve",
           "telemetry"]
