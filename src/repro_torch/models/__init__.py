"""The model stack of the port (``repro.models``).

layers       ``ParamDef`` trees, ``materialize`` (a ``torch.Generator``),
             ``abstract`` (fake tensors for the dry run), the sharding
             specs, rmsnorm / layernorm / swiglu / gelu_mlp / rope
attention    GQA attention: full, query-chunked, decode
mamba2       the Mamba2 SSD block: chunked scan and one-token decode
moe          GShard-style grouped one-hot MoE (ties to the lower expert)
losses       ``chunked_xent``: the sequence-chunked cross-entropy
transformer  every family's defs, caches, training / prefill forward
             (activation checkpointing by ``remat_policy``) and decode
model_zoo    :class:`ModelZoo`: ``param_defs`` / ``cache_defs`` /
             ``input_defs`` / ``train_loss`` / ``prefill`` / ``decode``
             / ``model_flops`` (the serving cost model prices ticks
             with it)

Plain functions over a tree of parameters (nested dicts of tensors), as
in the reference, so a tree matches ``param_defs`` leaf for leaf;
``repro_torch.convert.model_params`` carries the reference's weights
across.
"""
from .layers import materialize
from .model_zoo import InputDef, ModelZoo
from .transformer import widen_caches

__all__ = ["InputDef", "ModelZoo", "materialize", "widen_caches"]
