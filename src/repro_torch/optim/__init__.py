"""The optimizer of the port (``repro.optim``): functional AdamW over
trees of tensors, and the error-feedback int8 compression of the
data-parallel all-reduce (``optim.compression``, on
``torch.distributed``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
