"""The optimizer of the port (``repro.optim``): functional AdamW over
trees of tensors.  ``optim/compression`` waits for the
``torch.distributed`` slice."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
