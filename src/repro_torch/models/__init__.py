"""Model definitions of the port: for now the analytic FLOP model only.

:class:`ModelZoo` gives ``model_flops`` (the MODEL_FLOPS accounting the
serving cost model prices ticks with); the forward paths come with the
ModelZoo slice.
"""
from .model_zoo import ModelZoo

__all__ = ["ModelZoo"]
