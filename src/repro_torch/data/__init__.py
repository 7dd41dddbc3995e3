"""The synthetic data stream of the port (``repro.data``)."""
from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
