"""bittide-scheduled pipeline parallelism on the port (``repro.sched``)."""
from .pipeline import PipelinePlan, plan, pipeline_apply

__all__ = ["PipelinePlan", "plan", "pipeline_apply"]
