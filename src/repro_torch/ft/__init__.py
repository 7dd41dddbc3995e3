"""Fault tolerance on the port: straggler pacing.

``ft.elastic`` (health tracking and re-meshing on ``launch.mesh``) comes
with the launch slice.
"""
from .straggler import StragglerReport, simulate_stragglers

__all__ = ["StragglerReport", "simulate_stragglers"]
