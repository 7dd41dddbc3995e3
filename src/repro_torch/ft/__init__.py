"""Fault tolerance on the port: elastic re-meshing and straggler pacing.

* :mod:`repro_torch.ft.elastic` — :class:`HealthTracker`,
  :func:`plan_mesh` and :func:`remesh` (the survivors' ``DeviceMesh``);
* :mod:`repro_torch.ft.straggler` — :func:`simulate_stragglers`.
"""
from .elastic import HealthTracker, plan_mesh, remesh
from .straggler import StragglerReport, simulate_stragglers

__all__ = ["HealthTracker", "plan_mesh", "remesh", "StragglerReport",
           "simulate_stragglers"]
