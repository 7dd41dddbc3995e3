"""Elastic scaling: remesh around failed hosts and resume from checkpoint
(port of ``repro.ft.elastic``).

Policy: the model axis (TP degree) is fixed by the architecture's
sharding; failures shrink the *data* axis.  Given the surviving ranks we
build the largest (data, model) mesh that fits, restore the latest
checkpoint onto it (``checkpoint.restore(..., shardings=...)`` places
each leaf by DTensor placements on any mesh), and continue at the
recorded step.  The data pipeline is stateless-by-step so no data state
is lost.  On a fleet the survivors restart as a fresh world (a new
``init_process_group`` over them) and call :func:`remesh` there.

Failure *detection* on real fleets comes from the runtime (missed
heartbeats); here :class:`HealthTracker` provides the same interface for
tests and simulations.  ``HealthTracker`` and :func:`plan_mesh` are the
reference's, copied as they are.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.launch.mesh import make_mesh_from_devices

__all__ = ["HealthTracker", "plan_mesh", "remesh"]


@dataclasses.dataclass
class HealthTracker:
    """Heartbeat bookkeeping (simulated clock for tests)."""

    num_hosts: int
    timeout_s: float = 10.0

    def __post_init__(self):
        self.last_seen = {h: 0.0 for h in range(self.num_hosts)}
        self.now = 0.0

    def heartbeat(self, host: int, t: Optional[float] = None):
        self.now = t if t is not None else self.now
        self.last_seen[host] = self.now

    def advance(self, dt: float):
        self.now += dt

    def failed_hosts(self) -> List[int]:
        return [h for h, t in self.last_seen.items()
                if self.now - t > self.timeout_s]

    def alive_hosts(self) -> List[int]:
        failed = set(self.failed_hosts())
        return [h for h in range(self.num_hosts) if h not in failed]


def plan_mesh(num_devices: int, model_size: int) -> Tuple[int, int]:
    """Largest (data, model) grid with the model axis kept intact."""
    if num_devices < model_size:
        raise ValueError(
            f"cannot keep model axis of {model_size} with {num_devices} devices")
    data = num_devices // model_size
    return data, model_size


def remesh(ranks: Sequence[int], model_size: int,
           device_type: Optional[str] = None):
    """Build the largest (data, model) mesh from the surviving ranks: the
    first data·model of them."""
    data, model = plan_mesh(len(ranks), model_size)
    used = list(ranks)[: data * model]
    return make_mesh_from_devices(used, (data, model), ("data", "model"),
                                  device_type=device_type)
