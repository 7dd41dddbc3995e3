"""The typed telemetry request object: what a run should observe.

Port of ``repro.telemetry.api``.  ``beta`` and ``watermarks`` are served
by the fused lane.  ``trace`` (the flight recorder) and ``guard`` (the
in-kernel reframing guard) belong to the scenario runner, which is not
ported yet (ROADMAP queue item 4): asking for either raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Telemetry"]


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """What one engine run should record.

    Attributes:
      beta: record the (R, B, N) per-node net-occupancy stream.
      watermarks: carry the O(N) in-kernel excursion watermarks.
      trace: flight recorder — not ported yet; truthy raises.
      guard: closed-loop buffer re-centering — not ported yet; truthy
        raises.
    """

    beta: bool = False
    watermarks: bool = False
    trace: Any = False
    guard: Any = False

    def __post_init__(self):
        object.__setattr__(self, "beta", bool(self.beta))
        object.__setattr__(self, "watermarks", bool(self.watermarks))
        for name in ("trace", "guard"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"Telemetry.{name} needs the scenario runner, which "
                    "repro_torch does not have yet (ROADMAP queue item 4)")
