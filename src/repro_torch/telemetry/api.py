"""The typed telemetry request object: what a run should observe.

Port of ``repro.telemetry.api``.  ``beta`` and ``watermarks`` are served
by every dense lane; ``trace`` (the flight recorder) and ``guard`` (the
in-kernel reframing guard) by the scenario runner
(:func:`repro_torch.scenarios.run_scenario`).  Like the reference, this
module stays importable without the kernel stack, so ``trace`` and
``guard`` are duck-typed: ``trace`` is ``False`` / ``True`` / a
:class:`repro_torch.telemetry.RunTrace`, ``guard`` is ``False`` /
``True`` / a :class:`repro_torch.core.reframing.ReframePolicy`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

__all__ = ["Telemetry", "resolve_telemetry"]


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """What one engine run should record.

    Attributes:
      beta: record the (R, B, N) per-node net-occupancy stream.
      watermarks: carry the O(N) in-kernel excursion watermarks.
      trace: thread a flight recorder (``True`` builds one, or pass a
        :class:`~repro_torch.telemetry.RunTrace` to append to).
      guard: closed-loop buffer re-centering — ``True`` for the default
        :class:`~repro_torch.core.reframing.ReframePolicy`, or a policy
        instance.  On the kernel lanes the guard decision runs inside the
        kernel: the measure pass compares per-node β against the lowered
        guard band and freezes the chunk at the trip record.
    """

    beta: bool = False
    watermarks: bool = False
    trace: Any = False
    guard: Any = False

    def __post_init__(self):
        object.__setattr__(self, "beta", bool(self.beta))
        object.__setattr__(self, "watermarks", bool(self.watermarks))


_WARNED: set = set()


def resolve_telemetry(telemetry: Optional[Telemetry], caller: str, *,
                      beta=None, watermarks=None, trace=None,
                      guard=None) -> Telemetry:
    """Merge boolean kwargs into a :class:`Telemetry`.

    Each kwarg is ``None`` when the caller did not pass it; a value wins
    over the corresponding ``telemetry`` field and emits a once-per-process
    :class:`DeprecationWarning` naming the typed spelling, as the
    reference's one-release shims do.
    """
    base = telemetry if telemetry is not None else Telemetry()
    if not isinstance(base, Telemetry):
        raise TypeError(
            f"{caller}: telemetry= must be a repro_torch.telemetry."
            f"Telemetry, got {type(telemetry).__name__}")
    updates = {}
    for field, val, old in (("beta", beta, "record_beta"),
                            ("watermarks", watermarks, "record_watermarks"),
                            ("trace", trace, "trace"),
                            ("guard", guard, "auto_reframe")):
        if val is None:
            continue
        if old not in _WARNED:
            _WARNED.add(old)
            warnings.warn(f"{old}= is deprecated; use "
                          f"telemetry=Telemetry({field}=...)",
                          DeprecationWarning, stacklevel=3)
        updates[field] = val
    return dataclasses.replace(base, **updates) if updates else base
