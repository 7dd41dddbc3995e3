"""The typed engine call surface: options in, named outputs out.

Port of ``repro.kernels.api``, same fields in the same order.  Only the
typed ``options=`` API is ported; the reference's one-release legacy
kwargs are not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

__all__ = ["EngineOptions", "EngineOutputs"]


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """How to run an engine (everything that is not *what to observe*).

    Attributes:
      engine: lane name — "auto" dispatches by shape (the H100 regime
        table); "fused" and "tiled" are the dense lanes, "sparse" the ELL
        lane for bounded-degree networks (and per-draw edge weights),
        "per-step" the one-draw-per-launch lane, and ``run_scenario`` also
        takes "segment-sum" (its default).
      interpret: the reference's switch for the Pallas interpreter.  The
        port has no interpreter: a truthy value raises (pass
        ``device="cpu"`` to run the plain PyTorch versions instead).
      chunk_records: records per engine call in the scenario runner
        (``run_scenario``); the single-call runners raise on it.
    """

    engine: str = "auto"
    interpret: Optional[bool] = None
    chunk_records: Optional[int] = None


class EngineOutputs(NamedTuple):
    """Named engine-lane outputs.

    ``freq`` is the decimated ν record stream; ``psi`` / ``nu`` the final
    carried state; ``beta`` / ``watermarks`` are ``None`` unless
    requested; ``guard_state`` is the (B, 1) int32 first-trip record of the
    in-kernel reframing guard (``num_records`` where a draw never tripped)
    or ``None`` without the guard.
    """

    psi: Any
    nu: Any
    freq: Any
    beta: Optional[Any] = None
    watermarks: Optional[tuple] = None
    guard_state: Optional[Any] = None
