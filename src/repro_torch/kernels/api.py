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
      engine: lane name — "auto" dispatches by shape; "fused" is the lane
        this port has.  "tiled", "sparse" and "per-step" raise
        ``NotImplementedError`` until their kernels are ported.
      interpret: the reference's switch for the Pallas interpreter.  The
        port has no interpreter: a truthy value raises (pass
        ``device="cpu"`` to run the plain PyTorch versions instead).
      chunk_records: records per kernel launch in the scenario runner,
        which this port does not have yet; a value raises here.
    """

    engine: str = "auto"
    interpret: Optional[bool] = None
    chunk_records: Optional[int] = None


class EngineOutputs(NamedTuple):
    """Named engine-lane outputs.

    ``freq`` is the decimated ν record stream; ``psi`` / ``nu`` the final
    carried state; ``beta`` / ``watermarks`` are ``None`` unless
    requested; ``guard_state`` stays ``None`` until the in-kernel guard is
    ported with the scenario layer.
    """

    psi: Any
    nu: Any
    freq: Any
    beta: Optional[Any] = None
    watermarks: Optional[tuple] = None
    guard_state: Optional[Any] = None
