"""The typed engine call surface: options in, named outputs out.

Port of ``repro.kernels.api``, same fields in the same order.  The
reference's one-release legacy kwargs (``engine=``, ``interpret=``,
``chunk_records=``) are merged into an :class:`EngineOptions` by
:func:`resolve_options`; ``interpret=`` warns once per process (see
:mod:`repro_torch._compat`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

from repro_torch._compat import deprecated_kwarg

__all__ = ["EngineOptions", "EngineOutputs", "resolve_options"]


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


def resolve_options(options: Optional[EngineOptions], caller: str, *,
                    engine=None, interpret=None, chunk_records=None,
                    default_engine: str = "auto") -> EngineOptions:
    """Merge legacy kwargs into an :class:`EngineOptions`.

    Legacy values are ``None`` when not passed; a passed value wins over
    the ``options`` field.  ``interpret=`` (a boolean knob) emits the
    once-per-process deprecation warning; ``engine=`` / ``chunk_records=``
    are mapped silently (they name real knobs).  The merged options are
    returned as they are: a truthy ``interpret`` raises at the entry point
    that reads it, since the port has no interpreter.
    """
    base = options if options is not None else EngineOptions(
        engine=default_engine)
    if not isinstance(base, EngineOptions):
        raise TypeError(
            f"{caller}: options= must be a repro_torch.kernels."
            f"EngineOptions, got {type(options).__name__}")
    updates = {}
    if engine is not None:
        updates["engine"] = engine
    if interpret is not None:
        deprecated_kwarg("interpret=", "options=EngineOptions(interpret=...)")
        updates["interpret"] = interpret
    if chunk_records is not None:
        updates["chunk_records"] = chunk_records
    return dataclasses.replace(base, **updates) if updates else base
