"""One-release deprecation machinery for the typed options/telemetry API.

Port of ``repro._compat``.  The old boolean engine kwargs
(``record_beta``, ``record_watermarks``, ``trace``, ``auto_reframe``,
``interpret``) keep working beside the frozen
:class:`repro_torch.kernels.EngineOptions` /
:class:`repro_torch.telemetry.Telemetry` objects; each emits exactly ONE
:class:`DeprecationWarning` per process (keyed on the kwarg name) and is
mapped onto the new object.

This module has no dependencies so both ``repro_torch.kernels`` and
``repro_torch.telemetry`` can import it without cycles.
"""
from __future__ import annotations

import warnings

_WARNED: set = set()


def deprecated_kwarg(old: str, new: str, *, stacklevel: int = 4) -> None:
    """Warn ONCE per process that ``old`` should become ``new``."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"{old} is deprecated and will be removed after one release; "
        f"use {new}", DeprecationWarning, stacklevel=stacklevel)


def reset_deprecation_warnings() -> None:
    """Re-arm the warn-once registry (test helper)."""
    _WARNED.clear()
