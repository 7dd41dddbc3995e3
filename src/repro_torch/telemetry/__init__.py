"""Run observability (port of ``repro.telemetry``).

* :mod:`repro_torch.telemetry.api` — :class:`Telemetry`, what a run
  records (``beta``, ``watermarks``; ``trace`` / ``guard`` raise until the
  scenario runner is ported).
* :mod:`repro_torch.telemetry.watermarks` — :class:`Watermarks`, the
  O(N) excursion aggregates (numpy).
* :mod:`repro_torch.telemetry.compile_stats` — build and launch counts
  behind :class:`no_new_compiles`.
"""
from repro_torch.telemetry.api import Telemetry
from repro_torch.telemetry.compile_stats import (compile_stats,
                                                 launch_counts,
                                                 no_new_compiles)
from repro_torch.telemetry.watermarks import Watermarks

__all__ = ["Telemetry", "Watermarks", "compile_stats", "launch_counts",
           "no_new_compiles"]
