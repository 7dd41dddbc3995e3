"""Run observability (port of ``repro.telemetry``).

* :mod:`repro_torch.telemetry.api` — :class:`Telemetry`, what a run
  records (``beta``, ``watermarks``, ``trace``, ``guard``).
* :mod:`repro_torch.telemetry.watermarks` — :class:`Watermarks`, the
  O(N) excursion aggregates (numpy).
* :mod:`repro_torch.telemetry.trace` — :class:`RunTrace`, the host-side
  flight recorder of the scenario runner.
* :mod:`repro_torch.telemetry.compile_stats` — build and launch counts
  behind :class:`no_new_compiles`.
"""
from repro_torch.telemetry.api import Telemetry, resolve_telemetry
from repro_torch.telemetry.compile_stats import (compile_stats,
                                                 engine_cache_sizes,
                                                 launch_counts,
                                                 launches_since,
                                                 no_new_compiles)
from repro_torch.telemetry.trace import (NULL_TRACE, RunTrace, TraceEvent,
                                         coerce_trace)
from repro_torch.telemetry.watermarks import Watermarks

__all__ = ["Telemetry", "resolve_telemetry", "Watermarks", "RunTrace",
           "TraceEvent", "NULL_TRACE", "coerce_trace", "compile_stats",
           "engine_cache_sizes", "launch_counts", "launches_since",
           "no_new_compiles"]
