"""repro_torch.scenarios — dynamic-event scenarios on the port's engines.

Port of ``repro.scenarios`` (the chaos campaigns are not ported yet:
ROADMAP queue item 6).  A :class:`Scenario` is a declarative list of
timed physical events — cable swaps (:class:`LatencyStep`), oscillator
steps and thermal ramps (:class:`FreqStep` / :class:`DriftRamp`), clock
holdover and rejoin (:class:`NodeHoldover` / :class:`NodeReset`), link
outages (:class:`LinkDrop` / :class:`LinkRestore`), pointer rotations
(:class:`Reframe`).  ``compile_scenario`` lowers the events into
record-aligned piecewise-constant parameter segments, and
``run_scenario`` chains the segment-sum lane or a dense kernel lane
(fused / tiled) across the segments, threading ψ/ν/controller state and
the per-edge λeff constants.
"""
from .events import (DriftRamp, FreqStep, LatencyStep, LinkDrop, LinkRestore,
                     Mark, NodeHoldover, NodeReset, Reframe, Scenario,
                     edges_between)
from .compiler import CompiledScenario, Segment, compile_scenario
from .runner import AppliedReframe, ScenarioResult, run_scenario

__all__ = [
    "Mark", "LatencyStep", "FreqStep", "DriftRamp", "NodeHoldover",
    "NodeReset", "LinkDrop", "LinkRestore", "Reframe", "Scenario",
    "edges_between",
    "CompiledScenario", "Segment", "compile_scenario",
    "AppliedReframe", "ScenarioResult", "run_scenario",
]
