"""repro_torch.scenarios — dynamic-event scenarios on the port's engines.

Port of ``repro.scenarios``.  A :class:`Scenario` is a declarative list of
timed physical events — cable swaps (:class:`LatencyStep`), oscillator
steps and thermal ramps (:class:`FreqStep` / :class:`DriftRamp`), clock
holdover and rejoin (:class:`NodeHoldover` / :class:`NodeReset`), link
outages (:class:`LinkDrop` / :class:`LinkRestore`), pointer rotations
(:class:`Reframe`).  ``compile_scenario`` lowers the events into
record-aligned piecewise-constant parameter segments, and
``run_scenario`` chains the segment-sum lane, a dense kernel lane
(fused / tiled) or the sparse ELL lane across the segments, threading
ψ/ν/controller state and the per-edge λeff constants.
:class:`ChaosCampaign` samples per-draw randomized faults into one
batched scenario, runs it, triages every draw against its closed-form
occupancy envelope and the buffer wall, and shrinks a failing draw to a
standalone repro.
"""
from .events import (DriftRamp, FreqStep, LatencyStep, LinkDrop, LinkRestore,
                     Mark, NodeHoldover, NodeReset, Reframe, Scenario,
                     edges_between)
from .compiler import CompiledScenario, Segment, compile_scenario
from .runner import AppliedReframe, ScenarioResult, run_scenario
from .chaos import (VERDICT_ENVELOPE, VERDICT_OVERFLOW, VERDICT_PASS,
                    VERDICT_RESCUED, CampaignResult, ChaosCampaign,
                    DriftRampSampler, FreqStepSampler, HoldoverSampler,
                    LatencyStepSampler, LinkDropSampler, ShrunkRepro,
                    triage_result)

__all__ = [
    "Mark", "LatencyStep", "FreqStep", "DriftRamp", "NodeHoldover",
    "NodeReset", "LinkDrop", "LinkRestore", "Reframe", "Scenario",
    "edges_between",
    "CompiledScenario", "Segment", "compile_scenario",
    "AppliedReframe", "ScenarioResult", "run_scenario",
    "VERDICT_PASS", "VERDICT_ENVELOPE", "VERDICT_OVERFLOW", "VERDICT_RESCUED",
    "FreqStepSampler", "DriftRampSampler", "LatencyStepSampler",
    "HoldoverSampler", "LinkDropSampler",
    "ChaosCampaign", "CampaignResult", "ShrunkRepro", "triage_result",
]
