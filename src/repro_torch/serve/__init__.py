"""repro_torch.serve — bittide-paced continuous-batching serving simulator.

Port of ``repro.serve``.  The paper's closing argument (§1.4/§8) made
quantitative: a serving cluster whose workers are the nodes of a bittide
ensemble.  Four layers, each its own module:

* :mod:`repro_torch.serve.arrival` — seeded open-loop request arrival
  processes (Poisson base rate, diurnal modulation, flash bursts) with
  heavy-tailed prompt/output length draws (numpy; the reference's tables
  bit for bit);
* :mod:`repro_torch.serve.costmodel` — analytic prefill/decode tick
  prices from the ``ModelZoo`` FLOP accounting;
* :mod:`repro_torch.serve.pacing` — ONE ``run_scenario`` ensemble (draw 0
  controlled, draw 1 free-running, gains per draw) on the card, lowered
  to three pacing disciplines: logically-synchronous ``bittide``,
  per-step global ``barrier``, bounded-queue ``async``;
* :mod:`repro_torch.serve.engine` — the continuous-batching slot
  scheduler (admission queue, chunked prefill, one token per occupied
  slot per tick) whose wall clock is advanced by the chosen discipline,
  emitting p50/p99/p999 latency, goodput, and slot-occupancy telemetry
  through the shared ``RunTrace``/``Watermarks`` layer (host numpy).
"""
from .arrival import ArrivalConfig, RequestTable, generate_requests
from .costmodel import StepCostModel
from .engine import ServeConfig, ServeResult, TickTrace, serve
from .pacing import (DISCIPLINES, DisciplineConfig, PacedEnsemble,
                     PacingSchedule, pace_workers)

__all__ = [
    "ArrivalConfig", "RequestTable", "generate_requests",
    "StepCostModel",
    "ServeConfig", "ServeResult", "TickTrace", "serve",
    "DISCIPLINES", "DisciplineConfig", "PacedEnsemble", "PacingSchedule",
    "pace_workers",
]
