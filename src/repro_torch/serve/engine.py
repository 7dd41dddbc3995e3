"""Continuous-batching serving engine over a paced worker ensemble.

Port of ``repro.serve.engine``: the host discrete-event loop in numpy,
its telemetry through the port's :class:`repro_torch.telemetry.Watermarks`
and flight recorder.  The scheduler is the offline-serving loop of
maxtext/JetStream ``offline_inference.py`` reduced to its decision
structure: an admission
queue, S decode slots, chunked prefill piggybacked on decode ticks
(Orca/vLLM-style continuous batching), one generated token per occupied
slot per tick.  What is *simulated* rather than executed is the clock:
each tick's wall-clock duration is its analytic cost
(``StepCostModel``) divided by the pacing discipline's global step rate
at that instant (``PacingSchedule``) — which is where the bittide
ensemble's ν trajectories, and every mid-serve fault event, enter the
serving numbers.

Invariants the property suite (``tests/test_torch_serve.py``, the
reference's ``tests/test_serve_properties.py`` on the port) pins:

* request conservation — every admitted request is exactly one of
  completed / in-flight / queued at every tick;
* no decode-slot double-booking — a live request occupies exactly one
  slot, a slot at most one request;
* per-request token monotonicity — generated counts never decrease and
  never exceed the request's output budget;
* goodput ≤ offered load;
* same seed ⇒ bit-identical trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.telemetry import Watermarks, coerce_trace

from .arrival import RequestTable
from .costmodel import StepCostModel
from .pacing import PacingSchedule

__all__ = ["ServeConfig", "TickTrace", "ServeResult", "serve"]

FREE = -1  # empty-slot sentinel in the slot→request table


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler shape and accounting knobs.

    decode_slots: continuous-batching slot count S (the static batch
      dimension of the decode kernel).
    prefill_chunk: prompt tokens processed per tick across prefilling
      slots (chunked prefill budget).
    slo_s: per-request completion SLO; goodput counts only requests that
      finish within it.
    max_time_factor: safety horizon — the engine stops at
      ``max_time_factor × duration_s`` even if requests are pending
      (overload runs would otherwise never drain); unfinished requests
      keep latency = inf.
    record_ticks: keep the per-tick :class:`TickTrace` arrays (the
      property tests' witness; off for big runs).
    """

    decode_slots: int = 8
    prefill_chunk: int = 64
    slo_s: float = 30.0
    max_time_factor: float = 4.0
    record_ticks: bool = False

    def __post_init__(self):
        if self.decode_slots < 1 or self.prefill_chunk < 1:
            raise ValueError("decode_slots and prefill_chunk must be >= 1")
        if self.max_time_factor <= 1.0:
            raise ValueError("max_time_factor must exceed 1")


@dataclasses.dataclass
class TickTrace:
    """Per-tick witness arrays (row t = state at the END of tick t).

    slot_req: (T, S) request id per slot, FREE for empty.
    gen_tokens: (T, R) generated-token count per request.
    queued / in_flight / completed / admitted: (T,) counts.
    t_end: (T,) wall-clock time at the end of each tick.
    """

    slot_req: np.ndarray
    gen_tokens: np.ndarray
    queued: np.ndarray
    in_flight: np.ndarray
    completed: np.ndarray
    admitted: np.ndarray
    t_end: np.ndarray


@dataclasses.dataclass
class ServeResult:
    """Outcome of one serve run under one pacing discipline."""

    discipline: str
    num_requests: int
    completion_s: np.ndarray    # (R,) completion wall-clock, inf if unfinished
    first_token_s: np.ndarray   # (R,) TTFT wall-clock, inf if never decoded
    arrival_s: np.ndarray       # (R,)
    prompt_tokens: np.ndarray   # (R,)
    output_tokens: np.ndarray   # (R,) requested budget
    generated_tokens: np.ndarray  # (R,) actually generated
    elapsed_s: float            # wall-clock at engine stop
    num_ticks: int
    stall_s: float              # async flow-control time charged
    slot_occupancy_mean: float  # time-weighted occupied-slot fraction
    queue_peak: int             # admission-queue length watermark
    slo_s: float
    horizon_s: float            # arrival horizon (offered-load denominator)
    offered_tps: float          # (prompt+output tokens) / arrival horizon
    watermarks: Optional[Watermarks] = None
    ticks: Optional[TickTrace] = None
    trace: object = None

    @property
    def latency_s(self) -> np.ndarray:
        return self.completion_s - self.arrival_s

    @property
    def completed(self) -> int:
        return int(np.isfinite(self.completion_s).sum())

    def latency_percentile(self, q: float) -> float:
        """Latency percentile over ALL requests (unfinished count as inf)."""
        lat = np.sort(self.latency_s)
        idx = min(int(np.ceil(q / 100.0 * len(lat))) - 1, len(lat) - 1)
        return float(lat[max(idx, 0)])

    @property
    def p50_s(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_s(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def p999_s(self) -> float:
        return self.latency_percentile(99.9)

    @property
    def goodput_tps(self) -> float:
        """Tokens/s of requests that completed within the SLO.

        Counts prompt + generated tokens (the offered-load units) over
        ``max(elapsed, horizon)``: the numerator is a subset of the
        offered tokens and the denominator at least the offered-load
        horizon, so goodput ≤ offered load holds structurally — the
        conservation property, not a numerical accident.
        """
        ok = self.latency_s <= self.slo_s
        useful = (self.prompt_tokens[ok] + self.generated_tokens[ok]).sum()
        return float(useful) / max(self.elapsed_s, self.horizon_s, 1e-12)

    def fingerprint(self) -> bytes:
        """Byte-exact digest (the seeded-reproducibility property)."""
        return (self.completion_s.tobytes() + self.first_token_s.tobytes()
                + self.generated_tokens.tobytes()
                + np.float64(self.elapsed_s).tobytes())

    def summary(self) -> str:
        return (f"[{self.discipline:>8}] {self.completed}/{self.num_requests}"
                f" done, p50={self.p50_s:.2f}s p99={self.p99_s:.2f}s "
                f"p999={self.p999_s:.2f}s goodput={self.goodput_tps:.1f} "
                f"tok/s (offered {self.offered_tps:.1f}) "
                f"occ={self.slot_occupancy_mean:.2f} "
                f"queue_peak={self.queue_peak} stalls={self.stall_s:.2f}s")


def serve(requests: RequestTable, schedule: PacingSchedule,
          cost: StepCostModel, cfg: ServeConfig = ServeConfig(),
          trace=False) -> ServeResult:
    """Run the continuous-batching loop under one pacing discipline.

    Pure host-side discrete-event simulation — deterministic in its
    inputs (no RNG anywhere in the loop): the arrival table is already
    drawn, the pacing timeline already computed, so same inputs ⇒
    bit-identical result.
    """
    r_n = requests.num_requests
    arr = requests.arrival_s
    prompt = requests.prompt_tokens
    budget = requests.output_tokens
    s_n = cfg.decode_slots
    horizon = max(requests.horizon_s,
                  float(arr[-1]) if r_n else 0.0)
    t_stop = max(float(schedule.times[-1]),
                 horizon) * cfg.max_time_factor

    tr = coerce_trace(trace, name=f"serve-{schedule.discipline}")
    tr.event("serve_start", discipline=schedule.discipline,
             requests=r_n, decode_slots=s_n,
             offered_tps=requests.offered_load_tps)

    completion = np.full(r_n, np.inf)
    first_tok = np.full(r_n, np.inf)
    generated = np.zeros(r_n, np.int64)
    prefill_left = prompt.copy()

    slots = np.full(s_n, FREE, np.int64)
    queue: List[int] = []
    next_arrival = 0
    t = 0.0
    tick = 0
    rec_cursor = 0          # last pacing record whose stalls were charged
    stall_total = 0.0
    occ_time = 0.0          # ∫ occupied_fraction dt
    queue_peak = 0
    tt_rows = [] if cfg.record_ticks else None
    occ_rec, rate_rec = [], []

    while True:
        # 1. arrivals up to the current wall clock join the queue.
        while next_arrival < r_n and arr[next_arrival] <= t:
            queue.append(next_arrival)
            next_arrival += 1
        # Idle fast-forward: nothing resident and nothing queued.
        if not queue and not np.any(slots != FREE):
            if next_arrival >= r_n:
                break
            t = max(t, float(arr[next_arrival]))
            continue
        if t >= t_stop:
            break

        # 2. admission: FIFO queue into free slots.
        for s in range(s_n):
            if slots[s] == FREE and queue:
                slots[s] = queue.pop(0)
        queue_peak = max(queue_peak, len(queue))

        # 3. chunked prefill: budget shared across prefilling slots in
        # slot order (deterministic).
        chunk = cfg.prefill_chunk
        prefill_done_tokens = 0
        for s in range(s_n):
            rid = slots[s]
            if rid == FREE or prefill_left[rid] == 0 or chunk == 0:
                continue
            take = int(min(prefill_left[rid], chunk))
            prefill_left[rid] -= take
            chunk -= take
            prefill_done_tokens += take

        # 4. decode: one token per slot whose prefill has finished.
        decoding = [int(rid) for rid in slots
                    if rid != FREE and prefill_left[rid] == 0]
        occupied = int(np.sum(slots != FREE))

        # 5. price the tick and advance the paced wall clock.
        work_s = cost.tick_seconds(occupied, prefill_done_tokens, s_n)
        rec = schedule.record_at(t)
        rate = float(schedule.rate[rec])
        dt_tick = work_s / rate + schedule.step_overhead_s
        if rec > rec_cursor:
            newly = float(schedule.stall_cum_s[rec]
                          - schedule.stall_cum_s[rec_cursor])
            dt_tick += newly
            stall_total += newly
            rec_cursor = rec
        t += dt_tick
        occ_time += (occupied / s_n) * dt_tick
        occ_rec.append(occupied / s_n)
        rate_rec.append(rate)

        # 6. token landing + completions at the END of the tick.
        for rid in decoding:
            generated[rid] += 1
            if generated[rid] == 1:
                first_tok[rid] = t
            if generated[rid] >= budget[rid]:
                completion[rid] = t
                slots[slots == rid] = FREE
        tick += 1

        if tt_rows is not None:
            tt_rows.append((slots.copy(), generated.copy(), len(queue),
                            int(np.sum(slots != FREE)),
                            int(np.isfinite(completion).sum()),
                            next_arrival, t))

    elapsed = max(t, horizon, 1e-12)
    ticks = None
    if tt_rows is not None and tt_rows:
        ticks = TickTrace(
            slot_req=np.stack([row[0] for row in tt_rows]),
            gen_tokens=np.stack([row[1] for row in tt_rows]),
            queued=np.array([row[2] for row in tt_rows], np.int64),
            in_flight=np.array([row[3] for row in tt_rows], np.int64),
            completed=np.array([row[4] for row in tt_rows], np.int64),
            admitted=np.array([row[5] for row in tt_rows], np.int64),
            t_end=np.array([row[6] for row in tt_rows]))

    # Slot-occupancy / achieved-rate excursions through the shared
    # telemetry container: β ↦ occupied-slot fraction, ν ↦ step-rate
    # deviation from nominal in ppm.
    wm = None
    if occ_rec:
        occ_arr = np.asarray(occ_rec)[:, None]
        rate_arr = (np.asarray(rate_rec)[:, None] - 1.0) * 1e6
        wm = Watermarks.from_record(occ_arr, rate_arr)

    res = ServeResult(
        discipline=schedule.discipline, num_requests=r_n,
        completion_s=completion, first_token_s=first_tok,
        arrival_s=arr.copy(), prompt_tokens=prompt.copy(),
        output_tokens=budget.copy(), generated_tokens=generated,
        elapsed_s=float(elapsed), num_ticks=tick,
        stall_s=float(stall_total),
        slot_occupancy_mean=float(occ_time / max(t, 1e-12)) if tick else 0.0,
        queue_peak=queue_peak, slo_s=cfg.slo_s,
        horizon_s=horizon, offered_tps=requests.offered_load_tps,
        watermarks=wm, ticks=ticks, trace=(tr if tr else None))
    tr.event("serve_done", discipline=schedule.discipline,
             completed=res.completed, ticks=tick,
             p99_s=round(res.p99_s, 4) if np.isfinite(res.p99_s) else "inf",
             goodput_tps=round(res.goodput_tps, 3),
             stall_s=round(stall_total, 4))
    return res
