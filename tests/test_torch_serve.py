"""repro_torch.serve against repro.serve, and the serving properties.

The same numpy inputs go through the reference and the port
(``device="cpu"``: the segment-sum loop and the fused kernel's plain
version; the reference's Pallas lane runs in interpret mode on the CPU,
as its own tests run it).

* Request tables: ``generate_requests`` draws the reference's table bit
  for bit (``RequestTable.fingerprint()``), under hypothesis over seeds
  and configs.
* Cost model: ``StepCostModel.from_zoo`` prices equal the reference's
  (``==``) for every architecture at several slot counts.
* Scheduler: ``serve`` on one shared ``PacingSchedule``, built from the
  reference's arrays, gives the reference's fingerprint and every field
  (the loop is host numpy in both packages), for each discipline.
* Pacing: ``pace_workers`` against the reference's on segment-sum
  (ν and the per-edge β) and on the fused lane (ν and the per-node β),
  each lane against the same lane: the ``async`` discipline reads β,
  which is per edge on one and per node on the other, in both packages.
  Segment counts, launches and engines are equal.  The worker offsets
  reach ±50,000 ppm, and the straggler step adds −60,000, so a bar in
  absolute ppm (``FREQ_ATOL_PPM`` = 1e-6) cannot hold in float32: ν is
  held to √steps float32 ulps of the reference's largest |ν| (one ulp per
  step at most, adding up like a random walk: 0.115 ppm at 240 steps and
  87,479 ppm), β to ``BETA_ATOL_CROSS_FRAMES`` or √steps ulps of the
  reference's largest |β|, whichever is larger.  The disciplines' rates
  follow ν (the same bar, relative), their stall timelines are equal.
* Properties: every test of ``tests/test_serve_properties.py`` on the
  port — request conservation, no slot double booking, token
  monotonicity, goodput ≤ offered, seeded reproducibility, one built
  engine across every event segment (``no_new_compiles`` on a warm
  re-pace, on segment-sum and on the fused lane), discipline shapes,
  bittide ≥ barrier under a straggler, watermarks and trace.
"""
import dataclasses

import numpy as np
import pytest
from hypcompat import given, settings, st

pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.scenarios as rs  # noqa: E402
import repro.serve as ref_serve  # noqa: E402
from engine_harness import BETA_ATOL_CROSS_FRAMES  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.scenarios import (DriftRamp, FreqStep, LinkDrop,  # noqa: E402
                                   LinkRestore, NodeHoldover, NodeReset,
                                   Scenario)
from repro_torch.serve import (DISCIPLINES, ArrivalConfig,  # noqa: E402
                               DisciplineConfig, PacingSchedule, ServeConfig,
                               StepCostModel, generate_requests,
                               pace_workers, serve)
from repro_torch.serve.engine import FREE  # noqa: E402
from repro_torch.telemetry import no_new_compiles  # noqa: E402

WORKERS = 8
SPEED_PPM = np.random.default_rng(7).uniform(-50_000, 50_000, WORKERS)
LANES = ["segment-sum", "fused"]
PACE = dict(kp=5e-3, steps_per_second=10.0, duration_s=24.0, record_every=5)
STEPS = 240

# tests/test_serve_properties.py's mid-serve fault sequence: a straggler
# onset, a thermal drift, a holdover and rejoin, a link outage and
# restore.
REF_EVENTS = rs.Scenario(events=(
    rs.FreqStep(t=6.0, nodes=(3,), delta_ppm=-60_000.0),
    rs.DriftRamp(t=10.0, t_end=16.0, nodes=(5,), rate_ppm_per_s=2_000.0),
    rs.NodeHoldover(t=12.0, nodes=(1,)),
    rs.NodeReset(t=18.0, nodes=(1,)),
    rs.LinkDrop(t=14.0, edges=(0,)),
    rs.LinkRestore(t=20.0, edges=(0,)),
), name="serve-faults")
EVENTS = convert.scenario(REF_EVENTS)

# One paced ensemble per lane and package, shared by the tests: the
# scheduler under test is host-side and fast; pay for each pacing once.
_PACED = {}


def paced(engine="segment-sum"):
    if engine not in _PACED:
        _PACED[engine] = pace_workers(tc.ring(WORKERS), SPEED_PPM, EVENTS,
                                      engine=engine, device="cpu", **PACE)
    return _PACED[engine]


def ref_paced(engine="segment-sum"):
    key = ("ref", engine)
    if key not in _PACED:
        _PACED[key] = ref_serve.pace_workers(rc.ring(WORKERS), SPEED_PPM,
                                             REF_EVENTS, engine=engine,
                                             **PACE)
    return _PACED[key]


def cost_model():
    return StepCostModel.from_zoo("smollm-135m", decode_slots=8,
                                  hw_flops=1e12)


def _arrivals(seed, rate):
    return dict(rate_rps=rate, duration_s=10.0, diurnal_amp=0.4,
                burst_rate_mult=3.0, burst_duration_s=1.0, num_bursts=1,
                prompt_mean=32.0, prompt_max=128, output_mean=16.0,
                output_max=64, seed=seed)


def run_one(seed, rate, slots, chunk, discipline="bittide",
            record_ticks=True):
    reqs = generate_requests(ArrivalConfig(**_arrivals(seed, rate)))
    cfg = ServeConfig(decode_slots=slots, prefill_chunk=chunk,
                      slo_s=20.0, record_ticks=record_ticks)
    sched = paced().schedule(discipline, DisciplineConfig(queue_depth=16))
    return reqs, serve(reqs, sched, cost_model(), cfg)


# ---------------------------------------------------------- the reference

@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(0.5, 40.0),
       duration=st.floats(1.0, 120.0), diurnal=st.floats(0.0, 1.0),
       bursts=st.integers(0, 4), mult=st.floats(1.0, 5.0),
       prompt_mean=st.floats(1.0, 200.0), output_mean=st.floats(1.0, 100.0))
def test_request_table_equals_reference(seed, rate, duration, diurnal,
                                        bursts, mult, prompt_mean,
                                        output_mean):
    kw = dict(rate_rps=rate, duration_s=duration, diurnal_amp=diurnal,
              diurnal_period_s=duration / 2, burst_rate_mult=mult,
              burst_duration_s=duration / 20, num_bursts=bursts,
              prompt_mean=prompt_mean, prompt_max=256,
              output_mean=output_mean, output_max=128, seed=seed)
    port = generate_requests(ArrivalConfig(**kw))
    ref = ref_serve.generate_requests(ref_serve.ArrivalConfig(**kw))
    assert port.fingerprint() == ref.fingerprint()
    assert port.horizon_s == ref.horizon_s
    assert port.offered_load_tps == ref.offered_load_tps


@pytest.mark.parametrize("slots", [1, 8, 64])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cost_model_equals_reference(name, slots):
    kw = dict(decode_slots=slots, hw_flops=1e12, mfu_decode=0.1,
              mfu_prefill=0.5)
    for port, ref in ((StepCostModel.from_zoo(name, **kw),
                       ref_serve.StepCostModel.from_zoo(name, **kw)),
                      (StepCostModel.from_zoo(get_config(name),
                                              decode_slots=slots),
                       ref_serve.StepCostModel.from_zoo(
                           name, decode_slots=slots))):
        assert dataclasses.astuple(port) == dataclasses.astuple(ref)
        for occ, pre in ((0, 0), (0, 17), (3, 0), (slots, 64)):
            assert port.tick_seconds(occ, pre, slots) == \
                ref.tick_seconds(occ, pre, slots)


def _ref_schedules():
    """Each discipline's reference schedule and the port's copy of its
    arrays."""
    out = {}
    for d in DISCIPLINES:
        ref = ref_paced().schedule(d, ref_serve.DisciplineConfig(
            queue_depth=16))
        out[d] = (ref, PacingSchedule(ref.discipline, ref.times.copy(),
                                      ref.rate.copy(), ref.step_overhead_s,
                                      ref.stall_cum_s.copy()))
    return out


@pytest.mark.parametrize("seed,rate", [(0, 4.0), (3, 12.0), (11, 1.5)])
def test_serve_on_a_shared_schedule_equals_reference(seed, rate):
    """The same table and schedule: the reference's fingerprint and every
    field, the per-tick witness and the watermarks, bit for bit."""
    kw = _arrivals(seed, rate)
    reqs = generate_requests(ArrivalConfig(**kw))
    ref_reqs = ref_serve.generate_requests(ref_serve.ArrivalConfig(**kw))
    cfg = dict(decode_slots=4, prefill_chunk=32, slo_s=8.0,
               record_ticks=True)
    for d, (ref_sched, sched) in _ref_schedules().items():
        port = serve(reqs, sched, cost_model(), ServeConfig(**cfg))
        ref = ref_serve.serve(
            ref_reqs, ref_sched, ref_serve.StepCostModel.from_zoo(
                "smollm-135m", decode_slots=8, hw_flops=1e12),
            ref_serve.ServeConfig(**cfg))
        assert port.fingerprint() == ref.fingerprint(), d
        for f in ("discipline", "num_requests", "elapsed_s", "num_ticks",
                  "stall_s", "slot_occupancy_mean", "queue_peak", "slo_s",
                  "horizon_s", "offered_tps"):
            assert getattr(port, f) == getattr(ref, f), (d, f)
        for f in ("completion_s", "first_token_s", "arrival_s",
                  "prompt_tokens", "output_tokens", "generated_tokens"):
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        for f in ("slot_req", "gen_tokens", "queued", "in_flight",
                  "completed", "admitted", "t_end"):
            np.testing.assert_array_equal(getattr(port.ticks, f),
                                          getattr(ref.ticks, f))
        for f in ("beta_abs_max", "peak_record", "nu_min_ppm", "nu_max_ppm",
                  "num_records"):
            np.testing.assert_array_equal(getattr(port.watermarks, f),
                                          getattr(ref.watermarks, f))
        assert (port.p50_s, port.p99_s, port.p999_s, port.goodput_tps) == \
            (ref.p50_s, ref.p99_s, ref.p999_s, ref.goodput_tps)


def _nu_bar_ppm(ref_freq) -> float:
    return np.sqrt(STEPS) * float(np.spacing(np.float32(
        np.abs(ref_freq).max() * 1e-6))) * 1e6


@pytest.mark.parametrize("engine", LANES)
def test_pace_workers_matches_reference(engine):
    port, ref = paced(engine).result, ref_paced(engine).result
    assert port.engine == ref.engine == engine
    assert port.freq_ppm.shape == ref.freq_ppm.shape == (2, 48, WORKERS)
    assert port.beta.shape == ref.beta.shape
    assert port.beta.shape[2] == (2 * WORKERS if engine == "segment-sum"
                                  else WORKERS)
    assert port.num_launches == ref.num_launches
    assert len(port.compiled.segments) == len(ref.compiled.segments)
    np.testing.assert_array_equal(port.times, ref.times)
    np.testing.assert_array_equal(port.segment_records, ref.segment_records)
    nu_bar = _nu_bar_ppm(ref.freq_ppm)
    np.testing.assert_allclose(port.freq_ppm, ref.freq_ppm, rtol=0,
                               atol=nu_bar)
    beta_bar = max(BETA_ATOL_CROSS_FRAMES, np.sqrt(STEPS) * float(
        np.spacing(np.float32(np.abs(ref.beta).max()))))
    np.testing.assert_allclose(port.beta, ref.beta, rtol=0, atol=beta_bar)
    for d in DISCIPLINES:
        p = paced(engine).schedule(d, DisciplineConfig(queue_depth=16))
        r = ref_paced(engine).schedule(d, ref_serve.DisciplineConfig(
            queue_depth=16))
        assert p.discipline == r.discipline
        assert p.step_overhead_s == r.step_overhead_s
        np.testing.assert_array_equal(p.times, r.times)
        np.testing.assert_allclose(p.rate, r.rate, rtol=0,
                                   atol=nu_bar * 1e-6)
        np.testing.assert_array_equal(p.stall_cum_s, r.stall_cum_s)


def test_auto_lane_is_fused_for_the_pacing_ensemble():
    """ring(8), B = 2, a proportional controller with shared latencies,
    shared LinkDrop edges and a holdover: "auto" picks the fused lane,
    and gives its bits."""
    auto = pace_workers(tc.ring(WORKERS), SPEED_PPM, EVENTS, engine="auto",
                        device="cpu", **PACE).result
    assert auto.engine == "fused"
    np.testing.assert_array_equal(auto.freq_ppm,
                                  paced("fused").result.freq_ppm)


def test_pace_workers_rejects_a_wrong_speed_vector():
    with pytest.raises(ValueError, match="speed_ppm"):
        pace_workers(tc.ring(WORKERS), SPEED_PPM[:3], EVENTS, device="cpu")


# ----------------------------------- tests/test_serve_properties.py, ported

@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000), rate=st.floats(0.5, 6.0),
       slots=st.integers(1, 8), chunk=st.integers(1, 96))
def test_property_request_conservation(seed, rate, slots, chunk):
    """admitted == queued + in-flight + completed at every tick."""
    _, res = run_one(seed, rate, slots, chunk)
    tt = res.ticks
    assert tt is not None and len(tt.t_end)
    np.testing.assert_array_equal(
        tt.admitted, tt.queued + tt.in_flight + tt.completed)
    assert res.completed == res.num_requests == tt.admitted[-1]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000), slots=st.integers(2, 8),
       chunk=st.integers(8, 96))
def test_property_no_slot_double_booking(seed, slots, chunk):
    """A live request holds exactly one slot; a slot one request."""
    _, res = run_one(seed, 4.0, slots, chunk)
    for row in res.ticks.slot_req:
        live = row[row != FREE]
        assert len(live) == len(np.unique(live))


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000), slots=st.integers(1, 8),
       chunk=st.integers(1, 96))
def test_property_token_monotonicity(seed, slots, chunk):
    """Per-request token counts: nondecreasing, ≤ 1/tick, ≤ budget."""
    reqs, res = run_one(seed, 3.0, slots, chunk)
    gen = res.ticks.gen_tokens
    steps = np.diff(gen, axis=0, prepend=np.zeros((1, gen.shape[1]),
                                                  gen.dtype))
    assert steps.min() >= 0
    assert steps.max() <= 1
    assert np.all(gen[-1] <= reqs.output_tokens)
    np.testing.assert_array_equal(res.generated_tokens, gen[-1])


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), rate=st.floats(1.0, 12.0),
       disc=st.sampled_from(DISCIPLINES))
def test_property_goodput_le_offered(seed, rate, disc):
    """Goodput can never exceed offered load — even under overload."""
    _, res = run_one(seed, rate, 4, 32, discipline=disc,
                     record_ticks=False)
    assert res.goodput_tps <= res.offered_tps + 1e-9
    assert 0.0 <= res.slot_occupancy_mean <= 1.0 + 1e-12


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_property_seeded_reproducibility(seed):
    """Same seed ⇒ bit-identical workload AND bit-identical serve trace."""
    cfg = ArrivalConfig(rate_rps=3.0, duration_s=8.0, diurnal_amp=0.5,
                        num_bursts=2, burst_rate_mult=2.0,
                        burst_duration_s=1.0, seed=seed)
    a, b = generate_requests(cfg), generate_requests(cfg)
    assert a.fingerprint() == b.fingerprint()
    other = generate_requests(
        ArrivalConfig(rate_rps=3.0, duration_s=8.0, seed=seed + 1))
    assert a.fingerprint() != other.fingerprint()

    sched = paced().schedule("bittide")
    scfg = ServeConfig(decode_slots=4, prefill_chunk=32)
    r1 = serve(a, sched, cost_model(), scfg)
    r2 = serve(b, sched, cost_model(), scfg)
    assert r1.fingerprint() == r2.fingerprint()


@pytest.mark.parametrize("engine", LANES)
def test_one_compile_paces_all_segments(engine):
    """The pacing ensemble replays one built engine across every mid-serve
    event segment, and a warm re-pace with different event magnitudes
    (same shapes) builds and selects nothing new."""
    pe = paced(engine)  # the cold run may build; it spans every segment
    assert pe.result.freq_ppm.shape[0] == 2
    assert len(pe.result.compiled.segments) > 3
    assert pe.result.num_launches >= len(pe.result.compiled.segments)

    hotter = Scenario(events=(
        FreqStep(t=6.0, nodes=(3,), delta_ppm=-90_000.0),
        DriftRamp(t=10.0, t_end=16.0, nodes=(5,), rate_ppm_per_s=3_000.0),
        NodeHoldover(t=12.0, nodes=(1,)),
        NodeReset(t=18.0, nodes=(1,)),
        LinkDrop(t=14.0, edges=(0,)),
        LinkRestore(t=20.0, edges=(0,)),
    ), name="serve-faults-hot")
    with no_new_compiles():
        pe2 = pace_workers(tc.ring(WORKERS), SPEED_PPM, hotter,
                           engine=engine, device="cpu", **PACE)
    assert pe2.result.freq_ppm.shape == pe.result.freq_ppm.shape
    assert pe2.result.engine == engine


@pytest.mark.parametrize("engine", LANES)
def test_disciplines_have_expected_shape_and_overheads(engine):
    pe = paced(engine)
    t_len = len(pe.times)
    for d in DISCIPLINES:
        sched = pe.schedule(d)
        assert sched.rate.shape == (t_len,)
        assert np.all(sched.rate > 0)
        assert np.all(np.diff(sched.stall_cum_s) >= 0)
    assert pe.schedule("bittide").step_overhead_s == 0.0
    assert pe.schedule("barrier").step_overhead_s > 0.0
    with pytest.raises(ValueError, match="discipline"):
        pe.schedule("lockstep")


@pytest.mark.parametrize("engine", LANES)
def test_bittide_goodput_beats_barrier_under_straggler(engine):
    """The §8 claim at serving granularity: with a straggler onset, the
    logically-synchronous cluster settles at consensus (≈ mean) rate
    while the barrier'd cluster is pinned to the slowest worker AND pays
    the per-step barrier — goodput and p99 no worse."""
    reqs = generate_requests(ArrivalConfig(
        rate_rps=4.0, duration_s=12.0, prompt_mean=32.0, output_mean=16.0,
        seed=3))
    cfg = ServeConfig(decode_slots=8, prefill_chunk=64, slo_s=20.0)
    res = {d: serve(reqs, paced(engine).schedule(d), cost_model(), cfg)
           for d in DISCIPLINES}
    assert res["bittide"].goodput_tps >= res["barrier"].goodput_tps
    assert res["bittide"].p99_s <= res["barrier"].p99_s + 1e-9


def test_serve_watermarks_and_trace():
    """Slot-occupancy/rate excursions ride the shared telemetry layer."""
    reqs = generate_requests(ArrivalConfig(rate_rps=3.0, duration_s=8.0,
                                           seed=11))
    res = serve(reqs, paced().schedule("bittide"), cost_model(),
                ServeConfig(decode_slots=4), trace=True)
    wm = res.watermarks
    assert wm is not None
    assert 0.0 < float(wm.beta_abs_max.max()) <= 1.0  # occupied fraction
    assert wm.num_records == res.num_ticks
    kinds = {e.kind for e in res.trace.events}
    assert {"serve_start", "serve_done"} <= kinds


def test_pacing_trace_records_the_run():
    pe = pace_workers(tc.ring(WORKERS), SPEED_PPM, EVENTS, trace=True,
                      engine="fused", device="cpu", **PACE)
    ev = [e for e in pe.result.trace.events if e.kind == "pacing"]
    assert len(ev) == 1
    assert ev[0].data["engine"] == "fused"
    assert ev[0].data["launches"] == pe.result.num_launches
