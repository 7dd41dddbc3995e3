"""Seeded request arrival processes for the serving simulator.

A copy of ``repro.serve.arrival`` (numpy only): the same ``default_rng``
calls in the same order, so a config draws the reference's table bit for
bit (``tests/test_torch_serve.py``).

The workload model is the one JetStream/maxtext-style offline serving
harnesses assume: an open-loop arrival process (requests show up whether
or not the cluster is keeping up) with per-request prompt and output
lengths drawn from heavy-tailed distributions.  Two modulations ride on
the base Poisson process:

* **diurnal modulation** — a sinusoidal rate envelope with the period of
  a day (compressed into the simulated horizon), the
  millions-of-users load shape every production serving fleet sees;
* **flash bursts** — short windows at a rate multiple, the
  thundering-herd events (product launch, retry storm) that tail-latency
  SLOs are actually written against.

Draws are generated by thinning an inhomogeneous Poisson process with a
``numpy`` ``default_rng`` seeded from ``ArrivalConfig.seed`` only, so a
given config is bit-reproducible across runs and machines.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ArrivalConfig", "RequestTable", "generate_requests"]


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Open-loop arrival process over one serving horizon.

    rate_rps: mean request rate (requests/second) of the base Poisson
      process.  Production traffic at millions of users is O(10^3..10^5)
      rps against a fleet; per-replica simulations scale it down by the
      replica count — the dynamics are per-replica.
    duration_s: arrival horizon; requests arrive in [0, duration_s).
    diurnal_amp: relative amplitude of the sinusoidal rate envelope
      (0 disables; 0.5 means the peak hour runs at 1.5x the mean).
    diurnal_period_s: period of the envelope in simulated seconds.
    burst_rate_mult / burst_duration_s / num_bursts: flash bursts — each
      burst window multiplies the instantaneous rate by
      ``burst_rate_mult`` for ``burst_duration_s`` seconds; start times
      are drawn uniformly over the horizon.
    prompt_mean / prompt_max: lognormal prompt-length distribution
      (tokens), clipped to [1, prompt_max].
    output_mean / output_max: same for requested output tokens.
    seed: the ONLY entropy source.
    """

    rate_rps: float = 8.0
    duration_s: float = 60.0
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 60.0
    burst_rate_mult: float = 1.0
    burst_duration_s: float = 0.0
    num_bursts: int = 0
    prompt_mean: float = 64.0
    prompt_max: int = 512
    output_mean: float = 32.0
    output_max: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.rate_rps <= 0 or self.duration_s <= 0:
            raise ValueError("rate_rps and duration_s must be positive")
        if self.diurnal_amp < 0 or self.diurnal_amp > 1:
            raise ValueError("diurnal_amp must lie in [0, 1]")
        if self.burst_rate_mult < 1.0:
            raise ValueError("burst_rate_mult must be >= 1")


@dataclasses.dataclass(frozen=True)
class RequestTable:
    """Immutable per-request arrays of one generated workload.

    arrival_s: (R,) float64, sorted ascending.
    prompt_tokens / output_tokens: (R,) int64, >= 1.
    horizon_s: the arrival horizon the table was drawn over — the
      offered-load denominator (NOT the last arrival time: an interval
      with no arrivals still offered its emptiness).
    """

    arrival_s: np.ndarray
    prompt_tokens: np.ndarray
    output_tokens: np.ndarray
    horizon_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "arrival_s",
                           np.asarray(self.arrival_s, np.float64))
        object.__setattr__(self, "prompt_tokens",
                           np.asarray(self.prompt_tokens, np.int64))
        object.__setattr__(self, "output_tokens",
                           np.asarray(self.output_tokens, np.int64))
        horizon = float(self.horizon_s)
        if horizon <= 0.0:
            horizon = float(self.arrival_s[-1]) if len(self.arrival_s) else 0.0
        object.__setattr__(self, "horizon_s", horizon)

    @property
    def num_requests(self) -> int:
        return int(self.arrival_s.shape[0])

    @property
    def total_tokens(self) -> int:
        """Offered token load: prompt + requested output tokens."""
        return int(self.prompt_tokens.sum() + self.output_tokens.sum())

    @property
    def offered_load_tps(self) -> float:
        """Offered load in tokens/second over the arrival horizon."""
        return self.total_tokens / max(self.horizon_s, 1e-12)

    def fingerprint(self) -> bytes:
        """Byte-exact digest of the whole table (reproducibility tests)."""
        return (self.arrival_s.tobytes() + self.prompt_tokens.tobytes()
                + self.output_tokens.tobytes())


def _rate_envelope(t: np.ndarray, cfg: ArrivalConfig,
                   burst_starts: np.ndarray) -> np.ndarray:
    """Instantaneous rate multiplier at times ``t`` (vectorized)."""
    env = np.ones_like(t)
    if cfg.diurnal_amp > 0:
        env = env + cfg.diurnal_amp * np.sin(
            2.0 * np.pi * t / cfg.diurnal_period_s)
    if cfg.burst_duration_s > 0 and len(burst_starts):
        in_burst = np.zeros_like(t, bool)
        for b0 in burst_starts:
            in_burst |= (t >= b0) & (t < b0 + cfg.burst_duration_s)
        env = np.where(in_burst, env * cfg.burst_rate_mult, env)
    return env


def generate_requests(cfg: ArrivalConfig) -> RequestTable:
    """Draw one workload: inhomogeneous Poisson arrivals by thinning.

    Candidate arrivals come from a homogeneous process at the envelope's
    peak rate; each is kept with probability rate(t)/peak — the standard
    thinning construction, exact for piecewise-smooth envelopes.
    """
    rng = np.random.default_rng(cfg.seed)
    burst_starts = (
        np.sort(rng.uniform(0.0, cfg.duration_s, cfg.num_bursts))
        if cfg.num_bursts > 0 and cfg.burst_duration_s > 0
        else np.empty(0))
    peak_mult = (1.0 + cfg.diurnal_amp) * max(cfg.burst_rate_mult, 1.0)
    peak_rate = cfg.rate_rps * peak_mult

    # Candidate count: Poisson(peak_rate * duration), then uniform order
    # statistics — equivalent to summing exponential gaps, one rng call.
    n_cand = rng.poisson(peak_rate * cfg.duration_s)
    t_cand = np.sort(rng.uniform(0.0, cfg.duration_s, n_cand))
    keep_p = cfg.rate_rps * _rate_envelope(t_cand, cfg, burst_starts) \
        / peak_rate
    keep = rng.uniform(0.0, 1.0, n_cand) < keep_p
    arrival = t_cand[keep]
    r = len(arrival)

    def lengths(mean: float, cap: int) -> np.ndarray:
        # Lognormal with sigma=1 (heavy tail), median set so the mean
        # lands near the configured value, clipped to [1, cap].
        mu = np.log(max(mean, 1.0)) - 0.5
        raw = rng.lognormal(mu, 1.0, r)
        return np.clip(np.rint(raw), 1, cap).astype(np.int64)

    return RequestTable(arrival_s=arrival,
                        prompt_tokens=lengths(cfg.prompt_mean,
                                              cfg.prompt_max),
                        output_tokens=lengths(cfg.output_mean,
                                              cfg.output_max),
                        horizon_s=cfg.duration_s)
