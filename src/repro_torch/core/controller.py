"""bittide clock controllers (paper §2 and §4.3), on torch tensors.

Port of ``repro.core.controller``.  Units and controller kinds are the
reference's:

- ``kp`` is the *effective* proportional gain in relative-frequency per
  frame of occupancy error (the paper's Fig. 15 caption, "proportional
  gain 2e-8"); :func:`hardware_gain` converts FINC/FDEC steps per frame.
- ``proportional`` — eq. (1) of the paper, continuous actuation.
- ``discrete`` — the FINC/FDEC actuator of §4.3: ``c_est = fs · Σ pulses``
  slews toward the wanted correction by at most ``pulses_per_update``
  pulses per control period.
- ``pi`` — proportional–integral variant.

``kp`` and ``beta_off`` are runtime data: the simulation engines pass the
gain to :func:`controller_step` per draw, so a gain sweep builds nothing.
State tensors have a trailing node axis and any leading draw axes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ControllerConfig", "hardware_gain", "controller_init",
           "controller_step", "holdover_freeze"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    kind: str = "proportional"  # proportional | discrete | pi
    kp: float = 2e-10           # relative-frequency per frame of occupancy error
    ki: float = 0.0             # integral gain (pi only), per frame per control period
    beta_off: float = 0.0       # occupancy setpoint, frames (normalized; DDC midpoint = 0)
    fs: float = 1e-8            # FINC/FDEC step size (discrete only)
    pulses_per_update: int = 64 # max pulses per control period (1 MHz pulse rate * dt)

    def __post_init__(self):
        if self.kind not in ("proportional", "discrete", "pi"):
            raise ValueError(f"unknown controller kind {self.kind!r}")
        # kp / beta_off may be per-draw arrays (batched gain sweeps).
        if np.any(np.asarray(self.kp) < 0) or self.fs <= 0:
            raise ValueError("kp must be >= 0 and fs > 0")

    def static_key(self) -> "ControllerConfig":
        """Copy with the runtime gains zeroed (what a build may key on)."""
        return dataclasses.replace(self, kp=0.0, beta_off=0.0)


def hardware_gain(kp_hw: float, fs: float) -> float:
    """Convert the paper's hardware gain (steps/frame) to effective kp."""
    return kp_hw * fs


def controller_init(cfg: ControllerConfig, shape, device=None) -> dict:
    """Initial controller state: ``c_est`` (discrete) and ``integ`` (pi).

    ``shape`` is the state shape — ``(N,)`` or ``(B, N)``.
    """
    del cfg
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c_est": zeros, "integ": zeros.clone()}


def controller_step(cfg: ControllerConfig, state: dict, agg_err, kp=None):
    """One control update.

    Args:
      cfg: controller configuration.
      state: dict from :func:`controller_init`.
      agg_err: summed occupancy error Σ_{j→i}(β − β_off) per node.
      kp: gain overriding ``cfg.kp`` — a scalar or a tensor broadcasting
        against ``agg_err`` (a (B, 1) column of per-draw gains).

    Returns:
      (new_state, c_corr), c_corr the applied relative-frequency correction.
    """
    if kp is None:
        kp = cfg.kp
    c_rel = kp * agg_err
    if cfg.kind == "proportional":
        return state, c_rel
    if cfg.kind == "pi":
        integ = state["integ"] + cfg.ki * agg_err
        return {**state, "integ": integ}, c_rel + integ
    # discrete: slew c_est toward c_rel in units of fs, bounded pulse budget.
    # fs is divided as a tensor on the state's device: CUDA divides by a
    # host scalar as a multiply by its reciprocal, which rounds differently
    # from the true quotient the reference rounds to whole pulses.
    c_est = state["c_est"]
    fs = torch.tensor(cfg.fs, dtype=torch.float32, device=c_est.device)
    want_pulses = torch.round((c_rel - c_est) / fs)
    pulses = torch.clamp(want_pulses, -cfg.pulses_per_update,
                         cfg.pulses_per_update)
    c_est = c_est + pulses * cfg.fs
    return {**state, "c_est": c_est}, c_est


def holdover_freeze(state_new: dict, state_old: dict, enabled) -> dict:
    """Keep ``state_old`` for nodes in clock holdover (``enabled`` False).

    A node in holdover keeps its last applied correction, and its
    controller state (the PI integrator, the discrete ``c_est``) must not
    evolve while its loop is open.
    """
    return {k: torch.where(enabled, state_new[k], state_old[k])
            for k in state_new}
