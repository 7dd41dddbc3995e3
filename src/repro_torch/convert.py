"""Carry the reference package's objects across into the port's types.

A network and its state are this system's weights: the topology, the link
parameters, the controller and simulation configs, and a prior result
used as ``init=``; a scenario (its events) and a reframing policy carry a
dynamic run across the same way, and a ``BittideNetwork`` the facade's
whole network.  A model's parameter tree, its decode caches and an
AdamW state (``mu`` / ``nu`` / ``count``; nested dicts of arrays) carry
across leaf for leaf.  Each converter reads
the reference object by attribute or by structure (duck typing, so this
module imports nothing of ``repro``) and returns the port's type with
numpy arrays or tensors::

    topo_t = convert.topology(repro_topo)
    res_t = simulate(topo_t, convert.links(repro_links), ...)
    run_scenario(topo_t, ..., convert.scenario(repro_scenario), ...)
    params_t = convert.model_params(
        jax.tree.map(np.asarray, ref_params), device="cpu")
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.frame_model import LinkParams, SimConfig
from repro_torch.core.network import BittideNetwork
from repro_torch.core.reframing import ReframePolicy
from repro_torch.core.topology import Topology
from repro_torch.scenarios import events as _events

__all__ = ["topology", "links", "controller", "sim_config", "init_state",
           "event", "scenario", "reframe_policy", "network", "model_params"]


def topology(obj) -> Topology:
    """A reference ``Topology`` (num_nodes, src, dst, name)."""
    return Topology(int(obj.num_nodes), np.asarray(obj.src),
                    np.asarray(obj.dst), name=str(obj.name))


def links(obj) -> LinkParams:
    """A reference ``LinkParams`` ((E,) or per-draw (B, E) fields)."""
    return LinkParams(latency_s=np.array(obj.latency_s, np.float64),
                      beta0=np.array(obj.beta0, np.float64))


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def controller(obj) -> ControllerConfig:
    """A reference ``ControllerConfig`` (per-draw gains stay arrays)."""
    return ControllerConfig(**_fields(ControllerConfig, obj))


def sim_config(obj) -> SimConfig:
    """A reference ``SimConfig``."""
    return SimConfig(**_fields(SimConfig, obj))


def init_state(obj):
    """A reference result used as ``init=``, as numpy state.

    ``SimResult`` / ``EnsembleResult`` (anything with ``.c_state``) give
    ``(psi, nu, c_state)`` for the segment-sum lane; a ``DenseResult``
    (the ``(freq_ppm, psi)`` pair with ``.nu``) gives ``(psi, nu)`` for
    the fused lane.
    """
    if hasattr(obj, "c_state"):
        return (np.array(obj.psi, np.float32), np.array(obj.nu, np.float32),
                {k: np.array(v, np.float32) for k, v in obj.c_state.items()})
    if getattr(obj, "nu", None) is None:
        raise ValueError("init object carries no exact final .nu")
    return np.array(obj[1], np.float32), np.array(obj.nu, np.float32)


# The port's event types, by the reference's class names.
_EVENT_TYPES = {name: getattr(_events, name) for name in (
    "Mark", "LatencyStep", "FreqStep", "DriftRamp", "NodeHoldover",
    "NodeReset", "LinkDrop", "LinkRestore", "Reframe")}


def event(obj):
    """A reference scenario event (``LatencyStep``, ``FreqStep``, …): the
    port's event of the same class name with the same field values."""
    cls = _EVENT_TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no scenario event type {type(obj).__name__!r} in "
                        "repro_torch.scenarios")
    return cls(**_fields(cls, obj))


def scenario(obj) -> _events.Scenario:
    """A reference ``Scenario`` (its events converted one by one)."""
    return _events.Scenario(events=tuple(event(ev) for ev in obj.events),
                            name=str(obj.name))


def reframe_policy(obj) -> ReframePolicy:
    """A reference ``ReframePolicy``."""
    return ReframePolicy(**_fields(ReframePolicy, obj))


def network(obj, *, device=None) -> BittideNetwork:
    """A reference ``BittideNetwork``: the same topology, links, ``ppm_u``
    and ω_nom, running on ``device`` (None means the CUDA card)."""
    return BittideNetwork(topo=topology(obj.topo), links=links(obj.links),
                          ppm_u=np.array(obj.ppm_u, np.float64),
                          omega_nom=float(obj.omega_nom), device=device)


# numpy has no bf16 / f8: jax hands them over as ml_dtypes arrays, whose
# bits are read here through an integer view of the same width.
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _BITS:
        view, tdt = _BITS[a.dtype.name]
        t = torch.from_numpy(np.ascontiguousarray(a).view(view).copy()).view(tdt)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is None or not t.is_floating_point():
        dtype = t.dtype
    return t.to(device=device, dtype=dtype)


def model_params(tree, device=None, dtype=None):
    """A reference parameter, decode-cache or optimizer-state tree (nested
    dicts of arrays, e.g. ``jax.tree.map(np.asarray, materialize(...))``,
    ``prefill``'s caches or ``adamw_init``'s ``{"mu", "nu", "count"}``)
    as the port's tree of tensors, leaf for leaf, on ``device`` (None
    means the CUDA card); floating leaves are cast to ``dtype`` when it
    is given (an integer leaf such as ``count`` keeps its dtype); bf16
    and float8 leaves keep their bits."""
    dev = resolve_device(device)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return _tensor(t, dev, dtype)

    return go(tree)
