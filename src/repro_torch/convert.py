"""Carry the reference package's objects across into the port's types.

A network and its state are this system's weights: the topology, the link
parameters, the controller and simulation configs, and a prior result
used as ``init=``.  Each converter reads the reference object by attribute
(duck typing, so this module imports nothing of ``repro``) and returns the
port's type with numpy arrays, which both packages then consume
unchanged::

    topo_t = convert.topology(repro_topo)
    res_t = simulate(topo_t, convert.links(repro_links), ...)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.controller import ControllerConfig
from repro_torch.core.frame_model import LinkParams, SimConfig
from repro_torch.core.topology import Topology

__all__ = ["topology", "links", "controller", "sim_config", "init_state"]


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
