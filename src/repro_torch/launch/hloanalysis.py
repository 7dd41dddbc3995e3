"""Collective, FLOP and byte counting for the port's steps (port of
``repro.launch.hloanalysis``, kept under its name).

The reference reads collectives out of XLA's compiled HLO text.  The
port has no compile step, so it counts what one call of a step
dispatches, on real tensors or under ``FakeTensorMode`` on a fake world
(the dry run):

* :class:`OpCounter`, a ``TorchDispatchMode``, maps every ``c10d.*`` and
  ``_c10d_functional.*`` operation onto the reference's five kinds and
  prices it by the reference's ring model:

      all-reduce          2 (n-1)/n * bytes(result)
      all-gather            (n-1)/n * bytes(result)
      reduce-scatter        (n-1)   * bytes(result)   (input = n * result)
      all-to-all            (n-1)/n * bytes(result)
      collective-permute              bytes(result)

  where n is the operation's group size: ``size()`` of its
  ``ProcessGroup`` argument, or the functional operation's
  ``group_size`` (its group, resolved by name, where it has none).  The
  result is a ``c10d`` operation's first argument (the tensors it writes)
  and a functional operation's return value.  ``wait_tensor`` and
  ``recv_`` are not counted, as the reference does not count ``-done``
  (nor is funcol's ``_wrap_tensor_autograd``, which moves nothing); any
  other ``c10d`` operation is not counted either, and its name is kept
  in ``unmatched``.  The same mode sums "bytes accessed": every
  dispatched operation's tensor inputs and outputs, views, metadata
  queries (``prim.*``, such as ``prim.device``) and ``wait_tensor``
  excluded — the reference's unfused per-op figure.
* :class:`StepCounter` adds ``FlopCounterMode``'s FLOPs; its
  :meth:`~StepCounter.cost_analysis` is the counterpart of the
  reference's :func:`cost_analysis_dict`, under the reference's key
  names, and :func:`cost_analysis_dict` counts one call.

Both see through DTensors to their local operations, as
``torch.distributed._tools.mem_tracker.MemTracker`` does, so a step on
a mesh is counted per device, as the reference's per-partition HLO is.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCounter", "StepCounter", "cost_analysis_dict", "DTYPE_BYTES",
           "COLLECTIVE_KINDS"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.int32: 4, torch.uint32: 4, torch.int64: 8,
    torch.uint64: 8, torch.float16: 2, torch.bfloat16: 2, torch.float32: 4,
    torch.float64: 8, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.complex64: 8, torch.complex128: 16,
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# "namespace.name" of each counted operation -> its kind
_KIND = {
    "c10d.allreduce_": "all-reduce",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.send": "collective-permute",
}
# a collective's completion, a receive (the send side counts the hop),
# and funcol's autograd wrapper of a result: no communication of their own
_NOT_COUNTED = ("_c10d_functional.wait_tensor", "c10d.recv_",
                "_c10d_functional._wrap_tensor_autograd")
_NAMESPACES = ("c10d", "_c10d_functional")


def _wire_factor(kind: str, n: int) -> float:
    if kind == "collective-permute":
        return 1.0  # point-to-point: full payload regardless of groups
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    return (n - 1) / n  # all-to-all


def _tensor_bytes(x) -> int:
    """The bytes of the tensors in ``x`` (nested lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    return 0


def _group_size(func, args, kwargs) -> int:
    """The size of the group a collective runs over."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    values = dict(zip((a.name for a in func._schema.arguments), args))
    values.update(kwargs)
    if "group_size" in values:
        return int(values["group_size"])
    if "process_group" in values:
        return dist.ProcessGroup.unbox(values["process_group"]).size()
    return _resolve_process_group(values["group_name"]).size()


class OpCounter(TorchDispatchMode):
    """Counts the collectives and the bytes accessed of every operation
    dispatched while it is active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.unmatched = []
        self._stats = {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
                       for k in COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor in types:
            return NotImplemented   # count the local operations it runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = f"{ns}.{func._opname}"
        if name in _NOT_COUNTED:
            return out
        if ns != "prim" and not func.is_view:
            self.bytes_accessed += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                                    + _tensor_bytes(out))
        if ns in _NAMESPACES:
            kind = _KIND.get(name)
            if kind is None:
                self.unmatched.append(name)
                return out
            result = args[0] if ns == "c10d" else out
            rb = _tensor_bytes(result)
            n = _group_size(func, args, kwargs)
            st = self._stats[kind]
            st["count"] += 1
            st["result_bytes"] += rb
            st["wire_bytes"] += rb * _wire_factor(kind, n)
        return out

    def collective_stats(self) -> Dict[str, Dict]:
        """``{kind: {count, result_bytes, wire_bytes}}`` + a 'total', as
        the reference's ``collective_stats`` returns them."""
        out = {k: dict(v) for k, v in self._stats.items()}
        out["total"] = {
            "count": sum(v["count"] for v in out.values()),
            "result_bytes": sum(v["result_bytes"] for v in out.values()),
            "wire_bytes": sum(v["wire_bytes"] for v in out.values()),
        }
        return out


class StepCounter:
    """FLOPs (``FlopCounterMode``), bytes accessed and collectives of
    everything run inside ``with StepCounter() as c:``."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self.ops = OpCounter()

    def __enter__(self):
        self._flops.__enter__()
        self.ops.__enter__()
        return self

    def __exit__(self, *exc):
        self.ops.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    @property
    def unmatched(self) -> list:
        return self.ops.unmatched

    def cost_analysis(self) -> Dict[str, float]:
        """``{"flops", "bytes accessed"}``, the reference's key names."""
        return {"flops": float(self._flops.get_total_flops()),
                "bytes accessed": float(self.ops.bytes_accessed)}

    def collective_stats(self) -> Dict[str, Dict]:
        return self.ops.collective_stats()


def cost_analysis_dict(fn, *args, **kwargs) -> Dict[str, float]:
    """``{"flops", "bytes accessed"}`` of one call ``fn(*args,
    **kwargs)``: the counterpart of the reference's
    ``cost_analysis_dict(jax.jit(fn).lower(*args).compile())``."""
    with StepCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost_analysis()
