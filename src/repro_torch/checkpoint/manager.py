"""Fault-tolerant checkpointing: atomic, one entry per leaf, async (port
of ``repro.checkpoint.manager``, with its on-disk layout).

Layout (one directory per step):

    ckpt_dir/step_000123/
        meta.json            {step, names, shapes, dtypes, extra}
        arrays.npz           one entry per tree leaf, named by its path

A leaf's name is its key path as the reference writes it
(``['params']/['embed']``); bf16 leaves are stored as their uint16 bits
with the true dtype in ``meta.json``.  So a checkpoint written by either
package restores in the other.  Writes go to a tmp directory renamed
into place (atomic on POSIX): a crash mid-save never corrupts the
latest checkpoint.

A tree of DTensors (a state on a ``DeviceMesh``) saves from every rank
of the default process group: each leaf is gathered to its full array
(``full_tensor``, collective, in tree order), rank 0 writes, and every
rank waits at a barrier (``CheckpointManager``: in ``wait``, after an
asynchronous write).  ``restore`` puts the leaves on one device, or with
``shardings`` distributes each onto a mesh by its placements —
including a mesh other than the one that saved, which is what makes
elastic rescale (``ft.elastic``) work.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_flatten_with_path, tree_unflatten

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _flatten(tree):
    flat = tree_flatten_with_path(tree)
    names = ["/".join(f"[{k!r}]" for k in path) for path, _ in flat]
    return names, [leaf for _, leaf in flat], [path for path, _ in flat]


def _on_mesh(leaves) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in leaves)


def _host_copy(leaf: torch.Tensor) -> torch.Tensor:
    """A CPU copy of a leaf; a DTensor's full array (collective)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    return leaf.detach().to("cpu", copy=True)


def _writes(on_mesh: bool) -> bool:
    """Whether this process writes: every process for a local tree, rank
    0 of the default group for a tree on a mesh."""
    import torch.distributed as dist
    return not on_mesh or dist.get_rank() == 0


def _to_numpy(leaf: torch.Tensor):
    """(array to store, the dtype's name as numpy / ml_dtypes give it) of
    a tensor leaf: bf16 as its uint16 bits (numpy has no bf16)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None) -> str:
    """Write ``tree`` as step ``step``; on a mesh, collective over the
    default group (see the module docstring)."""
    names, leaves, _ = _flatten(tree)
    on_mesh = _on_mesh(leaves)
    if on_mesh:
        leaves = [_host_copy(leaf) for leaf in leaves]
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if _writes(on_mesh):
        _write(ckpt_dir, final, step, names, leaves, extra)
    if on_mesh:
        import torch.distributed as dist
        dist.barrier()
    return final


def _write(ckpt_dir, final, step, names, leaves, extra) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    stored = [_to_numpy(leaf) for leaf in leaves]
    arrays = {n: a for n, (a, _) in zip(names, stored)}
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": step, "names": names,
                "shapes": {n: list(a.shape) for n, a in arrays.items()},
                "dtypes": {n: dt for n, (_, dt) in zip(names, stored)},
                "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template: Any, shardings: Any = None,
            device=None) -> Any:
    """Restore into the structure of ``template`` (a tree of tensors, or
    of anything with a torch ``dtype``), each leaf cast to its template's
    dtype.  With ``shardings`` (a matching tree of ``(mesh, placements)``
    pairs) each leaf is distributed from the full array onto its mesh —
    any mesh, not only the one that saved; every rank of the mesh calls
    this.  Else on ``device``; None means the CUDA card (raises without
    one)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    names, leaves, paths = _flatten(template)
    if set(names) != set(meta["names"]):
        missing = set(names) ^ set(meta["names"])
        raise ValueError(
            f"checkpoint/template structure mismatch: {sorted(missing)[:5]}")
    if shardings is None:
        dev = resolve_device(device)
        place = [lambda t, dev=dev: t.to(dev)] * len(leaves)
    else:
        from torch.distributed.tensor import distribute_tensor
        flat = tree_flatten_with_path(shardings)
        if [p for p, _ in flat] != paths:
            raise ValueError("shardings do not match the template's tree")
        place = [lambda t, m=m, pl=pl: distribute_tensor(
            t.to(m.device_type), m, pl) for _, (m, pl) in flat]
    saved_dtypes = meta.get("dtypes", {})
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for n, tmpl, put in zip(names, leaves, place):
            arr = data[n]
            if saved_dtypes.get(n) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(put(t.to(dtype=tmpl.dtype)))
    return tree_unflatten(paths, out)


class CheckpointManager:
    """keep-K GC + optional async (background-thread) saves."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True):
        """Save ``tree`` as step ``step``.  The host snapshot is taken
        here, before any thread starts, so later steps may change or
        replace the tensors; ``blocking=False`` writes it on a thread
        (``wait`` joins it and raises what it raised).  A tree on a mesh
        is gathered here on every rank, rank 0 writes it, and every rank
        meets at a barrier when the write is done (in ``wait`` if
        ``blocking=False``)."""
        self.wait()
        names, leaves, _ = _flatten(tree)
        on_mesh = _on_mesh(leaves)
        host = [_host_copy(leaf) for leaf in leaves]
        final = os.path.join(self.ckpt_dir, f"step_{step:09d}")
        self._barrier = on_mesh

        def work():
            if _writes(on_mesh):
                _write(self.ckpt_dir, final, step, names, host, extra)
                self._gc()

        if blocking:
            work()
            self.wait()
            return

        def run():
            try:
                work()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def restore_latest(self, template: Any, shardings: Any = None,
                       device=None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore(self.ckpt_dir, step, template, shardings,
                             device)

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.ckpt_dir)
            if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)
