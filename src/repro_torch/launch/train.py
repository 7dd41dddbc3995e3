"""Train / serve step construction (port of ``repro.launch.train``).

    params, opt_state = init_train_state(cfg, None, generator)   # the card
    train_step = make_train_step(cfg)
    params, opt_state, metrics = train_step(params, opt_state, batch, step)

A step is eager PyTorch on the device its tensors live on: the loss's
gradients by ``torch.autograd`` (:func:`value_and_grad`), then a
functional AdamW update.

On a mesh (``init_train_state(cfg, mesh, ...)``: every leaf a DTensor,
placed by ``pspec_tree``), the same ``train_step`` runs the reference's
step as explicit collectives, where GSPMD partitions it under
``jax.jit``:

1. every rank gathers the full parameters from their shards;
2. it takes its slice of the batch — the batch dimension split over the
   mesh's data axes, with ``fit_spec_to_shape``'s rule where they do
   not divide — and computes the loss and gradients on it;
3. the gradients are averaged over the data axes by all-reduce, one leaf
   at a time in tree order (one all-reduce per data axis);
4. AdamW runs on each rank's shard of every leaf, with the norm of the
   full gradients;
5. the loss is the mean over the data ranks.

The batch is the global batch, the same on every rank.  Ranks along
"model" compute the same gradients (tensor-parallel compute is not
split).  On a one-rank mesh the step equals the plain step bit for bit.
The reference's abstract argument builders (``abstract_train_args`` /
``abstract_serve_args``: sharded shapes for the dry runs) wait for the
dry-run slice.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch._tree import (tree_flatten_with_path, tree_leaves,
                               tree_map, tree_unflatten)
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models import ModelZoo, materialize
from repro_torch.models.layers import (dtype_of, fit_spec_to_shape,
                                       pspec_tree, resolve_spec,
                                       spec_placements)
from repro_torch.optim.adamw import (AdamWConfig, adamw_apply, adamw_init,
                                     adamw_update, global_norm)

__all__ = ["use_fsdp", "value_and_grad", "make_train_step",
           "make_prefill_step", "make_decode_step", "init_train_state",
           "state_shardings", "lr_schedule"]

FSDP_PARAM_THRESHOLD = 2_000_000_000  # shard weights over data above 2B params


def use_fsdp(cfg: ArchConfig) -> bool:
    return cfg.param_count() >= FSDP_PARAM_THRESHOLD


def lr_schedule(step, base_lr=3e-4, warmup=200, total=10_000) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0 at ``total``: an f32 0-d
    tensor (on the CPU), computed in f32 as the reference's."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / warmup, max=1.0)
    prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    return base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad`` over a tree of parameters: ``fn(params,
    *args)`` -> (its value, detached; the gradient tree of ``params``)."""
    def wrapped(params, *args):
        flat = tree_flatten_with_path(params)
        paths = [path for path, _ in flat]
        live = [leaf.detach().requires_grad_(True) for _, leaf in flat]
        with torch.enable_grad():
            value = fn(tree_unflatten(paths, live), *args)
        grads = torch.autograd.grad(value, live)
        return value.detach(), tree_unflatten(paths, list(grads))
    return wrapped


# ------------------------------------------------------------------- steps

def make_train_step(cfg: ArchConfig, opt: Optional[AdamWConfig] = None):
    zoo = ModelZoo(cfg)
    opt = opt or AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    loss_and_grads = value_and_grad(zoo.train_loss)

    def train_step(params, opt_state, batch, step):
        lr_scale = lr_schedule(step) / opt.lr
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_step(mesh, loss_and_grads, opt, params, opt_state,
                              batch, step, lr_scale)
        loss, grads = loss_and_grads(params, batch)
        new_params, new_opt, gnorm = adamw_update(
            grads, opt_state, params, opt, lr_scale=lr_scale)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": step + 1}
        return new_params, new_opt, metrics

    return train_step


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _mesh_of(params):
    """The mesh of a tree of DTensors; None for plain tensors."""
    leaves = tree_leaves(params)
    on_mesh = [_is_dtensor(t) for t in leaves]
    if not any(on_mesh):
        return None
    if not all(on_mesh):
        raise TypeError("parameters mix DTensors and plain tensors")
    return leaves[0].device_mesh


def _local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds in full (a local
    split, no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements).to_local()


def _batch_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a global batch leaf: dimension 0 split over
    the data axes that divide it."""
    spec = resolve_spec(("dp",) + (None,) * (x.dim() - 1), use_fsdp=False,
                        dp_axes=dp_axes_of(mesh))
    spec = fit_spec_to_shape(tuple(x.shape), spec, mesh)
    return _local_shard(x, mesh, spec_placements(spec, mesh))


def _mesh_step(mesh, loss_and_grads, opt, params, opt_state, batch, step,
               lr_scale):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    local = lambda t: t.to_local() if _is_dtensor(t) else t

    def like(t, ref):
        if not _is_dtensor(ref):
            return t
        return DTensor.from_local(t, ref.device_mesh, ref.placements,
                                  run_check=False, shape=ref.shape,
                                  stride=ref.stride())

    full = tree_map(lambda p: p.full_tensor(), params)
    loss, grads = loss_and_grads(full, tree_map(
        lambda x: _batch_slice(x, mesh), batch))
    dp = dp_axes_of(mesh)
    n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp)
    flat = tree_flatten_with_path(grads)
    reduced, reduces = [], 0
    with torch.no_grad():
        for t in [g for _, g in flat] + [loss]:
            t = t.contiguous()
            for axis in dp:
                dist.all_reduce(t, group=mesh.get_group(axis))
                reduces += 1
            reduced.append(t.div_(n_dp))
        loss = reduced.pop()
        grads = tree_unflatten([path for path, _ in flat], reduced)
        gnorm = global_norm(grads)
        shards = tree_map(lambda g, p: _local_shard(g, mesh, p.placements),
                          grads, params)
    del full, grads
    new_p, new_opt, gnorm = adamw_apply(
        shards, tree_map(local, opt_state), tree_map(local, params), opt,
        gnorm, lr_scale=lr_scale)
    new_p = tree_map(like, new_p, params)
    new_opt = tree_map(like, new_opt, opt_state)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": step + 1,
               "all_reduces": reduces}
    return new_p, new_opt, metrics


def make_prefill_step(cfg: ArchConfig):
    zoo = ModelZoo(cfg)

    def prefill_step(params, batch):
        return zoo.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    zoo = ModelZoo(cfg)

    def decode_step(params, caches, batch):
        return zoo.decode(params, caches, batch)

    return decode_step


# ------------------------------------------------- concrete initialization

def state_shardings(cfg: ArchConfig, mesh,
                    dp_axes: Tuple[str, ...] = ("data",)):
    """Where ``init_train_state`` places a training state on ``mesh``: a
    tree ``{"params", "opt": {"mu", "nu", "count"}}`` of ``(mesh,
    placements)`` pairs, as ``checkpoint.restore(..., shardings=...)``
    takes it.  Parameters by ``pspec_tree(..., use_fsdp=use_fsdp(cfg),
    dp_axes=dp_axes)``, the moments as their parameters, ``count``
    replicated."""
    from torch.distributed.tensor import Replicate
    specs = pspec_tree(ModelZoo(cfg).param_defs(), use_fsdp=use_fsdp(cfg),
                       dp_axes=dp_axes)
    place = tree_map(lambda s: (mesh, spec_placements(s, mesh)), specs)
    return {"params": place,
            "opt": {"mu": place, "nu": place,
                    "count": (mesh, (Replicate(),) * mesh.ndim)}}


def init_train_state(cfg: ArchConfig, mesh, generator: torch.Generator,
                     opt: Optional[AdamWConfig] = None,
                     dp_axes: Tuple[str, ...] = ("data",), device=None):
    """Real params (``materialize`` from ``generator``) + optimizer state.

    With ``mesh`` None, on ``device`` (None means the CUDA card; raises
    without one).  On a ``DeviceMesh`` every rank materializes the full
    state on the mesh's device type (the same generator seed on every
    rank), then distributes each leaf by :func:`state_shardings`."""
    zoo = ModelZoo(cfg)
    opt = opt or AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, not {type(mesh)}")
        device = mesh.device_type
    params = materialize(zoo.param_defs(), generator,
                         dtype_of(cfg.param_dtype), device=device)
    if mesh is None:
        return params, adamw_init(params, opt)
    from torch.distributed.tensor import distribute_tensor
    state = tree_map(lambda t, sh: distribute_tensor(t, *sh),
                     {"params": params, "opt": adamw_init(params, opt)},
                     state_shardings(cfg, mesh, dp_axes))
    return state["params"], state["opt"]
