"""Train / serve step construction (port of ``repro.launch.train``).

    params, opt_state = init_train_state(cfg, None, generator)   # the card
    train_step = make_train_step(cfg)
    params, opt_state, metrics = train_step(params, opt_state, batch, step)

A step is eager PyTorch on the device its tensors live on: the loss's
gradients by ``torch.autograd`` (:func:`value_and_grad`), then a
functional AdamW update.  The reference's abstract argument builders
(``abstract_train_args`` / ``abstract_serve_args``: sharded shapes for
the dry runs) wait for the dry-run slice, and placing a state on a mesh
for the elastic / mesh slice.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch._tree import tree_flatten_with_path, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ModelZoo, materialize
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["use_fsdp", "value_and_grad", "make_train_step",
           "make_prefill_step", "make_decode_step", "init_train_state",
           "lr_schedule"]

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
        loss, grads = loss_and_grads(params, batch)
        new_params, new_opt, gnorm = adamw_update(
            grads, opt_state, params, opt, lr_scale=lr_schedule(step) / opt.lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": step + 1}
        return new_params, new_opt, metrics

    return train_step


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

def init_train_state(cfg: ArchConfig, mesh, generator: torch.Generator,
                     opt: Optional[AdamWConfig] = None, device=None):
    """Real params (``materialize`` from ``generator``) + optimizer state
    on ``device``; None means the CUDA card (raises without one).  A
    ``mesh`` is not supported yet (the elastic / mesh slice)."""
    if mesh is not None:
        raise NotImplementedError(
            "init_train_state on a mesh comes with the elastic / mesh slice "
            "(ROADMAP.md queue 1, item 2); pass mesh=None")
    zoo = ModelZoo(cfg)
    opt = opt or AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    params = materialize(zoo.param_defs(), generator,
                         dtype_of(cfg.param_dtype), device=device)
    return params, adamw_init(params, opt)
