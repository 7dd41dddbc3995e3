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

1. every rank gathers its parameters from their shards: under the
   ``tp`` profile, for every family, each leaf
   that "model" splits in compute (``models.parallel.leaf_roles``) only
   over the other axes — the rank keeps its "model" shard — and every
   other leaf in full; but a stacked leaf whose "fsdp" dimension is
   stored sharded over a batch axis (FSDP: ``use_fsdp``, or the
   ``zero3`` profile) stays this rank's shard, and the layer loops
   gather one layer's slice of it at a time, inside the layer's
   checkpoint (``models.fsdp``), as the reference's ``lax.scan`` takes
   one layer's slice per iteration;
2. it takes its slice of the batch — the batch dimension split over the
   profile's batch axes (``_profile``: the mesh's data axes, and "model"
   too for the ``dp`` and ``zero3`` profiles), with
   ``fit_spec_to_shape``'s rule where they do not divide — and computes
   the loss and gradients on it, with the "model" group's collectives
   inside the layers and the loss where the compute is split (the MoE
   block's token groups are the global batch's, ``_batch_split``: a
   train step whose group would span data ranks raises);
3. the gradients are averaged over the batch axes by all-reduce, one
   leaf at a time in tree order (one all-reduce per axis); a leaf each
   rank used only column ranges of (the kv heads its q heads read, a
   Mamba2 block's heads and share of B and C in its fused ``in_proj``
   and conv) is summed over "model" first; a layer-gathered leaf's
   gradient comes out of backward as this rank's shard, reduce-scattered
   layer by layer over the axes that shard it, and is all-reduced over
   the other batch axes only;
4. AdamW runs on each rank's shard of every leaf, with the norm of the
   full gradients (the layer-gathered leaves' squared norms summed over
   the batch axes that shard them, one all-reduce per axis, then the
   split leaves' over "model" in one all-reduce);
5. the loss is the mean over those ranks.

So under ``tp`` ranks along "model" hold and compute their share of the
split leaves, as GSPMD partitions the reference's step; a block whose
heads "model" does not divide (smollm-135m's 9 on 16) stays gathered,
and ``models.parallel.gathered_leaves`` names it.  Other profiles
gather every leaf, and ranks along "model" compute the same
gradients.  A batch leaf is the global batch, the same on every rank,
or a DTensor (redistributed to that split).

``make_prefill_step`` and ``make_decode_step`` split so too, with the
logits gathered over the vocabulary and returned as DTensors sharded on
the batch over the batch axes (replicated where ``fit_spec_to_shape``
drops them, as for ``long_500k``'s batch of one).  Their K/V caches lie
as the reference lays them out (``cache_defs``: the batch over the
batch axes, the sequence over "model" where it divides S, else
replicated over "model"; ``_cache_placements``): decode takes and
returns each rank's shard, writing slot S-1 on the rank that holds it
and attending with flash-decoding's combine over the ranks' slices, and
moves no cache; prefill hands each rank its slice of every kv head
(``_prefill_kv_shards``: an all-to-all where "model" splits the heads).
The SSM family's states lie on their heads over "model", and prefill
and decode compute each rank's heads, so neither moves a state; its
conv tails lie on their channels over "model", which cut across a
rank's, so decode takes them whole (one all-gather) and both return
every channel for a local slice.  The hybrid family's ``shared_kv``
caches are K/V caches, its groups' and tail's Mamba2 states and conv
tails the SSM family's.  The encoder-decoder family's ``cross_kv`` lies
as a K/V cache placed by its own length, the source's: decode reads
each rank's slice of it and writes none, prefill hands it out as the
self cache;
``widen_mesh_caches`` appends decode's slot to the self-attention
caches and re-places them (an all-gather over "model" where the
sequence was split); ``cross_kv`` keeps its length and its placement.
A cache placed otherwise raises.  Other profiles gather the
parameters and take and return the caches as each rank's slice of the
batch.  On a one-rank mesh every step equals the plain step bit for
bit: the split path's operations on a group of one are the plain
path's.

The split runs wherever the mesh runs: gloo worlds of CPU processes
(``tests/test_torch_tp_steps.py``, ``tests/test_torch_tp_decode.py``,
``tests/test_torch_tp_vlm.py``, ``tests/test_torch_tp_moe.py``,
``tests/test_torch_tp_ssm.py``, ``tests/test_torch_tp_hybrid.py``,
``tests/test_torch_tp_encdec.py``) and
NCCL on cards (``chip_smoke.py`` phase 14, one rank).

``abstract_train_args`` / ``abstract_serve_args`` build a step's
arguments as fake tensors (fake DTensors on a mesh) for the dry run
(``launch.dryrun``), inside a ``FakeTensorMode``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import (tree_flatten_with_path, tree_leaves,
                               tree_map, tree_unflatten)
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models import ModelZoo, materialize
from repro_torch.models.fsdp import (STACKED, AxisGather, LayerGather,
                                     LeafGather, put_ranges, take_ranges)
from repro_torch.models.layers import (abstract, dtype_of, fake_dtensor,
                                       fit_spec_to_shape, pspec_tree,
                                       resolve_spec, spec_placements)
from repro_torch.models.parallel import (BatchSplit, TensorParallel,
                                        leaf_roles, tp_layout)
from repro_torch.models.transformer import cache_defs
from repro_torch.optim.adamw import (AdamWConfig, adamw_apply, adamw_init,
                                     adamw_update)

__all__ = ["use_fsdp", "value_and_grad", "make_train_step",
           "make_prefill_step", "make_decode_step", "widen_mesh_caches",
           "abstract_train_args",
           "abstract_serve_args", "init_train_state", "state_shardings",
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
    plan = _planner(cfg)

    def train_step(params, opt_state, batch, step):
        if _is_dtensor(step):
            step = step.to_local()
        lr_scale = lr_schedule(step) / opt.lr
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_step(mesh, cfg, plan(mesh, params), loss_and_grads,
                              opt, params, opt_state, batch, step, lr_scale)
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


def _batch_axes(cfg: ArchConfig, mesh) -> Tuple[str, ...]:
    """The mesh axes a step splits its batch over: the profile's."""
    return _profile(cfg, dp_axes_of(mesh))[0]


def _local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds in full (a local
    split, no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements).to_local()


def _batch_placements(shape, dim: int, axes, mesh) -> tuple:
    """Dimension ``dim`` of ``shape`` split over the ``axes`` that divide
    it."""
    tags = [None] * len(shape)
    tags[dim] = "dp"
    spec = resolve_spec(tags, use_fsdp=False, dp_axes=tuple(axes))
    return spec_placements(fit_spec_to_shape(tuple(shape), spec, mesh), mesh)


def _batch_local(x, dim: int, axes, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` along its batch dimension ``dim``: a
    DTensor redistributed there (communication where it is placed
    otherwise), a plain tensor every rank holds in full split locally."""
    placements = _batch_placements(x.shape, dim, axes, mesh)
    if _is_dtensor(x):
        return x.redistribute(mesh, placements).to_local()
    return _local_shard(x, mesh, placements)


def _batch_global(t: torch.Tensor, dim: int, axes, mesh, full_batch: int):
    """The DTensor of batch ``full_batch`` whose rank-local slice along
    ``dim`` is ``t``."""
    from torch.distributed.tensor import DTensor
    shape = list(t.shape)
    shape[dim] = full_batch
    return DTensor.from_local(t, mesh,
                              _batch_placements(shape, dim, axes, mesh),
                              run_check=False)


def _batch_split(cfg: ArchConfig, batch, axes, mesh):
    """The data ranks whose slices of ``batch`` a step on ``mesh``
    computes (the mesh axes that split its batch dimension, as
    :func:`_batch_local` places it), for the MoE block's token groups:
    None for the other families, or where no axis splits the batch."""
    if cfg.family != "moe":
        return None
    placements = _batch_placements(batch["tokens"].shape, 0, axes, mesh)
    names = [mesh.mesh_dim_names[i] for i, p in enumerate(placements)
             if p.is_shard(0)]
    if not names:
        return None
    sizes = tuple(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)
    index = 0
    for a, n in zip(names, sizes):
        index = index * n + mesh.get_local_rank(a)
    return BatchSplit(tuple(mesh.get_group(a) for a in names), sizes, index)


def _tensor_parallel(cfg: ArchConfig, mesh, params):
    """(the ``TensorParallel`` of this rank, the role of every leaf) for a
    step on ``mesh``; (None, None) where no compute splits over "model"
    (a profile other than ``tp``, or a mesh with no "model" axis)."""
    if not _profile(cfg, dp_axes_of(mesh))[1] or \
            "model" not in mesh.mesh_dim_names:
        return None, None
    m = mesh.mesh_dim_names.index("model")
    size, rank = mesh.size(m), mesh.get_local_rank("model")
    roles = leaf_roles(cfg, ModelZoo(cfg).param_defs(), size, rank)
    return (TensorParallel(mesh.get_group("model"), size, rank,
                           **tp_layout(cfg, size)), roles)


def _model_placements(p, mesh, dim: int) -> tuple:
    """``p``'s placements with every axis but "model" replicated, "model"
    sharding ``dim``: the layout of a split leaf in compute."""
    from torch.distributed.tensor import Replicate, Shard
    m = mesh.mesh_dim_names.index("model")
    want = Shard(dim % p.ndim)
    if p.placements[m] != want:
        raise ValueError(f"a leaf split on dim {dim} over 'model' is stored "
                         f"as {p.placements}")
    return tuple(want if i == m else Replicate() for i in range(mesh.ndim))


def _compute_view(p, role, mesh):
    """The tensor a rank computes with: its "model" shard of a split leaf
    (gathered over the other axes), else the whole leaf, its column
    ranges concatenated for a ``("slice", dim, ranges)`` leaf."""
    if role is None or role[0] == "gathered":
        return p.full_tensor()
    if role[0] == "split":
        return p.redistribute(mesh, _model_placements(p, mesh, role[1])
                              ).to_local()
    return take_ranges(p.full_tensor(), role[1], role[2])


def _layer_gather(cfg, mesh, params, roles, axes):
    """The ``LayerGather`` of a step on ``mesh``, or None where it holds
    no leaf as a shard.  A stacked leaf (``models.fsdp.STACKED``) whose
    "fsdp" dimension is stored sharded over a batch axis of the step
    (``axes``) is held as this rank's shard and gathered layer by layer:
    over every axis that shards it but "model" where the rank computes
    with its "model" shard (``roles``), the inner axis first."""
    names = mesh.mesh_dim_names
    leaves = {}
    for (path, p), role, d in zip(tree_flatten_with_path(params),
                                  tree_leaves(roles),
                                  tree_leaves(ModelZoo(cfg).param_defs())):
        fsdp = d.spec.index("fsdp") if "fsdp" in d.spec else None
        if path[0] not in STACKED or fsdp is None or not any(
                pl.is_shard(fsdp) and names[i] in axes
                for i, pl in enumerate(p.placements)):
            continue
        keep = None
        if role is not None and role[0] == "split":
            keep = names.index("model")
            _model_placements(p, mesh, role[1])   # checks the placement
        steps = []
        for i in reversed(range(mesh.ndim)):
            pl = p.placements[i]
            if not pl.is_shard() or i == keep:
                continue
            if p.shape[pl.dim] % mesh.size(i):
                raise ValueError(f"{'/'.join(path)} of shape "
                                 f"{tuple(p.shape)} is sharded unevenly "
                                 f"over {names[i]!r}")
            steps.append(AxisGather(mesh.get_group(names[i]), mesh.size(i),
                                    mesh.get_local_rank(names[i]),
                                    pl.dim - p.ndim, names[i] in axes))
        ranges, group, size = None, None, 1
        if role is not None and role[0] == "slice":
            ranges = (role[1], role[2])
            group, size = mesh.get_group("model"), mesh.size(
                names.index("model"))
        shards = tuple(names[i] for i, pl in enumerate(p.placements)
                       if pl.is_shard())
        leaves[path] = LeafGather(shards, tuple(steps), ranges, group, size)
    return LayerGather(leaves) if leaves else None


@dataclasses.dataclass(frozen=True)
class _StepPlan:
    """How a step on a mesh computes with its parameters: this rank's
    ``TensorParallel`` (None where no compute splits,
    :func:`_tensor_parallel`), every leaf's role by path (None where
    none splits), and the ``LayerGather`` (None where no leaf is held as
    a shard, :func:`_layer_gather`)."""
    tp: Optional[TensorParallel]
    roles: dict
    fsdp: Optional[LayerGather]

    def held(self, path) -> Tuple[str, ...]:
        """The mesh axes the leaf at ``path`` is held sharded over, and
        its gradient comes out of backward sharded over; () for a leaf
        the step takes as its compute view."""
        return () if self.fsdp is None else self.fsdp.held(path)

    def work(self, params, mesh):
        """The tensors the step computes with: this rank's shard of a
        held leaf, every other leaf's compute view."""
        flat = tree_flatten_with_path(params)
        return tree_unflatten([path for path, _ in flat], [
            p.to_local() if self.held(path)
            else _compute_view(p, self.roles[path], mesh)
            for path, p in flat])


def _planner(cfg: ArchConfig) -> Callable:
    """``plan(mesh, params)``: the :class:`_StepPlan` of a step of
    ``cfg``, built once per mesh and placement of the parameters."""
    plans = {}

    def plan(mesh, params) -> _StepPlan:
        key = (mesh, tuple(p.placements for p in tree_leaves(params)))
        if key not in plans:
            tp, roles = _tensor_parallel(cfg, mesh, params)
            if roles is None:
                roles = tree_map(lambda p: None, params)
            plans[key] = _StepPlan(
                tp, dict(tree_flatten_with_path(roles)),
                _layer_gather(cfg, mesh, params, roles,
                              _batch_axes(cfg, mesh)))
        return plans[key]

    return plan


def _storage_shard(g, p, role, mesh):
    """This rank's shard, placed as ``p``, of the gradient ``g`` that the
    rank holds as its compute view (a local split, no communication)."""
    from torch.distributed.tensor import DTensor
    if role is not None and role[0] == "split":
        return DTensor.from_local(
            g, mesh, _model_placements(p, mesh, role[1]), run_check=False,
            shape=p.shape, stride=p.stride()).redistribute(
                mesh, p.placements).to_local()
    return _local_shard(g, mesh, p.placements)


def _mesh_step(mesh, cfg, plan, loss_and_grads, opt, params, opt_state,
               batch, step, lr_scale):
    """The train step on ``mesh`` (the module docstring's steps 1-5) by
    ``plan`` (:class:`_StepPlan`).
    Its metrics count the all-reduces it issues after backward:
    ``all_reduces`` over the batch axes (each gradient leaf over every
    batch axis that does not shard it, the loss, and the norm's one per
    axis that shards a layer-gathered leaf), ``model_all_reduces`` over
    "model" (each sliced leaf the step takes as its compute view, and
    the norm's); the layers' collectives and the layer gathers' are not
    counted."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    local = lambda t: t.to_local() if _is_dtensor(t) else t

    def like(t, ref):
        if not _is_dtensor(ref):
            return t
        return DTensor.from_local(t, ref.device_mesh, ref.placements,
                                  run_check=False, shape=ref.shape,
                                  stride=ref.stride())

    axes = _batch_axes(cfg, mesh)
    tp = plan.tp
    work = plan.work(params, mesh)
    local_batch = tree_map(lambda x: _batch_local(x, 0, axes, mesh), batch)
    loss, grads = loss_and_grads(work, local_batch, tp,
                                 _batch_split(cfg, batch, axes, mesh),
                                 plan.fsdp)
    del work
    n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    paths = [path for path, _ in tree_flatten_with_path(grads)]
    role_of = [plan.roles[path] for path in paths]
    held_of = [plan.held(path) for path in paths]
    shapes = [p.shape for p in tree_leaves(params)]
    reduced, reduces, model_reduces = [], 0, 0
    with torch.no_grad():
        for t, role, h, shape in zip(tree_leaves(grads) + [loss],
                                     role_of + [None], held_of + [()],
                                     shapes + [None]):
            if h:
                # a layer-gathered leaf: this rank's shard, already
                # summed over the axes that shard it
                t = t.contiguous()
                for axis in axes:
                    if axis not in h:
                        dist.all_reduce(t, group=mesh.get_group(axis))
                        reduces += 1
                reduced.append(t.div_(n_dp))
                continue
            if role is not None and role[0] == "slice":
                # the columns this rank read (the kv heads its q heads
                # read; a Mamba2 block's heads and share of B and C),
                # summed over "model"
                t = put_ranges(t, shape, role[1], role[2])
                dist.all_reduce(t, group=tp.group)
                model_reduces += 1
            t = t.contiguous()
            for axis in axes:
                dist.all_reduce(t, group=mesh.get_group(axis))
                reduces += 1
            reduced.append(t.div_(n_dp))
        loss = reduced.pop()
        # the global norm: each layer-gathered leaf's squared norm summed
        # over the batch axes that shard it (one all-reduce per axis),
        # then each split leaf's over "model" (one all-reduce), the sum
        # in tree order as global_norm
        sq = [torch.sum(g.float() ** 2) for g in reduced]
        names = mesh.mesh_dim_names
        for axis in axes:
            part_of = [i for i, h in enumerate(held_of) if axis in h]
            if part_of and mesh.size(names.index(axis)) > 1:
                part = torch.stack([sq[i] for i in part_of])
                dist.all_reduce(part, group=mesh.get_group(axis))
                reduces += 1
                for j, i in enumerate(part_of):
                    sq[i] = part[j]
        split = [i for i, (r, h) in enumerate(zip(role_of, held_of))
                 if (r is not None and r[0] == "split")
                 or ("model" in h and "model" not in axes)]
        if split and tp.size > 1:
            part = torch.stack([sq[i] for i in split])
            dist.all_reduce(part, group=tp.group)
            model_reduces += 1
            for j, i in enumerate(split):
                sq[i] = part[j]
        gnorm = torch.sqrt(sum(sq))
        shards = tree_unflatten(paths, [
            g if h else _storage_shard(g, p, r, mesh) for g, p, r, h in zip(
                reduced, tree_leaves(params), role_of, held_of)])
    del grads, reduced
    new_p, new_opt, gnorm = adamw_apply(
        shards, tree_map(local, opt_state), tree_map(local, params), opt,
        gnorm, lr_scale=lr_scale)
    new_p = tree_map(like, new_p, params)
    new_opt = tree_map(like, new_opt, opt_state)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": step + 1,
               "all_reduces": reduces, "model_all_reduces": model_reduces}
    return new_p, new_opt, metrics


def _cache_batch_dims(cfg: ArchConfig):
    """The batch dimension of every decode-cache leaf (its "dp" tag)."""
    return tree_map(lambda d: d.spec.index("dp"), cache_defs(cfg, 1, 1))


_KV_SEQ = 3    # a K/V cache's sequence dimension: (L, 2, B, S, Kh, hd)
_KV_KEYS = ("kv", "shared_kv", "cross_kv")   # the K/V caches' names


def _cache_placements(cfg: ArchConfig, mesh, key, shape) -> tuple:
    """Where the decode-cache leaf ``key`` (a name, "kv" or "shared_kv",
    or a path of names, ("mamba", "state")) of global ``shape`` lies on
    ``mesh``: ``cache_defs``' spec under the profile, fit to the shape
    (``abstract_serve_args``' placement, the reference's): the batch
    over the batch axes, a K/V cache's sequence over "model" where it
    divides S, a Mamba2 state's heads and conv tail's channels over
    "model" where it divides them, else replicated over "model"."""
    axes, use_tp, _ = _profile(cfg, dp_axes_of(mesh))
    d = cache_defs(cfg, 1, 1)
    for k in (key,) if isinstance(key, str) else key:
        d = d[k]
    spec = resolve_spec(d.spec, use_fsdp=False, dp_axes=axes, use_tp=use_tp)
    return spec_placements(fit_spec_to_shape(tuple(shape), spec, mesh), mesh)


def _seq_split(placements, mesh) -> bool:
    m = mesh.mesh_dim_names.index("model")
    return placements[m].is_shard(_KV_SEQ)


def _whole_over_model(placements, mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    m = mesh.mesh_dim_names.index("model")
    return tuple(Replicate() if i == m else p
                 for i, p in enumerate(placements))


def _whole_cache(path, tp: TensorParallel) -> bool:
    """Whether the split serving steps take and return the cache leaf at
    ``path`` whole over "model" (a Mamba2 block's conv tail, whose even
    shards of channels cut across a rank's; its state where the block is
    not split) rather than as this rank's shard."""
    return path[-1] == "conv" or (path[-1] == "state" and not tp.ssm)


def _cache_shards(cfg: ArchConfig, mesh, caches, tp: TensorParallel):
    """(this rank's part of every decode cache, the ``TensorParallel``
    of the split decode) for the split decode: its shard, or the leaf
    whole over "model" where :func:`_whole_cache` says (one all-gather);
    ``tp`` with ``kv_seq`` the slot count S where "model" splits the
    self-attention K/V caches' sequence and ``cross_seq`` the source's
    where it splits ``cross_kv``'s, else None.  A cache placed otherwise
    than :func:`_cache_placements` says raises: the split decode moves
    no K/V cache and no state."""
    flat = tree_flatten_with_path(caches)
    parts, seq = [], {}
    for path, c in flat:
        want = _cache_placements(cfg, mesh, path, c.shape)
        take = (_whole_over_model(want, mesh) if _whole_cache(path, tp)
                else want)
        if not _is_dtensor(c):
            parts.append(_local_shard(c, mesh, take))
        elif tuple(c.placements) != tuple(want):
            raise ValueError(
                f"decode cache {'/'.join(path)!r} of shape {tuple(c.shape)} "
                f"is placed as {tuple(c.placements)}; the split decode takes "
                f"it as {tuple(want)} (cache_defs + fit_spec_to_shape)")
        else:
            parts.append(c.redistribute(mesh, take).to_local())
        if path[-1] in _KV_KEYS and _seq_split(want, mesh):
            seq["cross_seq" if path[-1] == "cross_kv" else "kv_seq"] = \
                c.shape[_KV_SEQ]
    return (tree_unflatten([path for path, _ in flat], parts),
            dataclasses.replace(tp, kv_seq=seq.get("kv_seq"),
                                cross_seq=seq.get("cross_seq")))


def _prefill_kv_shards(c, tp: TensorParallel, cfg: ArchConfig,
                       seq_split: bool):
    """A prefill K/V cache, computed with this rank's kv heads (all of
    them where attention is gathered), as this rank's shard in the
    decode layout: every kv head, and the rank's slice of the sequence
    where ``seq_split``.  Heads split, sequence split: one all-to-all
    (rank j receives slice j of every rank's heads); heads split,
    sequence whole: one all-gather; heads whole: a local slice.  No rank
    holds the whole cache but where the layout replicates it."""
    import torch.distributed as dist
    from repro_torch.models.parallel import gather_kv_heads, join_kv_heads
    if tp.size == 1:
        return c
    if tp.attn == "gathered":
        return (c.chunk(tp.size, _KV_SEQ)[tp.rank].contiguous() if seq_split
                else c)
    if not seq_split:
        return gather_kv_heads(c, tp, cfg)
    send = [t.contiguous() for t in c.chunk(tp.size, _KV_SEQ)]
    parts = [torch.empty_like(t) for t in send]
    dist.all_to_all(parts, send, group=tp.group)
    return join_kv_heads(parts, tp, cfg)


def _cache_global(t, cfg: ArchConfig, mesh, path, shape,
                  tp: TensorParallel):
    """The DTensor of global ``shape``, placed by
    :func:`_cache_placements`, whose rank-local part is ``t``: its shard,
    or the leaf whole over "model" (:func:`_whole_cache`; a local
    slice)."""
    from torch.distributed.tensor import DTensor
    want = _cache_placements(cfg, mesh, path, shape)
    if _whole_cache(path, tp):
        return DTensor.from_local(t, mesh, _whole_over_model(want, mesh),
                                  run_check=False).redistribute(mesh, want)
    return DTensor.from_local(t, mesh, want, run_check=False)


def _mesh_serve(mesh, cfg, plan, call, params, batch, caches=None):
    """``call`` (the zoo's ``prefill`` or ``decode``) on a mesh by
    ``plan`` (:class:`_StepPlan`): this
    rank's slice of the batch, the logits as a DTensor sharded on the
    batch.  Under the ``tp`` profile both split over "model" as the
    train step does (``_tensor_parallel``) and the caches go in and out
    placed as ``cache_defs`` + ``fit_spec_to_shape`` say, each leaf by
    its own global shape (the encoder-decoder's ``cross_kv`` by the
    source's length): decode reads and writes each rank's shard of the
    K/V caches (``kv``, the hybrid's ``shared_kv``; it reads
    ``cross_kv`` and writes none) and the Mamba2 states and moves
    neither (a conv tail comes in whole over "model": one all-gather);
    prefill turns its per-rank kv heads into that layout
    (:func:`_prefill_kv_shards`), and its states are each rank's heads.
    Otherwise (other profiles) the parameters are gathered and the
    caches go in and out as each rank's slice of the batch.  Under any
    profile the FSDP-stored stacked leaves stay this rank's shards, each
    layer's slice gathered in the layer loop (:func:`_layer_gather`)."""
    axes = _batch_axes(cfg, mesh)
    dims = _cache_batch_dims(cfg)
    tp, fsdp, work = plan.tp, plan.fsdp, plan.work(params, mesh)
    b = next(iter(batch.values())).shape[0]
    local_batch = tree_map(lambda x: _batch_local(x, 0, axes, mesh), batch)
    split = _batch_split(cfg, batch, axes, mesh)
    if tp is None:
        if caches is None:
            logits, new_caches = call(work, local_batch, batch_split=split,
                                      fsdp=fsdp)
        else:
            logits, new_caches = call(work, tree_map(
                lambda c, d: _batch_local(c, d, axes, mesh), caches, dims),
                local_batch, batch_split=split, fsdp=fsdp)
        del work
        return (_batch_global(logits, 0, axes, mesh, b),
                tree_map(lambda c, d: _batch_global(c, d, axes, mesh, b),
                         new_caches, dims))
    if caches is None:
        logits, new_caches = call(work, local_batch, tp, split, fsdp)
        shapes = _prefill_cache_shapes(cfg, batch, b)
        for k in _KV_KEYS:
            if k in new_caches:
                seq_split = _seq_split(_cache_placements(
                    cfg, mesh, k, shapes[(k,)]), mesh)
                new_caches[k] = _prefill_kv_shards(new_caches[k], tp, cfg,
                                                   seq_split)
    else:
        shards, tp = _cache_shards(cfg, mesh, caches, tp)
        shapes = {path: c.shape for path, c in tree_flatten_with_path(caches)}
        logits, new_caches = call(work, shards, local_batch, tp, split, fsdp)
    del work
    flat = tree_flatten_with_path(new_caches)
    return (_batch_global(logits, 0, axes, mesh, b),
            tree_unflatten([path for path, _ in flat], [
                _cache_global(t, cfg, mesh, path, shapes[path], tp)
                for path, t in flat]))


def _prefill_cache_shapes(cfg: ArchConfig, batch, b: int) -> dict:
    """The global shape of every cache leaf a prefill of ``batch``
    returns, by path: ``cache_defs`` at the prompt's length, the
    encoder-decoder's ``cross_kv`` at the source's."""
    shapes = dict(tree_flatten_with_path(tree_map(
        lambda d: d.shape, cache_defs(cfg, b, batch["tokens"].shape[1]))))
    if ("cross_kv",) in shapes:
        shapes[("cross_kv",)] = cache_defs(
            cfg, b, batch["src_embeds"].shape[1])["cross_kv"].shape
    return shapes


def widen_mesh_caches(cfg: ArchConfig, caches: dict) -> dict:
    """``models.widen_caches`` for caches on a mesh (DTensors, as the
    serving steps return them): one empty slot appended to every
    self-attention K/V cache (the encoder-decoder's ``cross_kv`` keeps
    its length and its placement), the result placed by
    :func:`_cache_placements` for its new length.  What moves: where
    "model" splits the sequence, the cache is first gathered over
    "model" (an all-gather: every rank then holds its batch slice of
    the whole cache, and the pad makes a second copy of it; padding a
    split dimension would misplace the slot), then split again by a
    local slice where "model" divides the new length.  After a one-slot
    widen of a split cache it does not, and the cache stays replicated
    over "model", as the reference's ``in_shardings`` place it: so a
    chain of decode steps holds each rank's batch slice of the whole
    cache on every step but those whose length "model" divides."""
    from torch.distributed.tensor import DTensor, Replicate
    out = dict(caches)
    for key in ("kv", "shared_kv"):
        if key not in out:
            continue
        c = out[key]
        mesh = c.device_mesh
        whole = [Replicate() if p.is_shard(_KV_SEQ) else p
                 for p in c.placements]
        local = torch.nn.functional.pad(
            c.redistribute(mesh, whole).to_local(), (0, 0, 0, 0, 0, 1))
        shape = list(c.shape)
        shape[_KV_SEQ] += 1
        out[key] = DTensor.from_local(local, mesh, whole,
                                      run_check=False).redistribute(
            mesh, _cache_placements(cfg, mesh, key, shape))
    return out


def make_prefill_step(cfg: ArchConfig):
    zoo = ModelZoo(cfg)
    plan = _planner(cfg)

    def prefill_step(params, batch):
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_serve(mesh, cfg, plan(mesh, params), zoo.prefill,
                               params, batch)
        return zoo.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    zoo = ModelZoo(cfg)
    plan = _planner(cfg)

    def decode_step(params, caches, batch):
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_serve(mesh, cfg, plan(mesh, params), zoo.decode,
                               params, batch, caches)
        return zoo.decode(params, caches, batch)

    return decode_step


# ------------------------------------------------- abstract argument trees

def _profile(cfg: ArchConfig, dp_axes: Tuple[str, ...]):
    """(dp_axes, use_tp, fsdp_axes) for the arch's sharding profile.

    'tp'    — baseline: TP over model (+ FSDP over data for big archs).
    'dp'    — replicate weights; model axis becomes extra batch (small archs).
    'zero3' — no TP; weights/opt fully sharded over (data, model); batch over
              every axis (tests the FSDP-vs-TP collective tradeoff).
    """
    if cfg.sharding_profile == "dp":
        return tuple(dp_axes) + ("model",), False, ()
    if cfg.sharding_profile == "zero3":
        return tuple(dp_axes) + ("model",), False, ("data", "model")
    return tuple(dp_axes), True, None


def _input_abstract(inp_defs, mesh, dp_axes, device=None):
    """The inputs as fake tensors, the batch dimension over ``dp_axes``."""
    return abstract(inp_defs, None, mesh, use_fsdp=False, dp_axes=dp_axes,
                    device=device)


def _scalar(mesh, device):
    """A fake 0-d int32 (replicated on a mesh)."""
    if mesh is None:
        return torch.zeros((), dtype=torch.int32,
                           device=resolve_device(device))
    return fake_dtensor((), torch.int32, mesh, ())


def _abstract_params(cfg, dtype, mesh, dp_axes, device):
    dp_axes, use_tp, fsdp_axes = _profile(cfg, dp_axes)
    return abstract(ModelZoo(cfg).param_defs(), dtype, mesh,
                    use_fsdp=use_fsdp(cfg), dp_axes=dp_axes, use_tp=use_tp,
                    fsdp_axes=fsdp_axes, device=device)


def abstract_train_args(cfg: ArchConfig, shape: ShapeSpec, mesh,
                        dp_axes: Tuple[str, ...], device=None):
    """(params, opt_state, batch, step) as fake tensors, inside an active
    ``FakeTensorMode``: fake DTensors placed as the reference's
    ``NamedSharding``s on ``mesh``, or plain fake tensors on ``device``
    (None: the card) with no mesh."""
    zoo = ModelZoo(cfg)
    params = _abstract_params(cfg, dtype_of(cfg.param_dtype), mesh, dp_axes,
                              device)
    mom = lambda: _abstract_params(cfg, dtype_of(cfg.opt_moment_dtype), mesh,
                                   dp_axes, device)
    opt_state = {"mu": mom(), "nu": mom(), "count": _scalar(mesh, device)}
    batch = _input_abstract(zoo.input_defs(shape), mesh,
                            _profile(cfg, dp_axes)[0], device)
    return params, opt_state, batch, _scalar(mesh, device)


def abstract_serve_args(cfg: ArchConfig, shape: ShapeSpec, mesh,
                        dp_axes: Tuple[str, ...], device=None):
    """(params, caches, batch) for decode; (params, batch) for prefill;
    as :func:`abstract_train_args`.  K/V caches in ``kv_cache_dtype``;
    SSM states are recurrent accumulators and stay bf16."""
    zoo = ModelZoo(cfg)
    params = _abstract_params(cfg, dtype_of(cfg.param_dtype), mesh, dp_axes,
                              device)
    dp_axes, use_tp, _ = _profile(cfg, dp_axes)
    batch = _input_abstract(zoo.input_defs(shape), mesh, dp_axes, device)
    if shape.kind == "prefill":
        return params, batch
    kv_dt = {"bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn}[cfg.kv_cache_dtype]
    caches = {
        k: abstract(v, kv_dt if k in ("kv", "shared_kv", "cross_kv")
                    else torch.bfloat16, mesh, use_fsdp=False,
                    dp_axes=dp_axes, use_tp=use_tp, device=device)
        for k, v in zoo.cache_defs(shape).items()}
    return params, caches, batch


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
