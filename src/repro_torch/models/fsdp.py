"""Stacked layer weights held sharded over the batch axes through a step
(the port's counterpart of the reference's ``lax.scan`` over FSDP-sharded
stacked leaves, which GSPMD partitions so that no step holds the model
gathered whole).

On a mesh, a stacked leaf (``layers``, a hybrid's ``groups`` and
``tail``, an encoder-decoder's ``encoder`` and ``decoder``) whose
``"fsdp"`` dimension is stored sharded over a batch axis of the step
reaches the layer loops (``models.transformer``) as this rank's shard.
Inside each layer's body — under the layer's checkpoint, so that its
recompute gathers again — :class:`LayerGather` turns the layer's slice
of the shard into the tensor the layer computes with:

* forward: one all-gather per mesh axis that shards the leaf, the inner
  axis first (the row-major layout of a dimension split over several
  axes), but "model" where the rank computes with its "model" shard
  (``models.parallel.leaf_roles``: ``("split", dim)``); then, for a
  ``("slice", dim, ranges)`` leaf, the column ranges the rank computes
  with, concatenated;
* backward: the reverse.  A slice leaf's gradient is scattered into the
  whole leaf and summed over "model" (one all-reduce); then, axis by
  axis, the outer first, a reduce-scatter where the axis is a batch axis
  (each rank's gradient is its batch's: summed over the axis, this
  rank's part kept) and this rank's part alone where it is not ("model"
  under tensor-parallel compute, whose ranks hold one gradient).

So a layer's gradient reaches the stacked leaf's gradient as this
rank's shard, summed over the axes that shard it: the step then
all-reduces it over the other batch axes only.  A group of one issues
no collective: on one rank the gathered tensor is the shard itself, and
the step the plain step bit for bit.  ``GATHER_COUNT["layers"]`` counts
the layer slices gathered (forward and recompute).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["AxisGather", "LeafGather", "LayerGather", "GATHER_COUNT",
           "STACKED", "take_ranges", "put_ranges", "held_view_bytes"]

# the parameter trees whose leaves stack layers on their leading axes
STACKED = ("layers", "groups", "tail", "encoder", "decoder")

GATHER_COUNT = {"layers": 0}


@dataclasses.dataclass(frozen=True)
class AxisGather:
    """One mesh axis that shards a stacked leaf: its process group, size
    and this rank's index on it; ``dim`` the sharded dimension, counted
    from the end (so that it names the same dimension of a layer's slice
    as of the stack); ``reduce``: whether the axis splits the batch
    (backward sums over it) or not (its ranks hold one gradient)."""
    group: Any
    size: int
    rank: int
    dim: int
    reduce: bool


@dataclasses.dataclass(frozen=True)
class LeafGather:
    """How a layer's slice of one leaf becomes the tensor its layer
    computes with: ``shards`` the names of the mesh axes that shard the
    stored leaf (its gradient comes out of backward sharded over them);
    ``axes`` in gather order (inner mesh axis first); ``ranges``
    ``(dim, ((start, stop), ...))`` for a slice leaf, else None;
    ``sum_group`` / ``sum_size`` the "model" group a slice leaf's
    gradient is summed over."""
    shards: Tuple[str, ...]
    axes: Tuple[AxisGather, ...]
    ranges: Optional[Tuple[int, tuple]] = None
    sum_group: Any = None
    sum_size: int = 1


def _all_gather(x: torch.Tensor, ax: AxisGather) -> torch.Tensor:
    import torch.distributed as dist
    if ax.size == 1:
        return x
    x = x.movedim(ax.dim, 0).contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=ax.group)
    return out.movedim(0, ax.dim).contiguous()


def _reduce_scatter(g: torch.Tensor, ax: AxisGather) -> torch.Tensor:
    import torch.distributed as dist
    if ax.size == 1:
        return g
    g = g.movedim(ax.dim, 0).contiguous()
    out = g.new_empty((g.shape[0] // ax.size,) + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g, group=ax.group)
    return out.movedim(0, ax.dim)


def take_ranges(x: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """``x``'s column ranges ``((start, stop), ...)`` along ``dim``,
    concatenated in order (a view where there is one)."""
    parts = [x.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def put_ranges(g: torch.Tensor, shape, dim: int, ranges) -> torch.Tensor:
    """The tensor of ``shape``, zero but for ``g`` (as
    :func:`take_ranges` took it) in its column ranges."""
    full, at = g.new_zeros(shape), 0
    for lo, hi in ranges:
        full.narrow(dim, lo, hi - lo).copy_(g.narrow(dim, at, hi - lo))
        at += hi - lo
    return full


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan: LeafGather):
        ctx.plan = plan
        for ax in plan.axes:
            x = _all_gather(x, ax)
        if plan.ranges is not None:
            ctx.whole = x.shape
            x = take_ranges(x, *plan.ranges)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        plan = ctx.plan
        if plan.ranges is not None:
            g = put_ranges(g, ctx.whole, *plan.ranges)
            if plan.sum_size > 1:
                dist.all_reduce(g, group=plan.sum_group)
        for ax in reversed(plan.axes):
            if ax.reduce:
                g = _reduce_scatter(g, ax)
            else:
                n = g.shape[ax.dim] // ax.size
                g = g.narrow(ax.dim, ax.rank * n, n)
        return g, None


@dataclasses.dataclass(frozen=True)
class LayerGather:
    """The stacked leaves a step holds as this rank's shards, by path
    (``("layers", "attn", "wq")``), each with its :class:`LeafGather`."""
    leaves: Dict[Tuple[str, ...], LeafGather]

    def held(self, path: Tuple[str, ...]) -> Tuple[str, ...]:
        """The mesh axes the leaf at ``path`` is held sharded over
        through the step (its ``shards``); () for a leaf the step takes
        as its compute view."""
        leaf = self.leaves.get(path)
        return () if leaf is None else leaf.shards

    def at(self, key: str):
        """The gather of one layer's slice of the stack ``key``
        (``"layers"``, ``"groups"``, ...): a function from that layer's
        tree of shards to the tree it computes with; None where no leaf
        of the stack is held sharded."""
        plans = {p[1:]: g for p, g in self.leaves.items() if p[0] == key}
        if not plans:
            return None

        def gather(tree, path=()):
            if isinstance(tree, dict):
                return {k: gather(v, path + (k,)) for k, v in tree.items()}
            plan = plans.get(path)
            return tree if plan is None else _GatherLeaf.apply(tree, plan)

        def gather_layer(tree):
            GATHER_COUNT["layers"] += 1
            return gather(tree)

        return gather_layer


def held_view_bytes(cfg, model: int) -> dict:
    """The stacked leaves an FSDP step of ``cfg`` on ``model`` "model"
    ranks holds as shards (every ``"fsdp"``-tagged leaf under
    :data:`STACKED`) and their compute views on one rank (its "model"
    shard of a split leaf, the whole of a gathered one, the column
    ranges of a sliced one; ``models.parallel.leaf_roles``) in the
    parameters' dtype: ``leaves``, the number of such leaves;
    ``slices``, the layer slices of them all (a hybrid's group counted
    by its layers); ``bytes``, all layers' views; ``unit_bytes``, one
    layer's (or hybrid group's) views of the largest stack."""
    import math
    from repro_torch._tree import tree_flatten_with_path, tree_leaves
    from repro_torch.models import ModelZoo
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.parallel import leaf_roles
    defs = ModelZoo(cfg).param_defs()
    size = dtype_of(cfg.param_dtype).itemsize
    leaves, slices, total, units = 0, 0, 0, {}
    for (path, d), role in zip(tree_flatten_with_path(defs),
                               tree_leaves(leaf_roles(cfg, defs, model, 0))):
        if path[0] not in STACKED or "fsdp" not in d.spec:
            continue
        n = math.prod(d.shape) * size
        if role[0] == "split":
            n //= model
        elif role[0] == "slice":
            n = n * sum(hi - lo for lo, hi in role[2]) // d.shape[role[1]]
        leaves += 1
        slices += math.prod(d.shape[:2 if path[0] == "groups" else 1])
        total += n
        units[path[0]] = units.get(path[0], 0) + n // d.shape[0]
    return dict(leaves=leaves, slices=slices, bytes=total,
                unit_bytes=max(units.values(), default=0))
