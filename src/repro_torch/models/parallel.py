"""Tensor-parallel compute over the "model" mesh axis (the port's
counterpart of GSPMD partitioning the reference's jitted step over the
leaves that ``pspec_tree`` tags "model", and its decode over the K/V
caches that ``cache_defs`` splits on the sequence).

Every family's layers (the VLM's blocks are the dense blocks; the
MoE's attention, embedding and head too, the SSM's embedding and head,
the hybrid's shared attention block and Mamba2 layers the dense and SSM
blocks, and the encoder-decoder's encoder and decoder blocks the dense
blocks) take their "model"-tagged weights as each rank's shard and add
the collectives that make the result the plain one, on the "model"
process group (explicit ``torch.distributed`` calls; DTensor has no
rules for attention's einsums, the checkpoints or the chunked loss):

* attention: ``wq`` / ``wk`` / ``wv`` column-parallel by whole heads,
  each rank attending over its own heads, ``wo`` row-parallel and one
  all-reduce.  Where "model" does not divide the kv heads but does the
  q heads (llama3-8b's 8 kv heads on 16 ranks), each rank computes the
  kv heads its q heads read from the gathered ``wk`` / ``wv``
  (``"kv_slice"``); where it does not divide the q heads (smollm-135m's
  9), the block stays gathered;
* the MLP: ``w1`` / ``w3`` column-parallel, ``w2`` row-parallel, one
  all-reduce;
* the MoE block (``models.moe``): the experts split across the ranks
  (rank r computes experts [r·E/size, (r+1)·E/size) of the padded E),
  the shared and dense-residual MLPs column / row-parallel, one
  all-reduce of the block's summed partial output.  Routing stays whole
  on every rank, so every rank routes alike; the gates reach the
  combine through :func:`copy_to_model` (each rank combines only its
  experts, so their gradient is summed over the group), the router's
  input and the load-balance term do not;
* the Mamba2 block (``models.mamba2``): the heads split across the
  ranks (rank r computes heads [r·H/size, (r+1)·H/size)).  Each rank
  computes its heads' z, x and dt columns of ``in_proj`` and its share
  of the B and C columns (both read by every head), which one
  all-gather makes whole after the projection (:func:`gather_to_model`:
  the gradient summed over the group, then this rank's share); the
  causal conv runs on the rank's x channels and on the whole B and C,
  the SSD scan on the rank's heads (the head-independent ``C·Bᵀ`` whole
  on every rank); the gated RMSNorm's Σy² over d_inner is all-reduced
  (:func:`sum_over_model`: its gradient all-reduced too), and
  ``out_proj`` is row-parallel with one all-reduce.  The reference's
  "model" shards of ``in_proj`` (the fused [z | x | B | C | dt]
  columns) and of the conv (its [x | B | C] channels) are even splits
  that cut across those bounds, so a rank gathers these leaves and
  selects its column ranges (``("slice", dim, ranges)``);
* the hybrid's shared attention block (zamba2): ``w_in`` column-parallel
  on its output d, then one all-gather along d (as the embedding), its
  attention and MLP the dense blocks above; its weights serve every
  group, so their gradient sums the groups' on each rank's shard;
* the encoder-decoder's cross-attention (``xattn``): split as attention
  above, q from the decoder's stream and k / v from the encoder's
  output, each through :func:`copy_to_model` (the encoder's output
  feeds every decoder layer, so its gradient is summed over the group
  in each);
* the embedding (split on d): each rank looks up its slice of d, then an
  all-gather along d;
* the head: untied and split on the vocabulary, a vocabulary-parallel
  cross-entropy (the max and the sum of exponentials all-reduced, the
  gold logit from the rank that owns it) and logits gathered over the
  vocabulary; tied (``embed.T``, split on d), row-parallel with the
  logits all-reduced;
* decode (no backward): each rank holds its slice of every K/V cache's
  S slots (``TensorParallel.kv_seq``), computes the new token's q, k
  and v for every head (column-parallel where attention splits, then an
  all-gather along the heads: :func:`gather_from_model`,
  :func:`gather_kv_heads`), and attends over its slots with
  flash-decoding's combine (``attention.decode_attention_split``: the
  max, the sum of exponentials and the partial outputs all-reduced by
  :func:`model_all_reduce`); only the rank that holds slot S-1 writes
  it.  ``wo``, the MLP, the embedding and the head split as above.
  The Mamba2 block's decode reads and writes this rank's heads of the
  state cache; its conv tail comes in and goes out whole over the
  group, and the new token's raw [x | B | C] channels are made whole by
  one all-gather.  The hybrid's ``shared_kv`` caches are K/V caches as
  above (each rank's slice of the sequence), its Mamba2 states and conv
  tails (groups and tail) the SSM family's.  The encoder-decoder's
  ``cross_kv`` is read, never written: each rank attends over its slice
  of the source's sequence (``TensorParallel.cross_seq``) with the same
  combine, q gathered along the heads as above.

The collectives carry gradients in pairs (Megatron-LM's f and g):
:func:`copy_to_model` is the identity forward and an all-reduce
backward, :func:`reduce_from_model` an all-reduce forward and the
identity backward, :func:`gather_from_model` an all-gather forward and
this rank's slice backward.  Where every rank reads the gathered
tensor with its own heads, its gradient differs from rank to rank:
:func:`gather_to_model` sums it over the group before the slice, and
:func:`sum_over_model` (a sum every rank's slice reads) all-reduces both
ways.  Activations and their gradients between
the split blocks are the same on every rank of the group, so a
checkpoint's recompute issues the same collectives in the same order on
every rank.  No sum uses atomics.  A group of one rank issues no
collective (a sum over one rank is its input): every operation is then
the plain path's, and the result the plain one bit for bit
(:func:`vocab_logsumexp` is ``torch.logsumexp``'s arithmetic on any
group).

:func:`tp_layout` decides, per architecture and group size, which blocks
split; :func:`leaf_roles` says, per parameter leaf, whether the step
hands it over as its "model" shard (``("split", dim)``), gathered
(``("gathered",)``) or gathered and sliced to the column ranges this
rank computes with, concatenated in order (``("slice", dim, ((start,
stop), ...))``: the kv heads its q heads read, or a Mamba2 block's
heads and its share of B and C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch._tree import tree_flatten_with_path, tree_unflatten

__all__ = ["TensorParallel", "BatchSplit", "tp_layout", "leaf_roles",
           "gathered_leaves", "copy_to_model", "reduce_from_model",
           "gather_from_model", "gather_to_model", "sum_over_model",
           "gather_from_batch", "model_all_reduce", "gather_kv_heads",
           "join_kv_heads", "vocab_logsumexp", "vocab_gold",
           "kv_head_range", "ssm_column_ranges"]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The "model" group a step splits over, and what it splits.

    ``attn``: "split", "kv_slice" or "gathered"; ``mlp`` / ``embed``:
    split or not; ``head``: "vocab" (untied, split on the vocabulary),
    "rows" (tied ``embed.T``, split on d) or None (gathered).  The MoE
    block's ``experts`` / ``shared`` / ``dense``: the routed experts,
    the shared MLP and the dense-residual MLP split or not.  ``ssm``:
    the Mamba2 blocks split on their heads or not.  ``embed`` also
    splits the hybrid's shared ``w_in`` on its output d (the same
    condition: "model" divides d).  ``kv_seq`` (decode only): the slot
    count S of the self-attention K/V caches where each rank holds its
    even share of the S slots, rank r slots
    [r·S/size, (r+1)·S/size); None where every rank holds whole
    caches.  ``cross_seq`` (decode only): the same for the
    encoder-decoder's ``cross_kv``, whose length is the source's and
    which ``widen_mesh_caches`` leaves as it is, so that it can lie
    split while the self cache lies whole."""
    group: Any
    size: int
    rank: int
    attn: str
    mlp: bool
    embed: bool
    head: Optional[str]
    experts: bool = False
    shared: bool = False
    dense: bool = False
    ssm: bool = False
    kv_seq: Optional[int] = None
    cross_seq: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """The data ranks a step split its batch over, for the MoE block's
    token groups (``models.moe``): ``groups`` / ``sizes`` the process
    groups and sizes of the mesh axes that split the batch dimension,
    outer first; ``index`` this rank's position among their
    ``ranks`` ranks, row-major, which is the order of the batch's
    slices."""
    groups: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    index: int

    @property
    def ranks(self) -> int:
        return math.prod(self.sizes)


def tp_layout(cfg, size: int) -> dict:
    """Which blocks of ``cfg`` split over a "model" group of ``size``
    ranks.  The dense, VLM, MoE and encoder-decoder families' attention (the encoder-decoder's
    self-attention and cross-attention alike), embedding and head are
    the dense ones, and the encoder-decoder's MLPs the dense MLP.  The
    MoE family has no MLP block; its experts split where ``size`` divides the
    padded expert count, its shared and dense-residual MLPs where it
    divides their width.  The SSM family has neither attention nor MLP;
    its Mamba2 blocks split where ``size`` divides the heads and the
    state size N (each rank's share of B and C).  The hybrid family
    (zamba2) has both parts: its shared block's attention and MLP split
    as the dense family's, its ``w_in`` with the embedding (where
    ``size`` divides d), and its Mamba2 layers as the SSM family's."""
    embed = cfg.d_model % size == 0
    if cfg.tie_embeddings:
        head = "rows" if embed else None
    else:
        head = "vocab" if cfg.padded_vocab() % size == 0 else None
    if cfg.family in ("ssm", "hybrid"):
        from .mamba2 import ssm_dims
        ssm = ssm_dims(cfg)[1] % size == 0 and cfg.ssm_state % size == 0
    if cfg.family == "ssm":
        return dict(attn="gathered", mlp=False, embed=embed, head=head,
                    ssm=ssm)
    h, kh = cfg.num_heads, cfg.num_kv_heads
    attn = "gathered"
    if h % size == 0:
        local, group = h // size, h // kh
        if kh % size == 0:
            attn = "split"
        elif group % local == 0:
            attn = "kv_slice"
    if cfg.family == "hybrid":
        return dict(attn=attn, mlp=cfg.d_ff % size == 0, embed=embed,
                    head=head, ssm=ssm)
    if cfg.family != "moe":
        return dict(attn=attn, mlp=cfg.d_ff % size == 0, embed=embed,
                    head=head)
    from .moe import padded_experts
    shared = cfg.d_ff * cfg.num_shared_experts
    dense = cfg.d_ff_dense or cfg.d_ff
    return dict(attn=attn, mlp=False, embed=embed, head=head,
                experts=padded_experts(cfg.num_experts) % size == 0,
                shared=bool(shared) and shared % size == 0,
                dense=cfg.moe_dense_residual and dense % size == 0)


def kv_head_range(cfg, size: int, rank: int) -> Tuple[int, int]:
    """The kv heads [start, stop) that this rank's q heads read."""
    local = cfg.num_heads // size
    group = cfg.num_heads // cfg.num_kv_heads
    return (rank * local) // group, ((rank + 1) * local - 1) // group + 1


def ssm_column_ranges(cfg, size: int, rank: int) -> dict:
    """The column ranges [start, stop) of the Mamba2 block's fused
    leaves that rank ``rank`` of ``size`` computes with, in order:
    ``"in_proj"`` (its [z | x | B | C | dt] columns: its heads' z, x and
    dt, its 1/size of B and of C) and ``"conv"`` (the conv's [x | B | C]
    channels: its heads' x and the whole B and C), adjacent ranges
    merged."""
    from .mamba2 import ssm_dims
    d_inner, nheads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    part = lambda w, base=0: (base + rank * w // size,
                              base + (rank + 1) * w // size)
    return {"in_proj": _merged([part(d_inner), part(d_inner, d_inner),
                                part(n, 2 * d_inner),
                                part(n, 2 * d_inner + n),
                                part(nheads, 2 * d_inner + 2 * n)]),
            "conv": _merged([part(d_inner), (d_inner, d_inner + 2 * n)])}


def _merged(ranges) -> tuple:
    out = []
    for lo, hi in ranges:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return tuple(out)


def _slice_role(dim: int, ranges: tuple, width: int):
    """``("slice", dim, ranges)``; a rank's "model" shard where the
    ranges are the whole leaf (a group of one)."""
    return ("split", dim) if ranges == ((0, width),) else ("slice", dim,
                                                           ranges)


def _leaf_role(path: Tuple[str, ...], cfg, layout: dict, size: int,
               rank: int):
    name = path[-1]
    if path == ("embed",):
        return ("split", -1) if layout["embed"] else ("gathered",)
    if path == ("head",):
        return ("split", -1) if layout["head"] == "vocab" else ("gathered",)
    if path == ("shared_attn", "w_in"):
        return ("split", -1) if layout["embed"] else ("gathered",)
    block = path[-2] if len(path) > 1 else None
    if block in ("attn", "xattn") and layout["attn"] != "gathered":
        if name == "wq":
            return ("split", -1)
        if name == "wo":
            return ("split", -2)
        if layout["attn"] == "split":
            return ("split", -1)
        lo, hi = kv_head_range(cfg, size, rank)
        return ("slice", -1, ((lo * cfg.head_dim, hi * cfg.head_dim),))
    if block == "mlp" and layout["mlp"]:
        return ("split", -2) if name == "w2" else ("split", -1)
    if block == "moe":
        if name in ("w1", "w3", "w2"):   # (L, E, ., .): experts at -3
            return ("split", -3) if layout["experts"] else ("gathered",)
        kind, _, w = name.partition("_")  # shared_w1, dense_w2, ...
        if kind in ("shared", "dense") and layout[kind]:
            return ("split", -2) if w == "w2" else ("split", -1)
    if block == "mamba" and layout.get("ssm"):
        if name == "out_proj":
            return ("split", -2)
        if name in ("in_proj", "conv_w", "conv_b"):
            from .mamba2 import ssm_dims
            d_inner, nheads, conv_dim = ssm_dims(cfg)
            key, width = (("in_proj", conv_dim + d_inner + nheads)
                          if name == "in_proj" else ("conv", conv_dim))
            return _slice_role(-1, ssm_column_ranges(cfg, size, rank)[key],
                               width)
        return ("split", -1)   # A_log, D, dt_bias, norm_g: by heads
    return ("gathered",)


def leaf_roles(cfg, defs, size: int, rank: int) -> Any:
    """The role of every leaf of the ``ParamDef`` tree ``defs`` on rank
    ``rank`` of a "model" group of ``size`` (see the module docstring)."""
    layout = tp_layout(cfg, size)
    flat = tree_flatten_with_path(defs)
    return tree_unflatten([p for p, _ in flat],
                          [_leaf_role(p, cfg, layout, size, rank)
                           for p, _ in flat])


def gathered_leaves(cfg, defs, size: int) -> List[dict]:
    """The leaves that ``pspec_tree`` tags "model" but that a split step
    computes gathered (whole, or sliced to the kv heads a rank reads or
    to a Mamba2 block's columns: a hybrid's groups and tail alike), each
    with the reason: what the dry run names.  Decode computes the new
    token's projections with them so, and still attends over each rank's
    slice of the caches' sequence."""
    layout = tp_layout(cfg, size)
    out = []
    for path, d in tree_flatten_with_path(defs):
        if "model" not in d.spec:
            continue
        role = _leaf_role(path, cfg, layout, size, 0)
        if role[0] == "split":
            continue
        if path[-2:-1] in (("attn",), ("xattn",)) and role[0] == "slice":
            why = (f"{cfg.num_kv_heads} kv heads on {size} ranks: each rank "
                   "computes the kv heads its q heads read")
        elif path[-2:-1] in (("attn",), ("xattn",)):
            why = f"{cfg.num_heads} q heads on {size} ranks"
        elif path[-2:-1] == ("mlp",):
            why = f"d_ff {cfg.d_ff} on {size} ranks"
        elif path[-2:-1] == ("moe",) and path[-1] in ("w1", "w3", "w2"):
            from .moe import padded_experts
            why = (f"{padded_experts(cfg.num_experts)} padded experts on "
                   f"{size} ranks")
        elif path[-1].startswith("shared_"):
            why = (f"shared MLP width {cfg.d_ff * cfg.num_shared_experts} "
                   f"on {size} ranks")
        elif path[-1].startswith("dense_"):
            why = (f"dense residual width {cfg.d_ff_dense or cfg.d_ff} on "
                   f"{size} ranks")
        elif path[-2:-1] == ("mamba",):
            from .mamba2 import ssm_dims
            d_inner, nheads, conv_dim = ssm_dims(cfg)
            if role[0] != "slice":
                why = (f"{nheads} heads and state size {cfg.ssm_state} on "
                       f"{size} ranks")
            elif path[-1] == "in_proj":
                why = (f"'model' splits the {conv_dim + d_inner + nheads} "
                       "[z | x | B | C | dt] columns evenly, across their "
                       "bounds: each rank computes its heads' z, x and dt "
                       f"and 1/{size} of B and C")
            else:
                why = (f"'model' splits the {conv_dim} [x | B | C] channels "
                       "evenly, across their bounds: each rank convolves "
                       "its heads' x and the whole B and C")
        elif path == ("head",):
            why = f"padded vocabulary {cfg.padded_vocab()} on {size} ranks"
        else:
            why = f"d_model {cfg.d_model} on {size} ranks"
        out.append(dict(leaf="/".join(path), role=role[0], reason=why))
    return out


# ------------------------------------------------ collectives with gradients

def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """A contiguous copy of ``t`` all-reduced over ``group``."""
    import torch.distributed as dist
    out = t.clone(memory_format=torch.contiguous_format)
    if op is None:
        dist.all_reduce(out, group=group)
    else:
        dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        import torch.distributed as dist
        dim = dim % x.dim()
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n),
                None, None, None, None)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the group."""
    if tp.size == 1:
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the group; the gradient passed through."""
    if tp.size == 1:
        return x
    return _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, dim: int,
                      tp: TensorParallel) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient's slice of this rank."""
    if tp.size == 1:
        return x
    return _GatherFromModel.apply(x, dim, tp.group, tp.size, tp.rank)


def gather_to_model(x: torch.Tensor, dim: int,
                    tp: TensorParallel) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, for
    every rank to read with its own heads: the gradient summed over the
    group (each rank's differs), then this rank's slice."""
    return copy_to_model(gather_from_model(x, dim, tp), tp)


def sum_over_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the group of a partial sum that every rank's slice
    reads (the gated RMSNorm's Σy²): the gradient summed over the group
    too."""
    if tp.size == 1:
        return x
    return _SumOverModel.apply(x, tp.group)


def gather_from_batch(x: torch.Tensor, split: BatchSplit) -> torch.Tensor:
    """``x`` of every rank of ``split``, stacked on a new first dimension
    in the ranks' order: one all-gather per batch axis, the inner axis
    first.  No gradient."""
    import torch.distributed as dist
    out = x[None]
    for group, size in reversed(list(zip(split.groups, split.sizes))):
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, 0)
    return out


def model_all_reduce(x: torch.Tensor, tp: TensorParallel,
                     op: str = "sum") -> torch.Tensor:
    """``x`` all-reduced over the group by ``op`` ("sum" or "max"), with
    no gradient (decode's combine); ``x`` itself on a group of one."""
    import torch.distributed as dist
    if tp.size == 1:
        return x
    return _all_reduce(x, tp.group, {"sum": dist.ReduceOp.SUM,
                                     "max": dist.ReduceOp.MAX}[op])


def join_kv_heads(parts, tp: TensorParallel, cfg, dim: int = -2):
    """Every kv head, in order, from the ranks' ``parts`` (rank order),
    each holding the kv heads its rank computed along ``dim``:
    concatenated where "model" splits them (``"split"``), each head
    taken from the first rank that computed it where ranks share one
    (``"kv_slice"``: each rank computes the one kv head its q heads
    read)."""
    if tp.attn == "split":
        return torch.cat(parts, dim=dim)
    first = {}
    for r in range(tp.size):
        first.setdefault(kv_head_range(cfg, tp.size, r)[0], r)
    return torch.cat([parts[first[j]] for j in range(cfg.num_kv_heads)],
                     dim=dim)


def gather_kv_heads(x: torch.Tensor, tp: TensorParallel, cfg,
                    dim: int = -2) -> torch.Tensor:
    """Every kv head of ``x`` (this rank's kv heads along ``dim``) on
    every rank: one all-gather, then :func:`join_kv_heads`.  No
    gradient."""
    import torch.distributed as dist
    if tp.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return join_kv_heads(parts, tp, cfg, dim)


class _VocabLogSumExp(torch.autograd.Function):
    """``torch.logsumexp(logits, -1)`` over logits split on their last
    dimension across the group, with its arithmetic: the max (here over
    the group), infinities zeroed, the sum of ``exp(x - max)`` (here
    all-reduced), ``log`` and the max added; backward
    ``grad * exp(x - result)``."""

    @staticmethod
    def forward(ctx, logits, group):
        import torch.distributed as dist
        m = _all_reduce(torch.amax(logits, -1, keepdim=True), group,
                        dist.ReduceOp.MAX)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = _all_reduce(torch.sum((logits - m).exp_(), -1), group)
        lse = s.log_().add_(m.squeeze(-1))
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        logits, lse = ctx.saved_tensors
        return grad.unsqueeze(-1) * (logits - lse.unsqueeze(-1)).exp(), None


def vocab_logsumexp(logits: torch.Tensor, tp: TensorParallel):
    """logsumexp over the vocabulary of logits split on it (last dim)."""
    if tp.size == 1:
        return torch.logsumexp(logits, dim=-1)
    return _VocabLogSumExp.apply(logits, tp.group)


def vocab_gold(logits: torch.Tensor, labels: torch.Tensor, lo: int,
               tp: TensorParallel) -> torch.Tensor:
    """The gold logit of each label, from logits whose last dimension
    holds classes [lo, lo + n) on this rank: the owning rank's value,
    zero elsewhere, summed over the group."""
    n = logits.shape[-1]
    local = labels.long() - lo
    mine = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    return reduce_from_model(torch.where(mine, picked[..., 0], 0.0), tp)
