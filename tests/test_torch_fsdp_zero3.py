"""The ``zero3`` profile's FSDP on a gloo CPU world of 4 ranks as (2 data,
2 model) (``tests/torch_gloo.py``): every stacked leaf stored sharded
over both axes on its "fsdp" dimension, the batch over both.

Reduced llama3-8b with ``sharding_profile="zero3"`` and FSDP forced
(``FSDP_PARAM_THRESHOLD = 0`` in every rank, as a test sets it), its
state placed as ``launch.train._abstract_params`` places the dry run's
(``resolve_spec`` with the profile's axes, ``fit_spec_to_shape``,
``spec_placements``): a held leaf's layer slice is gathered over "model"
then "data" (the inner axis first, the row-major order of a dimension
split over both) and its gradient reduce-scattered over "data" then
"model".  A swapped order in either places this rank's part of another
rank's shard, so the values, not only the collective counts, tell.

  * train: the loss and every gradient shard, as the step hands them to
    the optimizer before the mean, equal bit for bit the whole-view
    oracle (every leaf gathered whole, ``_compute_view``; the same
    ``loss_and_grads``; each whole gradient all-reduced over "data" then
    "model", this rank's shard kept).  Each sum has four terms in the
    same association both ways, so no bit parts.  The step itself
    (``make_train_step``) holds its loss and gradient norm at
    ``PERF.md`` §2's bars against the plain one-process step on the same
    batch, and its first moments at the gradient bars;
  * serving: ``make_prefill_step`` then two chained
    ``make_decode_step`` calls equal the same steps with every leaf
    gathered whole (``_layer_gather`` made to hold no leaf) bit for bit
    in their logits and caches, and each call gathers each layer's
    slice once.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp_train import (CONFIGS, GRAD_ATOL,  # noqa: E402
                                   GRAD_RTOL, LOSS_REL)
from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

LAYERS = 3   # reduced llama3-8b
HELD = 7     # the attention's four leaves and the MLP's three

ZERO3 = CONFIGS + """
import json
from torch.distributed.tensor import distribute_tensor
from repro_torch._tree import (tree_flatten_with_path, tree_leaves,
                               tree_map, tree_unflatten)
from repro_torch.launch import (make_decode_step, make_mesh_from_devices,
                                make_prefill_step, make_train_step,
                                value_and_grad, widen_mesh_caches)
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.launch.train import (_batch_axes, _batch_local,
                                      _compute_view, _layer_gather,
                                      _profile, _storage_shard, use_fsdp)
from repro_torch.models import ModelZoo, materialize
from repro_torch.models.fsdp import GATHER_COUNT
from repro_torch.models.layers import (dtype_of, fit_spec_to_shape,
                                       resolve_spec, spec_placements)
from repro_torch.optim import AdamWConfig, adamw_init

cfg = dataclasses.replace(config("llama3-8b"), sharding_profile="zero3")
mesh = make_mesh_from_devices(range(WORLD), (2, 2), ("data", "model"),
                              device_type="cpu")
defs = ModelZoo(cfg).param_defs()
dp, use_tp, fsdp_axes = _profile(cfg, dp_axes_of(mesh))
placements = tree_map(lambda d: spec_placements(fit_spec_to_shape(
    d.shape, resolve_spec(d.spec, use_fsdp=use_fsdp(cfg), dp_axes=dp,
                          use_tp=use_tp, fsdp_axes=fsdp_axes), mesh), mesh),
    defs)
opt = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
p = materialize(defs, torch.Generator().manual_seed(0),
                dtype_of(cfg.param_dtype), device="cpu")
o = adamw_init(p, opt)
place = lambda t, pl: distribute_tensor(t, mesh, pl)
p_m = tree_map(place, p, placements)
o_m = {"mu": tree_map(place, o["mu"], placements),
       "nu": tree_map(place, o["nu"], placements),
       "count": distribute_tensor(o["count"], mesh,
                                  [Replicate(), Replicate()])}
# the stacked leaves lie over both axes on one dimension
two_axis = ["/".join(path) for path, t in tree_flatten_with_path(p_m)
            if path[0] == "layers" and all(pl.is_shard() for pl in
                                           t.placements)
            and t.placements[0].dim == t.placements[1].dim]
batch = batch_of(cfg, 3, 4, 64)

# the whole-view oracle against the layer gathers, on this rank's batch
axes = _batch_axes(cfg, mesh)
roles = tree_map(lambda t: None, p_m)
fsdp = _layer_gather(cfg, mesh, p_m, roles, axes)
held = {"/".join(path): list(fsdp.held(path))
        for path, _ in tree_flatten_with_path(p_m) if fsdp.held(path)}
local = tree_map(lambda x: _batch_local(x, 0, axes, mesh), batch)
loss_and_grads = value_and_grad(ModelZoo(cfg).train_loss)
shards = tree_unflatten(*zip(*[
    (path, t.to_local() if fsdp.held(path) else t.full_tensor())
    for path, t in tree_flatten_with_path(p_m)]))
GATHER_COUNT["layers"] = 0
loss, grads = loss_and_grads(shards, local, None, None, fsdp)
gathers = GATHER_COUNT["layers"]
views = tree_map(lambda t: _compute_view(t, None, mesh), p_m)
loss_o, grads_o = loss_and_grads(views, local, None, None)


def oracle(g, t):
    g = g.contiguous()
    for axis in ("data", "model"):
        dist.all_reduce(g, group=mesh.get_group(axis))
    return _storage_shard(g, t, None, mesh)


differ = []
for (path, g), g_o, t in zip(tree_flatten_with_path(grads),
                             tree_leaves(grads_o), tree_leaves(p_m)):
    if fsdp.held(path):
        want = oracle(g_o, t)
        ok = same(g, want) and g.shape == t.to_local().shape
    else:
        ok = same(g, g_o)
    if not ok:
        differ.append("/".join(path))
if not same(loss, loss_o):
    differ.append("loss")

# the step against the plain one-process step
step = make_train_step(cfg)
GATHER_COUNT["layers"] = 0
new_m, opt_m, m_m = step(p_m, o_m, batch, 1000)
step_gathers = GATHER_COUNT["layers"]
new_p, opt_p, m_p = step(p, o, batch, 1000)
over = {}
for (path, a), b in zip(tree_flatten_with_path(opt_m["mu"]),
                        tree_leaves(opt_p["mu"])):
    a = a.full_tensor()
    excess = float(((a - b).abs() - (1 - B1) * (
        GRAD_ATOL + GRAD_RTOL * (b / (1 - B1)).abs())).max())
    if excess > 0:
        over["/".join(path)] = excess

# serving: prefill and two chained decode steps against the whole view
layer_gather = train_mod._layer_gather


def whole_view(fn):
    train_mod._layer_gather = lambda cfg, mesh, params, roles, axes: None
    try:
        return fn()
    finally:
        train_mod._layer_gather = layer_gather


def serve_differ(tag, got, want):
    (gl, gc), (wl, wc) = got, want
    out = [] if same(gl.full_tensor(), wl.full_tensor()) else [f"{tag}/logits"]
    for (path, a), (_, b) in zip(tree_flatten_with_path(gc),
                                 tree_flatten_with_path(wc)):
        if not (same(a.full_tensor(), b.full_tensor())
                and a.placements == b.placements):
            out.append(tag + "/" + "/".join(path))
    return out


serve = {"tokens": batch_of(cfg, 4, 4, 15)["tokens"]}
prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
prefill_w, decode_w = make_prefill_step(cfg), make_decode_step(cfg)
serve_gathers = []
with torch.no_grad():
    GATHER_COUNT["layers"] = 0
    got = prefill(new_m, serve)
    serve_gathers.append(GATHER_COUNT["layers"])
    want = whole_view(lambda: prefill_w(new_m, serve))
    differ += serve_differ("prefill", got, want)
    for n in range(2):
        tok = {"tokens": want[0].full_tensor().argmax(-1).to(torch.int32)}
        GATHER_COUNT["layers"] = 0
        got = decode(new_m, widen_mesh_caches(cfg, got[1]), tok)
        serve_gathers.append(GATHER_COUNT["layers"])
        want = whole_view(lambda: decode_w(new_m, widen_mesh_caches(
            cfg, want[1]), tok))
        differ += serve_differ(f"decode{n}", got, want)

out = dict(
    differ=differ, two_axis=two_axis, held=held, gathers=gathers,
    step_gathers=step_gathers, serve_gathers=serve_gathers,
    leaves=len(tree_leaves(p)), all_reduces=m_m["all_reduces"],
    model_all_reduces=m_m["model_all_reduces"],
    loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
    / abs(float(m_p["loss"])),
    gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
    / abs(float(m_p["grad_norm"])),
    mu_over=over)
with open(WORKDIR + f"/zero3_{RANK}.json", "w") as f:
    json.dump(out, f)
"""


def test_zero3_two_axis_fsdp_matches_the_whole_view_oracle(tmp_path):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n"
                    "from torch.distributed.tensor import Replicate\n"
                    + ZERO3, 4, tmp_path)
    assert_ranks_ok(res)
    out = [json.loads((tmp_path / f"zero3_{rank}.json").read_text())
           for rank in range(4)]
    # every rank's shards first: a swapped reduce-scatter order misplaces
    # only the gradients of the ranks off the mesh's diagonal
    assert [r["differ"] for r in out] == [[]] * 4, out
    for r in out:
        # the seven stacked leaves held over both axes, on one dimension
        assert len(r["two_axis"]) == len(r["held"]) == HELD, r
        assert all(h == ["data", "model"] for h in r["held"].values()), r
        # each layer's slice gathered in the forward and the recompute
        assert r["gathers"] == r["step_gathers"] == 2 * LAYERS, r
        assert r["serve_gathers"] == [LAYERS] * 3, r
        # after backward, over both batch axes: every leaf not held, the
        # loss, and the norm's one per axis; nothing over "model" alone
        assert r["all_reduces"] == 2 * (r["leaves"] - HELD + 1) + 2, r
        assert r["model_all_reduces"] == 0, r
        assert r["loss_rel"] <= LOSS_REL, r
        assert r["gnorm_rel"] <= GRAD_RTOL, r
        assert r["mu_over"] == {}, r
