"""The MoE family's train, prefill and decode steps split over "model"
(``launch.train`` with ``models.parallel`` and ``models.moe``), on gloo
CPU worlds (``tests/torch_gloo.py``).

Reduced qwen2-moe-a2.7b (a shared MLP) and reduced arctic-480b (a dense
residual MLP), with 14 and 16 routed experts (both padded to 16: each of
4 ranks holds 4, qwen2-moe's last rank two inert pads as qwen2-moe's 60
of 64 put 4 on the last of 16 ranks), so that every rank computes real
experts:

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model): each rank
    computes its experts and its columns / rows of the shared and dense
    MLPs; the split train step's loss, gradient norm and first moments
    (the router's among them, also within rtol 5e-2 of its own largest
    |gradient|, since the bar's atol exceeds it), and the split
    prefill's and one split decode step's logits and K/V caches equal
    the plain calls within the bars ``tests/test_torch_mesh_steps.py``
    states (``PERF.md`` §2: loss within rel 2e-3, gradients within rtol
    5e-2 / atol 5e-4, logits and caches within 2e-2).  Serving runs with
    the MoE MLPs' weights scaled by 4, so that the block's output weighs
    in the logits and a routing or capacity fault shows at the bar; the
    train step runs at the initial weights, where the gradient bar holds
    for every leaf (scaled, the embedding's bf16 sums part by up to
    1.2e-4 past it) and a fault of the expert split shows in the
    experts' and the router's gradients.  On (2, 2) the decode step's
    group of 4 tokens spans both data ranks.  Every rank of a "model"
    group routes alike.  Router logits are bf16 products, so a token's
    top-k can differ from the plain call's where two logits lie closer
    than the split's rounding: such a flip is excused only where the
    plain router's k-th and (k+1)-th logits lie within twice the largest
    router-logit difference of that layer, and the plain call then
    takes the split's experts for that token (both are roundings of the
    same routing), so that the rest of the comparison holds at the
    bars; the test prints how many it excused;
  * on a one-rank mesh three split train steps, the split prefill and
    two split decode steps equal the plain calls bit for bit.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4

ARCHS = ("arctic-480b", "qwen2-moe-a2.7b")

CONFIGS = """
import dataclasses
from repro_torch.configs import get_config

EXPERTS = {"qwen2-moe-a2.7b": 14, "arctic-480b": 16}


def config(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               num_experts=EXPERTS[arch])


def gain(params, g=4.0):
    # the MoE MLPs' weights scaled up from init's std 0.02, at which the
    # block's output (|x| <= 0.015) is lost beside the residual stream
    # (about 1) at the serving bar; in place, DTensors or not
    for name, w in params["layers"]["moe"].items():
        if name != "router":
            w.mul_(g)
    return params
"""

# the plain call on the whole batch, its routing adopting the split's on
# near ties (see the module docstring)
ROUTING = """
import numpy as np
import torch.distributed as dist
import repro_torch.models.moe as moe_mod

_top_k = moe_mod.top_k
HOOK = dict(mode=None, calls=0, seen=[], force=None, flips=0, excused=0)


def hooked_top_k(logits, k):
    vals, idx = _top_k(logits, k)
    c = HOOK["calls"]
    HOOK["calls"] += 1
    layers = cfg.num_layers
    layer = c if c < layers else 2 * layers - 1 - c   # remat's recompute
    flat_l, flat_i = logits.reshape(-1, logits.shape[-1]), idx.reshape(-1, k)
    if HOOK["mode"] == "record" and c < layers:
        HOOK["seen"].append((flat_l.detach().clone(), flat_i.clone()))
    elif HOOK["mode"] == "force":
        s_logits, s_idx = HOOK["force"][layer]
        flip = (flat_i.sort(-1).values != s_idx.sort(-1).values).any(-1)
        if c < layers and bool(flip.any()):
            err = float((s_logits - flat_l.detach()).abs().max())
            top = flat_l.detach().sort(-1, descending=True).values
            near = (top[:, k - 1] - top[:, k]) <= 2 * err
            HOOK["flips"] += int(flip.sum())
            HOOK["excused"] += int((flip & near).sum())
        flat_i = torch.where(flip[:, None], s_idx, flat_i)
        idx = flat_i.reshape(idx.shape)
        vals = torch.gather(flat_l, -1, flat_i).reshape(vals.shape)
    return vals, idx


moe_mod.top_k = hooked_top_k


def record(fn):
    HOOK.update(mode="record", calls=0, seen=[])
    out = fn()
    HOOK["mode"] = None
    return out


def forced(fn):
    # the split's routing of every data rank's tokens, in batch order; the
    # ranks of one "model" group must agree
    mine = [(l.numpy(), i.numpy()) for l, i in HOOK["seen"]]
    every = [None] * WORLD
    dist.all_gather_object(every, (mesh.get_local_rank("data"), mine))
    by_data = {}
    for q, seen in every:
        if q in by_data:
            for (la, ia), (lb, ib) in zip(by_data[q], seen):
                HOOK["alike"] &= bool(np.array_equal(ia, ib)
                                      and np.array_equal(la, lb))
        by_data[q] = seen
    rows = [by_data[q] for q in sorted(by_data)]
    HOOK["force"] = [
        (torch.tensor(np.concatenate([r[j][0] for r in rows])),
         torch.tensor(np.concatenate([r[j][1] for r in rows])))
        for j in range(cfg.num_layers)]
    HOOK.update(mode="force", calls=0)
    out = fn()
    HOOK["mode"] = None
    return out
"""

SPLIT = CONFIGS + """
import json
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_mesh_from_devices, make_prefill_step,
                                make_train_step, widen_mesh_caches)
from repro_torch.launch.train import _compute_view, _tensor_parallel
from repro_torch.models import ModelZoo, widen_caches

cfg = config(ARCH)
mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")
""" + ROUTING + """
HOOK["alike"] = True
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
zoo = ModelZoo(cfg)
rng = np.random.default_rng(3)
toks = rng.integers(0, cfg.vocab_size, (4, 64))
batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
         "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                dtype=torch.int32)}
prompt = {"tokens": batch["tokens"][:, :16]}

tp, roles = _tensor_parallel(cfg, mesh, p_m)
held = {"/".join(path): [list(_compute_view(t, r, mesh).shape), list(t.shape),
                         r[0]]
        for (path, t), r in zip(tree_flatten_with_path(p_m),
                                tree_leaves(roles))}

step = make_train_step(cfg)
_, opt_m, m_m = record(lambda: step(p_m, o_m, batch, 1000))
_, opt_p, m_p = forced(lambda: step(p, o, batch, 1000))
worst, router = -1.0, -1.0
for (path, a), b in zip(tree_flatten_with_path(opt_m["mu"]),
                        tree_leaves(opt_p["mu"])):
    a, b = a.full_tensor() / (1 - B1), b / (1 - B1)
    over = float(((a - b).abs() - (GRAD_ATOL + GRAD_RTOL * b.abs())).max())
    worst = max(worst, over)
    if path[-1] == "router":
        router = max(router, over)
        router_moved = float(b.abs().max())
        router_rel = float((a - b).abs().max()) / router_moved


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


with torch.no_grad():
    p_m, p = gain(p_m), gain(p)
    got_l, got_c = record(lambda: make_prefill_step(cfg)(p_m, prompt))
    want_l, want_c = forced(lambda: zoo.prefill(p, prompt))
    pre = dict(logits=excess(got_l.full_tensor(), want_l),
               cache=excess(got_c["kv"].full_tensor(), want_c["kv"]))
    tok = want_l.argmax(-1).to(torch.int32)
    got_l, got_c = record(lambda: make_decode_step(cfg)(
        p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok}))
    want_l, want_c = forced(lambda: zoo.decode(p, widen_caches(want_c),
                                               {"tokens": tok}))
    dec = dict(logits=excess(got_l.full_tensor(), want_l),
               cache=excess(got_c["kv"].full_tensor(), want_c["kv"]))
out = dict(
    layout=dict(attn=tp.attn, embed=tp.embed, head=tp.head,
                experts=tp.experts, shared=tp.shared, dense=tp.dense),
    held=held,
    loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
    / abs(float(m_p["loss"])),
    gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
    / abs(float(m_p["grad_norm"])),
    grad_excess=worst, router_excess=router, router_moved=router_moved,
    router_rel=router_rel,
    all_reduces=m_m["all_reduces"], model_all_reduces=m_m["model_all_reduces"],
    leaves=len(tree_leaves(p)), prefill=pre, decode=dec,
    flips=HOOK["flips"], excused=HOOK["excused"], alike=HOOK["alike"])
if RANK == 0:
    with open(WORKDIR + "/moe.json", "w") as f:
        json.dump(out, f)
"""

# the leaves each rank computes with its "model" shard of, by the
# dimension "model" divides; every other leaf whole
SPLIT_LEAVES = {"embed": 1, "head": 1, "layers/attn/wq": 2,
                "layers/attn/wo": 1, "layers/moe/w1": 1, "layers/moe/w3": 1,
                "layers/moe/w2": 1}
MLP_LEAVES = {"qwen2-moe-a2.7b": "shared", "arctic-480b": "dense"}
ATTN = {(2, 2): "split", (1, 4): "kv_slice"}


@pytest.mark.parametrize("shape", sorted(ATTN))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_split_steps_on_four_ranks_match_the_plain_calls(tmp_path, arch,
                                                             shape):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"ARCH = {arch!r}\nSHAPE = {shape}\nTOL = {SERVE_TOL}\n"
                    f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + SPLIT, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "moe.json").read_text())
    print(f"{arch} {shape}: {r['excused']} of {r['flips']} top-k flips "
          "excused as near ties")
    mlp = MLP_LEAVES[arch]
    assert r["layout"] == dict(attn=ATTN[shape], embed=True, head="vocab",
                               experts=True, shared=mlp == "shared",
                               dense=mlp == "dense"), r["layout"]
    model = shape[1]
    split = dict(SPLIT_LEAVES, **{f"layers/moe/{mlp}_w1": 2,
                                  f"layers/moe/{mlp}_w3": 2,
                                  f"layers/moe/{mlp}_w2": 1})
    if ATTN[shape] == "split":
        split.update({"layers/attn/wk": 2, "layers/attn/wv": 2})
    for leaf, (compute, full, role) in r["held"].items():
        if leaf in split:
            d = split[leaf]
            assert role == "split", (leaf, role)
            assert compute[d] * model == full[d], (leaf, compute, full)
            assert compute[:d] + compute[d + 1:] == full[:d] + full[d + 1:]
        elif leaf in ("layers/attn/wk", "layers/attn/wv"):
            assert role == "slice" and compute[2] < full[2], (leaf, compute)
        else:
            assert role == "gathered" and compute == full, (leaf, compute)
    assert r["alike"], "the ranks of a 'model' group routed differently"
    assert r["excused"] == r["flips"], r
    assert r["all_reduces"] == r["leaves"] + 1, r
    # the norm's all-reduce over "model", and one per sliced kv leaf
    assert r["model_all_reduces"] == 1 + 2 * (ATTN[shape] == "kv_slice"), r
    assert r["loss_rel"] <= LOSS_REL, r
    assert r["gnorm_rel"] <= GRAD_RTOL, r
    assert r["grad_excess"] <= 0.0, r
    assert r["router_excess"] <= 0.0 and r["router_moved"] > 0.0, r
    # the router's gradient is small against the bar's atol: held also
    # within rtol of its own largest |gradient| (a gate gradient missing
    # the other ranks' experts parts by 0.16-0.20 of it)
    assert r["router_rel"] <= GRAD_RTOL, r
    for part in ("prefill", "decode"):
        assert r[part]["logits"] <= 0.0, (part, r)
        assert r[part]["cache"] <= 0.0, (part, r)


ONE_RANK = CONFIGS + """
from repro_torch._tree import tree_leaves
from repro_torch.ft import remesh
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_prefill_step, make_train_step,
                                widen_mesh_caches)
from repro_torch.launch.train import _tensor_parallel
from repro_torch.models import ModelZoo, widen_caches
import numpy as np

cfg = config(ARCH)
mesh = remesh([0], model_size=1, device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
tp, _ = _tensor_parallel(cfg, mesh, p_m)
assert (tp.size, tp.experts, tp.attn) == (1, True, "split"), tp
rng = np.random.default_rng(5)
toks = rng.integers(0, cfg.vocab_size, (2, 64))
batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
         "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                dtype=torch.int32)}
step = make_train_step(cfg)
bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else (
    t.view(torch.int16) if t.is_floating_point() else t)
for n in range(3):
    p_m, o_m, mm = step(p_m, o_m, batch, n)
    p, o, m = step(p, o, batch, n)
    assert mm["model_all_reduces"] == 0, mm
    assert torch.equal(bits(mm["loss"]), bits(m["loss"])), n
    for a, b in zip(tree_leaves({"p": p_m, "o": o_m}),
                    tree_leaves({"p": p, "o": o})):
        assert torch.equal(bits(a.full_tensor()), bits(b)), n
zoo = ModelZoo(cfg)
prompt = {"tokens": batch["tokens"]}
with torch.no_grad():
    want_l, want_c = zoo.prefill(p, prompt)
    got_l, got_c = make_prefill_step(cfg)(p_m, prompt)
    for n in range(3):
        assert torch.equal(bits(got_l.full_tensor()), bits(want_l)), n
        for a, b in zip(tree_leaves(got_c), tree_leaves(want_c)):
            assert torch.equal(bits(a.full_tensor()), bits(b)), n
        if n == 2:
            break
        tok = want_l.argmax(-1).to(torch.int32)
        want_l, want_c = zoo.decode(p, widen_caches(want_c), {"tokens": tok})
        got_l, got_c = make_decode_step(cfg)(
            p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok})
print("MOE_ONE_RANK_OK")
"""


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_split_steps_on_one_rank_are_bit_identical(tmp_path, arch):
    res = run_ranks(f"ARCH = {arch!r}\n" + ONE_RANK, 1, tmp_path)
    assert_ranks_ok(res)
    assert "MOE_ONE_RANK_OK" in res[0][1]
