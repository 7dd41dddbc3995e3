"""The SSM family's train, prefill and decode steps split over "model"
(``launch.train`` with ``models.parallel`` and ``models.mamba2``), on
gloo CPU worlds (``tests/torch_gloo.py``).

Reduced mamba2-370m (d 64, d_inner 128, 8 heads of 16, state 16, 3
layers; its fused ``in_proj`` has 296 [z | x | B | C | dt] columns,
which the reference's "model" shards cut into 148 per rank on 2 and 74
on 4, across the bounds of z, x, B, C and dt):

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model): each rank
    computes its heads (4 or 2) with its z, x and dt columns and its
    share of B and C, gathered after the projection, the gated RMSNorm's
    Σy² summed over "model" and ``out_proj`` row-parallel.  The split
    train step's loss, gradient norm and first moments, the split
    prefill's logits and caches and two split decode steps' logits and
    caches equal the plain calls within ``PERF.md`` §2's bars (loss
    within rel 2e-3, gradients within rtol 5e-2 / atol 5e-4, logits
    within 2e-2) and ``tests/test_torch_models_zoo.py``'s cache bar (ten
    bf16 ulps of each leaf's max |plain|: the conv tail is the raw bf16
    projection, several units large at this gain, whose inputs carry the
    bf16 all-reduce of ``out_proj``'s partial sums from the layers
    before).  The embedding's gradient, the bf16 sum over the ranks of
    the first layer's input gradients in another order than the plain
    step's, is held to the gradient bar taken at its largest |gradient|,
    as ``tests/test_torch_train_ssm.py`` holds such sums.  ``in_proj``
    and the conv run at ``GAIN`` × their initial weights: at init's std
    0.02 the scan's B and C terms are lost beside D·x in bf16 (a
    reversed B changes no output bit), so a fault of their split would
    not show.  The caches lie as ``cache_defs`` + ``fit_spec_to_shape``
    place them (the state on its heads, the conv tail on its channels
    over "model"), in and out; a decode step's collectives are counted:
    per layer one all-gather of the new token's raw [x | B | C] and two
    all-reduces (Σy², ``out_proj``), one all-gather of the conv tails,
    one per gathered leaf, the embedding's and the logits': none of a
    state;
  * on a one-rank mesh three split train steps, the split prefill and
    two split decode steps equal the plain calls bit for bit;
  * ``tp_layout``, ``leaf_roles`` and ``gathered_leaves`` of every
    mamba2 leaf for 2, 4 and 16 ranks (the published widths on 16: 32
    heads, 2 each, ``in_proj``'s 4,384 columns, the conv's 2,304
    channels), and seamless-m4t-large-v2's split layout.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
CACHE_REL = 10 * 2.0 ** -8   # its CACHE_REL: ten bf16 ulps of max |ref|
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4
GAIN = 6.0

CONFIGS = """
import numpy as np
from repro_torch.configs import get_config

cfg = get_config("mamba2-370m").reduced()


def gain(params, g):
    # in_proj and the conv scaled up from init's std 0.02, at which the
    # scan's B and C terms are lost beside D·x; in place, DTensors or not
    with torch.no_grad():
        for name in ("in_proj", "conv_w"):
            params["layers"]["mamba"][name].mul_(g)
    return params
"""

SPLIT = CONFIGS + """
import json
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_mesh_from_devices, make_prefill_step,
                                make_train_step, widen_mesh_caches)
from repro_torch.launch.hloanalysis import OpCounter
from repro_torch.launch.train import (_cache_placements, _compute_view,
                                      _tensor_parallel)
from repro_torch.models import ModelZoo, widen_caches
from repro_torch.models.parallel import gathered_leaves

mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
p_m, p = gain(p_m, GAIN), gain(p, GAIN)
zoo = ModelZoo(cfg)
rng = np.random.default_rng(3)
toks = rng.integers(0, cfg.vocab_size, (4, 64))
batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
         "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                dtype=torch.int32)}
prompt = {"tokens": batch["tokens"][:, :20]}

tp, roles = _tensor_parallel(cfg, mesh, p_m)
held = {"/".join(path): [list(_compute_view(t, r, mesh).shape), list(t.shape),
                         r[0]]
        for (path, t), r in zip(tree_flatten_with_path(p_m),
                                tree_leaves(roles))}

step = make_train_step(cfg)
_, opt_m, m_m = step(p_m, o_m, batch, 1000)
_, opt_p, m_p = step(p, o, batch, 1000)
worst = {}
for (path, a), b in zip(tree_flatten_with_path(opt_m["mu"]),
                        tree_leaves(opt_p["mu"])):
    a, b = a.full_tensor() / (1 - B1), b / (1 - B1)
    scale = b.abs().max() if path == ("embed",) else b.abs()
    worst["/".join(path)] = float(((a - b).abs()
                                   - (GRAD_ATOL + GRAD_RTOL * scale)).max())


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


def cache_excess(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() - CACHE_REL * want.abs().max())


def compare(got_l, got_c, want_l, want_c):
    flat = tree_flatten_with_path(got_c)
    return dict(
        logits=excess(got_l.full_tensor(), want_l),
        cache=max(cache_excess(a.full_tensor(), b)
                  for (_, a), b in zip(flat, tree_leaves(want_c))),
        placed=all(tuple(a.placements) == tuple(_cache_placements(
            cfg, mesh, path, a.shape)) for path, a in flat),
        local={"/".join(path): list(a.to_local().shape)
               for path, a in flat})


named = gathered_leaves(cfg, zoo.param_defs(), SHAPE[1])
L = cfg.num_layers
# per layer: the new token's raw [x | B | C] gathered, Σy² and out_proj
# all-reduced; the conv tails gathered at once; the gathered leaves, the
# embedding along d and the logits over the vocabulary
want_ops = {"all-gather": L + 1 + len(named) + 2, "all-reduce": 2 * L,
            "all-to-all": 0}
with torch.no_grad():
    got_l, got_c = make_prefill_step(cfg)(p_m, prompt)
    want_l, want_c = zoo.prefill(p, prompt)
    out = {"prefill": compare(got_l, got_c, want_l, want_c)}
    for n in range(2):
        tok = want_l.argmax(-1).to(torch.int32)
        with OpCounter() as counter:
            got_l, got_c = make_decode_step(cfg)(
                p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok})
        want_l, want_c = zoo.decode(p, widen_caches(want_c),
                                    {"tokens": tok})
        out[f"decode{n}"] = compare(got_l, got_c, want_l, want_c)
        out[f"decode{n}"]["ops"] = {
            k: counter.collective_stats()[k]["count"] for k in want_ops}
out.update(
    layout=dict(attn=tp.attn, embed=tp.embed, head=tp.head, ssm=tp.ssm),
    held=held, want_ops=want_ops,
    loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
    / abs(float(m_p["loss"])),
    gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
    / abs(float(m_p["grad_norm"])),
    grad_excess=worst, all_reduces=m_m["all_reduces"],
    model_all_reduces=m_m["model_all_reduces"], leaves=len(tree_leaves(p)))
if RANK == 0:
    with open(WORKDIR + "/ssm.json", "w") as f:
        json.dump(out, f)
"""

# the leaves each rank computes with its "model" shard of, by the
# dimension "model" divides; the fused leaves sliced; every other whole
SPLIT_LEAVES = {"embed": 1, "head": 1, "layers/mamba/A_log": 1,
                "layers/mamba/D": 1, "layers/mamba/dt_bias": 1,
                "layers/mamba/norm_g": 1, "layers/mamba/out_proj": 1}
# per rank of m: in_proj's z, x and dt of its heads and N/m of B and C;
# the conv's x of its heads and the whole B and C
SLICED = {"layers/mamba/in_proj": lambda m: 2 * 128 // m + 2 * 16 // m
          + 8 // m,
          "layers/mamba/conv_w": lambda m: 128 // m + 2 * 16,
          "layers/mamba/conv_b": lambda m: 128 // m + 2 * 16}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_ssm_split_steps_on_four_ranks_match_the_plain_calls(tmp_path,
                                                             shape):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"SHAPE = {shape}\nTOL = {SERVE_TOL}\nGAIN = {GAIN}\n"
                    f"CACHE_REL = {CACHE_REL}\n"
                    f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + SPLIT, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "ssm.json").read_text())
    assert r["layout"] == dict(attn="gathered", embed=True, head="vocab",
                               ssm=True), r["layout"]
    model, data = shape[1], shape[0]
    for leaf, (compute, full, role) in r["held"].items():
        if leaf in SPLIT_LEAVES:
            d = SPLIT_LEAVES[leaf]
            assert role == "split", (leaf, role)
            assert compute[d] * model == full[d], (leaf, compute, full)
            assert compute[:d] + compute[d + 1:] == full[:d] + full[d + 1:]
        elif leaf in SLICED:
            assert role == "slice", (leaf, role)
            assert compute[-1] == SLICED[leaf](model), (leaf, compute)
            assert compute[:-1] == full[:-1], (leaf, compute, full)
        else:
            assert role == "gathered" and compute == full, (leaf, compute)
    assert r["all_reduces"] == r["leaves"] + 1, r
    # the norm's all-reduce over "model", and one per sliced leaf
    assert r["model_all_reduces"] == 1 + len(SLICED), r
    assert r["loss_rel"] <= LOSS_REL, r
    assert r["gnorm_rel"] <= GRAD_RTOL, r
    print(f"{shape}: excess over the bars (<= 0 holds): gradients",
          r["grad_excess"], "serving", {k: (r[k]["logits"], r[k]["cache"])
                                        for k in ("prefill", "decode0",
                                                  "decode1")})
    assert max(r["grad_excess"].values()) <= 0.0, r["grad_excess"]
    for part in ("prefill", "decode0", "decode1"):
        c = r[part]
        assert c["logits"] <= 0.0 and c["cache"] <= 0.0, (part, c)
        assert c["placed"], (part, c)
        # batch 4 over the data ranks; the state's 8 heads and the conv
        # tail's 160 channels over the model ranks
        assert c["local"] == {
            "mamba/conv": [3, 4 // data, 3, 160 // model],
            "mamba/state": [3, 4 // data, 8 // model, 16, 16]}, (part, c)
    for part in ("decode0", "decode1"):
        assert r[part]["ops"] == r["want_ops"], (part, r[part])


ONE_RANK = CONFIGS + """
from repro_torch._tree import tree_leaves
from repro_torch.ft import remesh
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_prefill_step, make_train_step,
                                widen_mesh_caches)
from repro_torch.launch.train import _tensor_parallel
from repro_torch.models import ModelZoo, widen_caches

mesh = remesh([0], model_size=1, device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
p_m, p = gain(p_m, GAIN), gain(p, GAIN)
tp, _ = _tensor_parallel(cfg, mesh, p_m)
assert (tp.size, tp.ssm) == (1, True), tp
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
print("SSM_ONE_RANK_OK")
"""


def test_ssm_split_steps_on_one_rank_are_bit_identical(tmp_path):
    res = run_ranks(f"GAIN = {GAIN}\n" + ONE_RANK, 1, tmp_path)
    assert_ranks_ok(res)
    assert "SSM_ONE_RANK_OK" in res[0][1]


@pytest.mark.parametrize("size", [2, 4, 16])
def test_ssm_layout_and_roles(size):
    """Every mamba2-370m leaf's role at its published widths (d_inner
    2,048, 32 heads of 64, state 128): the heads' leaves and ``out_proj``
    split, ``in_proj`` and the conv sliced to the rank's columns (the
    ranges of every rank cover z, x and dt once and B and C once in
    ``in_proj``, x once and B and C on every rank in the conv), and
    ``gathered_leaves`` naming those three with their reason."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, leaf_roles,
                                             tp_layout)
    cfg = get_config("mamba2-370m")
    assert tp_layout(cfg, size) == dict(attn="gathered", mlp=False,
                                        embed=True, head="vocab", ssm=True)
    defs = ModelZoo(cfg).param_defs()
    width = {"in_proj": 4384, "conv_w": 2304, "conv_b": 2304}
    cover = {k: [0] * w for k, w in width.items()}
    for rank in range(size):
        roles = leaf_roles(cfg, defs, size, rank)
        assert roles["embed"] == roles["head"] == ("split", -1)
        mamba = roles["layers"]["mamba"]
        for name in ("A_log", "D", "dt_bias", "norm_g"):
            assert mamba[name] == ("split", -1), (name, mamba)
        assert mamba["out_proj"] == ("split", -2)
        for name in width:
            kind, dim, ranges = mamba[name]
            assert (kind, dim) == ("slice", -1), mamba[name]
            for lo, hi in ranges:
                for c in range(lo, hi):
                    cover[name][c] += 1
    # z, x, B, C and dt each computed by one rank; the conv's x by one,
    # its B and C (channels 2,048 onwards) by every rank
    assert cover["in_proj"] == [1] * 4384
    for name in ("conv_w", "conv_b"):
        assert cover[name] == [1] * 2048 + [size] * 256, name
    rank3 = leaf_roles(cfg, defs, size, size - 1)["layers"]["mamba"]
    d, h, n = 2048, 32, 128
    lo = lambda w, base=0: base + (size - 1) * w // size
    assert rank3["in_proj"][2][0] == (lo(d), d)
    assert rank3["in_proj"][2][-1] == (lo(h, 2 * d + 2 * n), 2 * d + 2 * n + h)
    named = {g["leaf"]: g for g in gathered_leaves(cfg, defs, size)}
    assert sorted(named) == ["layers/mamba/conv_b", "layers/mamba/conv_w",
                             "layers/mamba/in_proj"], named
    assert all(g["role"] == "slice" and "across their bounds" in g["reason"]
               for g in named.values()), named
    assert "4384 [z | x | B | C | dt] columns" in \
        named["layers/mamba/in_proj"]["reason"]


def test_ssm_layout_on_a_group_of_one_and_uneven_groups():
    """On one rank every mamba2 leaf is its whole "model" shard (the plain
    path); where the group divides neither the heads nor the state size
    the block stays gathered and is named so; seamless-m4t-large-v2 (the
    encoder-decoder family) splits every "model"-tagged leaf on 16
    ranks, none named (``tests/test_torch_tp_encdec.py``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, leaf_roles,
                                             tp_layout)
    cfg = get_config("mamba2-370m")
    defs = ModelZoo(cfg).param_defs()
    roles = leaf_roles(cfg, defs, 1, 0)["layers"]["mamba"]
    assert all(r[0] == "split" for r in roles.values()), roles
    assert gathered_leaves(cfg, defs, 1) == []
    assert tp_layout(cfg, 64)["ssm"] is False       # 32 heads on 64
    odd = dataclasses.replace(cfg, ssm_state=120)   # N = 120 on 16
    assert tp_layout(odd, 16)["ssm"] is False
    named = gathered_leaves(odd, ModelZoo(odd).param_defs(), 16)
    assert {g["leaf"] for g in named} == {
        f"layers/mamba/{k}" for k in ("in_proj", "conv_w", "conv_b",
                                      "A_log", "D", "dt_bias", "norm_g",
                                      "out_proj")}, named
    assert all(g["reason"] == "32 heads and state size 120 on 16 ranks"
               for g in named), named
    seamless = get_config("seamless-m4t-large-v2")
    assert tp_layout(seamless, 16) == dict(attn="split", mlp=True,
                                           embed=True, head="vocab")
    assert gathered_leaves(seamless, ModelZoo(seamless).param_defs(),
                           16) == []
