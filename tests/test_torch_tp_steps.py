"""The dense family's train and prefill steps split over "model"
(``launch.train`` with ``models.parallel``), on gloo CPU worlds
(``tests/torch_gloo.py``).

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model): reduced
    llama3-8b (4 q heads, 2 kv heads: split by whole heads on 2 ranks,
    each rank computing the kv head its q head reads on 4) and reduced
    smollm-135m with its published 9 q / 3 kv heads (which "model" does
    not divide: the attention block stays gathered; its tied embedding
    splits on d).  Each rank computes with its "model" shard of every
    split leaf; the split train step's loss, gradient norm and first
    moments, and the split prefill's logits and K/V caches, equal the
    plain step on the same batch within the bars that
    ``tests/test_torch_mesh_steps.py`` states (``PERF.md`` §2: loss
    within rel 2e-3, gradients — the first update's first moment and
    the gradient norm — within rtol 5e-2 / atol 5e-4, logits and caches
    within 2e-2);
  * on a one-rank mesh the split train step (three steps) and the split
    prefill equal the plain calls bit for bit, for the untied vocabulary
    head and the tied row-parallel head;
  * the layout: which leaves split, and which the dry run names as
    gathered (smollm-135m's attention; llama3-8b's kv projections on 16
    ranks; phi3-medium-14b's attention).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4

# reduced configs: llama3-8b as .reduced() gives it (4 q / 2 kv heads);
# smollm-135m with its published 9 q / 3 kv heads at head_dim 8
CONFIGS = """
import dataclasses
from repro_torch.configs import get_config


def config(arch):
    cfg = get_config(arch).reduced()
    if arch == "smollm-135m":
        cfg = dataclasses.replace(cfg, num_heads=9, num_kv_heads=3,
                                  head_dim=8)
    return cfg
"""

SPLIT = CONFIGS + """
import json
import numpy as np
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import (init_train_state, make_mesh_from_devices,
                                make_prefill_step, make_train_step)
from repro_torch.launch.train import _compute_view, _tensor_parallel
from repro_torch.models import ModelZoo

cfg = config(ARCH)
mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
rng = np.random.default_rng(3)
toks = rng.integers(0, cfg.vocab_size, (4, 64))
batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
         "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                dtype=torch.int32)}

# what each rank computes with: its "model" shard of the split leaves
tp, roles = _tensor_parallel(cfg, mesh, p_m)
held = {"/".join(path): [list(_compute_view(t, r, mesh).shape), list(t.shape),
                         r[0]]
        for (path, t), r in zip(tree_flatten_with_path(p_m),
                                tree_leaves(roles))}

step = make_train_step(cfg)
_, opt_m, m_m = step(p_m, o_m, batch, 1000)
_, opt_p, m_p = step(p, o, batch, 1000)
worst = -1.0
for (path, a), b in zip(tree_flatten_with_path(opt_m["mu"]),
                        tree_leaves(opt_p["mu"])):
    a, b = a.full_tensor() / (1 - B1), b / (1 - B1)
    worst = max(worst, float(((a - b).abs()
                              - (GRAD_ATOL + GRAD_RTOL * b.abs())).max()))


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


with torch.no_grad():
    want_l, want_c = ModelZoo(cfg).prefill(p, {"tokens": batch["tokens"]})
    got_l, got_c = make_prefill_step(cfg)(p_m, {"tokens": batch["tokens"]})
out = dict(
    layout=dict(attn=tp.attn, mlp=tp.mlp, embed=tp.embed, head=tp.head),
    held=held,
    loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
    / abs(float(m_p["loss"])),
    gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
    / abs(float(m_p["grad_norm"])),
    grad_excess=worst, all_reduces=m_m["all_reduces"],
    model_all_reduces=m_m["model_all_reduces"], leaves=len(tree_leaves(p)),
    logits_excess=excess(got_l.full_tensor(), want_l),
    cache_excess=max(excess(a.full_tensor(), b) for a, b in
                     zip(tree_leaves(got_c), tree_leaves(want_c))),
    logits_placements=str(tuple(got_l.placements)))
if RANK == 0:
    with open(WORKDIR + "/split.json", "w") as f:
        json.dump(out, f)
"""

# The split of each leaf on rank 0: ("layers/attn/wq" etc.) -> the
# dimension "model" divides in compute, or None where the rank computes
# with the whole leaf.
EXPECT = {
    ("llama3-8b", (2, 2)): dict(
        layout=dict(attn="split", mlp=True, embed=True, head="vocab"),
        split={"embed": 1, "head": 1, "layers/attn/wq": 2,
               "layers/attn/wk": 2, "layers/attn/wv": 2,
               "layers/attn/wo": 1, "layers/mlp/w1": 2, "layers/mlp/w3": 2,
               "layers/mlp/w2": 1}),
    ("llama3-8b", (1, 4)): dict(
        layout=dict(attn="kv_slice", mlp=True, embed=True, head="vocab"),
        split={"embed": 1, "head": 1, "layers/attn/wq": 2,
               "layers/attn/wo": 1, "layers/mlp/w1": 2, "layers/mlp/w3": 2,
               "layers/mlp/w2": 1},
        sliced={"layers/attn/wk": 2, "layers/attn/wv": 2}),
    ("smollm-135m", (2, 2)): dict(
        layout=dict(attn="gathered", mlp=True, embed=True, head="rows"),
        split={"embed": 1, "layers/mlp/w1": 2, "layers/mlp/w3": 2,
               "layers/mlp/w2": 1}),
    ("smollm-135m", (1, 4)): dict(
        layout=dict(attn="gathered", mlp=True, embed=True, head="rows"),
        split={"embed": 1, "layers/mlp/w1": 2, "layers/mlp/w3": 2,
               "layers/mlp/w2": 1}),
}


@pytest.mark.parametrize("arch,shape", sorted(EXPECT))
def test_split_steps_on_four_ranks_match_the_plain_step(tmp_path, arch,
                                                        shape):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"ARCH = {arch!r}\nSHAPE = {shape}\nTOL = {SERVE_TOL}\n"
                    f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + SPLIT, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "split.json").read_text())
    want = EXPECT[(arch, shape)]
    model = shape[1]
    assert r["layout"] == want["layout"], r["layout"]
    for leaf, (compute, full, role) in r["held"].items():
        if leaf in want["split"]:
            d = want["split"][leaf]
            assert role == "split", (leaf, role)
            assert compute[d] * model == full[d], (leaf, compute, full)
            assert compute[:d] + compute[d + 1:] == full[:d] + full[d + 1:]
        elif leaf in want.get("sliced", {}):
            d = want["sliced"][leaf]
            assert role == "slice" and compute[d] < full[d], (leaf, compute)
        else:
            assert role == "gathered" and compute == full, (leaf, compute)
    # the batch axes' all-reduces as before; "model" adds the norm's and
    # one per sliced leaf
    assert r["all_reduces"] == r["leaves"] + 1, r
    assert r["model_all_reduces"] == 1 + len(want.get("sliced", {})), r
    assert r["loss_rel"] <= LOSS_REL, r
    assert r["gnorm_rel"] <= GRAD_RTOL, r
    assert r["grad_excess"] <= 0.0, r
    assert r["logits_excess"] <= 0.0, r
    assert r["cache_excess"] <= 0.0, r
    assert r["logits_placements"] == "(Shard(dim=0), Replicate())", r


ONE_RANK = """
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.ft import remesh
from repro_torch.launch import (init_train_state, make_prefill_step,
                                make_train_step)
from repro_torch.launch.train import _tensor_parallel
from repro_torch.models import ModelZoo
cfg = get_config(ARCH).reduced()
mesh = remesh([0], model_size=1, device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
tp, _ = _tensor_parallel(cfg, mesh, p_m)
assert (tp.size, tp.attn, tp.head) == (1, "split", HEAD), tp
step = make_train_step(cfg)
data = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 2, seed=5))
bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
for n in range(3):
    batch = data.batch(n, device="cpu")
    p_m, o_m, mm = step(p_m, o_m, batch, n)
    p, o, m = step(p, o, batch, n)
    assert mm["model_all_reduces"] == 0, mm   # a group of one: none
    assert torch.equal(bits(mm["loss"]), bits(m["loss"])), n
    assert torch.equal(mm["grad_norm"], m["grad_norm"]), n
    for a, b in zip(tree_leaves({"p": p_m, "o": o_m}),
                    tree_leaves({"p": p, "o": o})):
        assert torch.equal(bits(a.full_tensor()), bits(b)), n
with torch.no_grad():
    want_l, want_c = ModelZoo(cfg).prefill(p, {"tokens": batch["tokens"]})
    got_l, got_c = make_prefill_step(cfg)(p_m, {"tokens": batch["tokens"]})
assert torch.equal(bits(got_l.full_tensor()), bits(want_l))
for a, b in zip(tree_leaves(got_c), tree_leaves(want_c)):
    assert torch.equal(a.full_tensor().view(torch.int16), b.view(torch.int16))
print("ONE_RANK_SPLIT_OK")
"""


@pytest.mark.parametrize("arch,head", [("llama3-8b", "vocab"),
                                       ("smollm-135m", "rows")])
def test_one_rank_split_steps_are_bit_identical(tmp_path, arch, head):
    """A (1, 1) mesh: every split block on a "model" group of one rank
    (smollm-135m at .reduced()'s 4 heads, so that its attention splits
    too) equals the plain step and prefill bit for bit."""
    res = run_ranks(f"ARCH = {arch!r}\nHEAD = {head!r}\n" + ONE_RANK, 1,
                    tmp_path)
    assert_ranks_ok(res)
    assert "ONE_RANK_SPLIT_OK" in res[0][1]


def test_layout_names_the_gathered_leaves():
    """``gathered_leaves`` (what the dry run reports) on the production
    mesh's 16-rank "model" axis: smollm-135m's attention (9 heads), the
    kv projections of llama3-8b and internlm2-1.8b (8 kv heads: each
    rank computes the one its q heads read), phi3-medium-14b's attention
    (40 heads); every other "model"-tagged leaf of the dense family
    splits."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, kv_head_range,
                                             tp_layout)
    attn = {"layers/attn/" + w for w in ("wq", "wk", "wv", "wo")}
    kv = {"layers/attn/wk", "layers/attn/wv"}
    for arch, want_attn, want in (("smollm-135m", "gathered", attn),
                                  ("llama3-8b", "kv_slice", kv),
                                  ("internlm2-1.8b", "kv_slice", kv),
                                  ("phi3-medium-14b", "gathered", attn)):
        cfg = get_config(arch)
        layout = tp_layout(cfg, 16)
        assert layout["attn"] == want_attn and layout["mlp"], (arch, layout)
        assert layout["embed"] and layout["head"] == (
            "rows" if cfg.tie_embeddings else "vocab"), (arch, layout)
        named = gathered_leaves(cfg, ModelZoo(cfg).param_defs(), 16)
        assert {g["leaf"] for g in named} == want, (arch, named)
        assert all(g["reason"] for g in named)
    # llama3-8b: ranks 2r and 2r + 1 read kv head r
    cfg = get_config("llama3-8b")
    assert [kv_head_range(cfg, 16, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    # the SSM, hybrid and encoder-decoder families split too
    # (tests/test_torch_tp_ssm.py, tests/test_torch_tp_hybrid.py,
    # tests/test_torch_tp_encdec.py)
    assert tp_layout(get_config("seamless-m4t-large-v2"), 16)["attn"] == \
        "split"
