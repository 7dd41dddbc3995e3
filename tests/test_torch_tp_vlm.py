"""The VLM family's train step and prefill split over "model"
(``launch.train`` with ``models.parallel``: its blocks are the dense
blocks), on gloo CPU worlds (``tests/torch_gloo.py``).

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model), reduced
    pixtral-12b (4 q / 2 kv heads: split by whole heads on 2 ranks, each
    rank computing the kv head its q heads read on 4) with patch
    embeddings overwriting the first 8 positions: each rank computes with
    its "model" shard of every split leaf; the split train step's loss,
    gradient norm and first moments, and the split prefill's logits and
    K/V caches, equal the plain step on the same batch within the bars
    ``tests/test_torch_mesh_steps.py`` states (``PERF.md`` §2: loss
    within rel 2e-3, gradients within rtol 5e-2 / atol 5e-4, logits and
    caches within 2e-2);
  * on a one-rank mesh three split train steps, the split prefill and
    two split decode steps equal the plain calls bit for bit;
  * the layout at pixtral-12b's published widths on the production
    mesh's 16 "model" ranks, and the leaves the dry run names gathered.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4

BATCH = """
import numpy as np
from repro_torch.configs import get_config

cfg = get_config("pixtral-12b").reduced()
rng = np.random.default_rng(5)
B, S = 4, 64
toks = rng.integers(0, cfg.vocab_size, (B, S))
batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
         "labels": torch.tensor(np.roll(toks, -1, axis=1), dtype=torch.int32),
         "patch_embeds": torch.tensor(
             rng.normal(0, 1, (B, cfg.num_patch_tokens, cfg.d_model)),
             dtype=torch.float32).to(torch.bfloat16)}
serve = {k: batch[k] for k in ("tokens", "patch_embeds")}
"""

SPLIT = BATCH + """
import json
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import (init_train_state, make_mesh_from_devices,
                                make_prefill_step, make_train_step)
from repro_torch.launch.train import _tensor_parallel
from repro_torch.models import ModelZoo

mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
tp, _ = _tensor_parallel(cfg, mesh, p_m)
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
    want_l, want_c = ModelZoo(cfg).prefill(p, serve)
    got_l, got_c = make_prefill_step(cfg)(p_m, serve)
    # the patch rows matter: without them the logits move
    bare_l, _ = ModelZoo(cfg).prefill(p, {"tokens": serve["tokens"]})
out = dict(
    layout=dict(attn=tp.attn, mlp=tp.mlp, embed=tp.embed, head=tp.head),
    loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
    / abs(float(m_p["loss"])),
    gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
    / abs(float(m_p["grad_norm"])),
    grad_excess=worst, model_all_reduces=m_m["model_all_reduces"],
    logits_excess=excess(got_l.full_tensor(), want_l),
    cache_excess=max(excess(a.full_tensor(), b) for a, b in
                     zip(tree_leaves(got_c), tree_leaves(want_c))),
    patches_move_logits=float((bare_l - want_l).abs().max()),
    logits_placements=str(tuple(got_l.placements)),
    cache_placements=str(tuple(got_c["kv"].placements)))
if RANK == 0:
    with open(WORKDIR + "/vlm.json", "w") as f:
        json.dump(out, f)
"""

LAYOUTS = {(2, 2): "split", (1, 4): "kv_slice"}


@pytest.mark.parametrize("shape", sorted(LAYOUTS))
def test_vlm_split_steps_on_four_ranks_match_the_plain_step(tmp_path,
                                                            shape):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"SHAPE = {shape}\nTOL = {SERVE_TOL}\n"
                    f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + SPLIT, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "vlm.json").read_text())
    assert r["layout"] == dict(attn=LAYOUTS[shape], mlp=True, embed=True,
                               head="vocab"), r
    # the norm's all-reduce over "model", and one per sliced kv leaf
    assert r["model_all_reduces"] == 1 + 2 * (LAYOUTS[shape] == "kv_slice")
    assert r["loss_rel"] <= LOSS_REL, r
    assert r["gnorm_rel"] <= GRAD_RTOL, r
    assert r["grad_excess"] <= 0.0, r
    assert r["logits_excess"] <= 0.0, r
    assert r["cache_excess"] <= 0.0, r
    assert r["patches_move_logits"] > 10 * SERVE_TOL, r
    assert r["logits_placements"] == "(Shard(dim=0), Replicate())", r
    # prefill hands decode its caches split on the sequence over "model"
    assert r["cache_placements"] == "(Shard(dim=2), Shard(dim=3))", r


ONE_RANK = BATCH + """
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
tp, _ = _tensor_parallel(cfg, mesh, p_m)
assert (tp.size, tp.attn, tp.head) == (1, "split", "vocab"), tp
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
with torch.no_grad():
    want_l, want_c = zoo.prefill(p, serve)
    got_l, got_c = make_prefill_step(cfg)(p_m, serve)
    for n in range(2):
        assert torch.equal(bits(got_l.full_tensor()), bits(want_l)), n
        for a, b in zip(tree_leaves(got_c), tree_leaves(want_c)):
            assert torch.equal(bits(a.full_tensor()), bits(b)), n
        tok = want_l.argmax(-1).to(torch.int32)
        want_l, want_c = zoo.decode(p, widen_caches(want_c), {"tokens": tok})
        got_l, got_c = make_decode_step(cfg)(
            p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok})
    assert torch.equal(bits(got_l.full_tensor()), bits(want_l))
print("VLM_ONE_RANK_OK")
"""


def test_vlm_split_steps_on_one_rank_are_bit_identical(tmp_path):
    res = run_ranks(ONE_RANK, 1, tmp_path)
    assert_ranks_ok(res)
    assert "VLM_ONE_RANK_OK" in res[0][1]


def test_vlm_layout_on_sixteen_ranks():
    """pixtral-12b at its published widths (32 q / 8 kv heads, d 5,120,
    d_ff 14,336, an untied 131,072-class head) on 16 "model" ranks: every
    block splits but the kv projections, which each rank computes for
    the one kv head its q heads read (llama3-8b's case)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import gathered_leaves, tp_layout
    cfg = get_config("pixtral-12b")
    assert tp_layout(cfg, 16) == dict(attn="kv_slice", mlp=True, embed=True,
                                      head="vocab")
    defs = ModelZoo(cfg).param_defs()
    kv = {"layers/attn/wk", "layers/attn/wv"}
    named = gathered_leaves(cfg, defs, 16)
    assert {g["leaf"] for g in named} == kv, named
    assert all(g["role"] == "slice" and g["reason"] for g in named), named
    # the hybrid and encoder-decoder families split too
    # (tests/test_torch_tp_hybrid.py, tests/test_torch_tp_encdec.py)
    assert tp_layout(get_config("seamless-m4t-large-v2"), 16)["attn"] == \
        "split"
    assert tp_layout(get_config("zamba2-7b"), 16)["attn"] == "split"
