"""The encoder-decoder family's train, prefill and decode steps split over
"model" (``launch.train`` with ``models.parallel`` and
``models.transformer.cross_attn_apply``), on gloo CPU worlds
(``tests/torch_gloo.py``).

Reduced seamless-m4t-large-v2 (d 64, 4 q / 2 kv heads of 16, d_ff 128,
2 encoder and 2 decoder layers, vocabulary 512):

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model): the
    encoder's and the decoder's self-attention and MLPs split as the
    dense blocks (attention by heads on 2 ranks, "kv_slice" on 4: each
    rank computes the kv head its q head reads), the cross-attention
    column / row-parallel by heads, its q from the decoder's stream and
    its k / v from the encoder's output, each through ``copy_to_model``.
    The split train step's loss, gradient norm and first moments (the
    encoder's leaves named in the check: their gradients reach them only
    through the cross-attention), the split prefill's logits and caches
    and two split decode steps' logits and caches equal the plain calls
    within ``PERF.md`` §2's bars (loss within rel 2e-3, gradients within
    rtol 5e-2 / atol 5e-4, logits within 2e-2) and
    ``tests/test_torch_models_zoo.py``'s cache bar (ten bf16 ulps of
    each leaf's max |plain|).  The source is longer or shorter than the
    tokens (96 frames for 64 train tokens; two serving chains, a prompt
    of 19 with 24 source frames and a prompt of 20 with 17), so that
    ``cross_kv`` is placed by its own length: split over "model" where
    "model" divides the source (24 on 2 and 4 ranks), replicated where
    not (17), on every step of a chain, while the self cache is split at
    the lengths "model" divides and replicated at the others (19 → 20 →
    21 and 20 → 21 → 22): on 4 ranks the first chain's second decode
    step runs with ``kv`` replicated over "model" and ``cross_kv``
    split.  The decode steps' greedy tokens are the plain chain's where
    the plain logits' top two lie further apart than twice the step's
    logit error, else one of the tied ones
    (``tests/test_torch_tp_decode.py``'s rule); both chains go on with
    the plain chain's token.  The caches lie as ``cache_defs`` +
    ``fit_spec_to_shape`` place them, in and out, and a decode step's
    collectives are counted: none moves a cache;
  * on a one-rank mesh three split train steps, the split prefill and
    two split decode steps of both chains equal the plain calls bit for
    bit;
  * ``tp_layout``, ``leaf_roles`` and ``gathered_leaves`` of every
    seamless-m4t-large-v2 leaf on 2, 4 and 16 ranks (the published
    widths: 16 q / 16 kv heads of 64, d_ff 8,192, d 1,024, the padded
    vocabulary 256,256; ``xattn`` as ``attn``, no leaf gathered) and of
    the reduced config ("kv_slice" on 4 ranks, the three attention
    blocks' kv projections named).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
CACHE_REL = 10 * 2.0 ** -8   # its CACHE_REL: ten bf16 ulps of max |ref|
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4
# (prompt, source) lengths of the serving chains
CHAINS = ((19, 24), (20, 17))

CONFIGS = """
import numpy as np
from repro_torch.configs import get_config

cfg = get_config("seamless-m4t-large-v2").reduced()


def batch_of(seed, b, s, src):
    # tokens and labels of b x s, source frames of b x src, from a seed
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    frames = rng.normal(0, 1, (b, src, cfg.d_model))
    return {"tokens": torch.tensor(toks, dtype=torch.int32),
            "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                   dtype=torch.int32),
            "src_embeds": torch.tensor(frames, dtype=torch.float32
                                       ).to(torch.bfloat16)}
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
model = SHAPE[1]


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


def compare(got_l, got_c, want_l, want_c):
    flat = tree_flatten_with_path(got_c)
    return dict(
        logits=excess(got_l.full_tensor(), want_l),
        cache={"/".join(path): (
            float((a.full_tensor().float() - b.float()).abs().max())
            - CACHE_REL * float(b.float().abs().max()))
            for (path, a), b in zip(flat, tree_leaves(want_c))},
        placed=all(tuple(a.placements) == tuple(_cache_placements(
            cfg, mesh, path, a.shape)) for path, a in flat),
        local={"/".join(path): list(a.to_local().shape)
               for path, a in flat})


def greedy(got_l, want_l):
    got_full = got_l.full_tensor()
    err = float((got_full - want_l).abs().max())
    top2 = want_l.topk(2, dim=-1).values
    got_t = got_full.argmax(-1)
    picked = want_l.gather(-1, got_t[..., None])[..., 0]
    decided = top2[..., 0] - top2[..., 1] > 2 * err
    same = got_t == want_l.argmax(-1)
    near = picked >= top2[..., 0] - 2 * err
    return dict(ok=bool(torch.where(decided, same, near).all()),
                decided=int(decided.sum()), same=int(same.sum()))


p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
zoo = ModelZoo(cfg)
batch = batch_of(3, 4, 64, 96)
tp, roles = _tensor_parallel(cfg, mesh, p_m)
held = {"/".join(path): [list(_compute_view(t, r, mesh).shape),
                         list(t.shape), r[0]]
        for (path, t), r in zip(tree_flatten_with_path(p_m),
                                tree_leaves(roles))}

step = make_train_step(cfg)
_, opt_m, m_m = step(p_m, o_m, batch, 1000)
_, opt_p, m_p = step(p, o, batch, 1000)
grads = {}
for (path, a), b in zip(tree_flatten_with_path(opt_m["mu"]),
                        tree_leaves(opt_p["mu"])):
    a, b = a.full_tensor() / (1 - B1), b / (1 - B1)
    err = (a - b).abs()
    grads["/".join(path)] = dict(
        excess=float((err - (GRAD_ATOL + GRAD_RTOL * b.abs())).max()),
        rel_norm=float((a - b).norm() / b.norm()))

named = gathered_leaves(cfg, zoo.param_defs(), model)
layers = cfg.decoder_layers


def want_ops(kv_split, cross_split):
    # per decoder layer: the self-attention's q, k and v gathered, its
    # wo all-reduced and the combine's three where "model" splits the
    # self cache's sequence; the cross-attention's q gathered, its wo
    # all-reduced and the combine's three where "model" splits the
    # source's; the MLP all-reduced; the gathered leaves, the embedding
    # along d and the logits over the vocabulary
    return {"all-gather": 4 * layers + len(named) + 2,
            "all-reduce": layers * (3 + 3 * kv_split + 3 * cross_split),
            "all-to-all": 0}


res = {}
with torch.no_grad():
    for prompt_len, src_len in CHAINS:
        serve = batch_of(prompt_len, 4, prompt_len, src_len)
        serve = {k: serve[k] for k in ("tokens", "src_embeds")}
        got_l, got_c = make_prefill_step(cfg)(p_m, serve)
        want_l, want_c = zoo.prefill(p, serve)
        chain = {"prefill": compare(got_l, got_c, want_l, want_c)}
        for n in range(2):
            chain[f"greedy{n}"] = greedy(got_l, want_l)
            tok = want_l.argmax(-1).to(torch.int32)
            got_in = widen_mesh_caches(cfg, got_c)
            seq = got_in["kv"].shape[3]
            with OpCounter() as counter:
                got_l, got_c = make_decode_step(cfg)(p_m, got_in,
                                                     {"tokens": tok})
            want_l, want_c = zoo.decode(p, widen_caches(want_c),
                                        {"tokens": tok})
            c = chain[f"decode{n}"] = compare(got_l, got_c, want_l, want_c)
            c["ops"] = {k: counter.collective_stats()[k]["count"]
                        for k in ("all-gather", "all-reduce", "all-to-all")}
            c["want_ops"] = want_ops(seq % model == 0, src_len % model == 0)
            c["seq"] = seq
        res[f"{prompt_len}/{src_len}"] = chain
res.update(
    layout=dict(attn=tp.attn, mlp=tp.mlp, embed=tp.embed, head=tp.head),
    held=held,
    loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
    / abs(float(m_p["loss"])),
    gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
    / abs(float(m_p["grad_norm"])),
    grads=grads, all_reduces=m_m["all_reduces"],
    model_all_reduces=m_m["model_all_reduces"], leaves=len(tree_leaves(p)))
if RANK == 0:
    with open(WORKDIR + "/encdec.json", "w") as f:
        json.dump(res, f)
"""

# the leaves each rank computes with its "model" shard of, by the
# dimension "model" divides; on 4 ranks the three attention blocks' wk /
# wv sliced to the kv head a rank's q head reads; every other whole
SPLIT_LEAVES = {"embed": -1, "head": -1}
for _block in ("encoder/attn", "decoder/attn", "decoder/xattn"):
    SPLIT_LEAVES.update({f"{_block}/wq": -1, f"{_block}/wo": -2})
for _stack in ("encoder", "decoder"):
    SPLIT_LEAVES.update({f"{_stack}/mlp/w1": -1, f"{_stack}/mlp/w3": -1,
                         f"{_stack}/mlp/w2": -2})
KV_LEAVES = {f"{b}/{w}" for b in ("encoder/attn", "decoder/attn",
                                  "decoder/xattn") for w in ("wk", "wv")}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_encdec_split_steps_on_four_ranks_match_the_plain_calls(tmp_path,
                                                                shape):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"SHAPE = {shape}\nTOL = {SERVE_TOL}\n"
                    f"CACHE_REL = {CACHE_REL}\nCHAINS = {CHAINS}\n"
                    f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + SPLIT, 4, tmp_path,
                    timeout=400)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "encdec.json").read_text())
    model, data = shape[1], shape[0]
    attn = "split" if model == 2 else "kv_slice"
    assert r["layout"] == dict(attn=attn, mlp=True, embed=True,
                               head="vocab"), r["layout"]
    sliced = 0
    for leaf, (compute, full, role) in r["held"].items():
        if leaf in SPLIT_LEAVES or (model == 2 and leaf in KV_LEAVES):
            d = SPLIT_LEAVES.get(leaf, -1) % len(full)
            assert role == "split", (leaf, role)
            assert compute[d] * model == full[d], (leaf, compute, full)
            assert compute[:d] + compute[d + 1:] == full[:d] + \
                full[d + 1:], (leaf, compute, full)
        elif leaf in KV_LEAVES:
            # the one kv head of 16 columns that a rank's q head reads
            assert role == "slice" and compute == full[:-1] + [16], (
                leaf, role, compute)
            sliced += 1
        else:
            assert role == "gathered" and compute == full, (leaf, compute)
    assert sliced == (6 if model == 4 else 0), r["held"]
    assert r["all_reduces"] == r["leaves"] + 1, r
    # the norm's all-reduce over "model", and one per sliced leaf
    assert r["model_all_reduces"] == 1 + sliced, r
    assert r["loss_rel"] <= LOSS_REL, r
    assert r["gnorm_rel"] <= GRAD_RTOL, r
    norms = [g["rel_norm"] for g in r["grads"].values()]
    print(f"{shape}: gradients' parting by the leaf's norm, split from "
          f"plain {[min(norms), max(norms)]}; serving excess (<= 0 holds)",
          {c: {k: (r[c][k]["logits"], r[c][k]["cache"])
               for k in ("prefill", "decode0", "decode1")}
           for c in r if "/" in c})
    # the encoder's leaves reach the loss only through every decoder
    # layer's cross-attention: a missed sum over "model" of the encoder
    # output's gradient would show here
    encoder = [k for k in r["grads"] if k.startswith("encoder/")]
    assert len(encoder) == 2 + 4 + 3, encoder   # ln1, ln2, attn, mlp
    for leaf, g in r["grads"].items():
        assert g["excess"] <= 0.0, (leaf, g)
    for prompt_len, src_len in CHAINS:
        chain = r[f"{prompt_len}/{src_len}"]
        for part in ("prefill", "decode0", "decode1"):
            c = chain[part]
            assert c["logits"] <= 0.0, (part, c)
            assert all(e <= 0.0 for e in c["cache"].values()), (part, c)
            assert c["placed"], (part, c)
            # batch 4 over the data ranks; each K/V cache's sequence over
            # the model ranks where "model" divides it
            seq = prompt_len + (0 if part == "prefill" else 1 + int(part[-1]))
            on = lambda s: s // model if s % model == 0 else s
            assert c["local"] == {
                "kv": [2, 2, 4 // data, on(seq), 2, 16],
                "cross_kv": [2, 2, 4 // data, on(src_len), 2, 16]}, (
                part, c["local"])
        for n in range(2):
            assert chain[f"greedy{n}"]["ok"], chain[f"greedy{n}"]
            assert chain[f"decode{n}"]["ops"] == \
                chain[f"decode{n}"]["want_ops"], chain[f"decode{n}"]
    # the self cache split and replicated, cross_kv split and replicated;
    # on 4 ranks a step with kv replicated and cross_kv split
    assert [r["19/24"]["decode0"]["seq"], r["19/24"]["decode1"]["seq"],
            r["20/17"]["decode0"]["seq"]] == [20, 21, 21]
    assert r["19/24"]["decode1"]["local"]["kv"][3] == 21
    assert r["19/24"]["decode1"]["local"]["cross_kv"][3] == 24 // model


ONE_RANK = CONFIGS + """
from repro_torch._tree import tree_leaves
from repro_torch.ft import remesh
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_prefill_step, make_train_step,
                                widen_mesh_caches)
from repro_torch.launch.train import _tensor_parallel
from repro_torch.models import ModelZoo, widen_caches

mesh = remesh([0], model_size=1, device_type="cpu")
bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else (
    t.view(torch.int16) if t.is_floating_point() else t)
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
tp, _ = _tensor_parallel(cfg, mesh, p_m)
assert (tp.size, tp.attn, tp.mlp, tp.embed, tp.head) == (
    1, "split", True, True, "vocab"), tp
batch = batch_of(5, 2, 64, 32)
step = make_train_step(cfg)
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
    for prompt_len, src_len in CHAINS:
        serve = batch_of(prompt_len, 2, prompt_len, src_len)
        serve = {k: serve[k] for k in ("tokens", "src_embeds")}
        want_l, want_c = zoo.prefill(p, serve)
        got_l, got_c = make_prefill_step(cfg)(p_m, serve)
        for n in range(3):
            assert torch.equal(bits(got_l.full_tensor()), bits(want_l)), n
            for a, b in zip(tree_leaves(got_c), tree_leaves(want_c)):
                assert torch.equal(bits(a.full_tensor()), bits(b)), n
            if n == 2:
                break
            tok = want_l.argmax(-1).to(torch.int32)
            want_l, want_c = zoo.decode(p, widen_caches(want_c),
                                        {"tokens": tok})
            got_l, got_c = make_decode_step(cfg)(
                p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok})
print("ENCDEC_ONE_RANK_OK")
"""


def test_encdec_split_steps_on_one_rank_are_bit_identical(tmp_path):
    res = run_ranks(f"CHAINS = {CHAINS}\n" + ONE_RANK, 1, tmp_path)
    assert_ranks_ok(res)
    assert "ENCDEC_ONE_RANK_OK" in res[0][1]


@pytest.mark.parametrize("size", [2, 4, 16])
def test_encdec_layout_and_roles(size):
    """Every seamless-m4t-large-v2 leaf's role at its published widths:
    the encoder's and the decoder's self-attention and the decoder's
    cross-attention (16 q / 16 kv heads of 64) split by heads, ``wo`` by
    its rows; the MLPs (d_ff 8,192) column / row-parallel; the embedding
    on d (1,024) and the untied head on the padded vocabulary (256,256 =
    16 × 16,016); the norms whole.  No leaf is gathered."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, leaf_roles,
                                             tp_layout)
    cfg = get_config("seamless-m4t-large-v2")
    assert tp_layout(cfg, size) == dict(attn="split", mlp=True, embed=True,
                                        head="vocab")
    defs = ModelZoo(cfg).param_defs()
    assert defs["head"].shape == (1024, 256256) and 256256 % size == 0
    assert defs["decoder"]["xattn"]["wk"].shape == (24, 1024, 1024)
    assert 16 % size == 0 and 8192 % size == 0 and 1024 % size == 0
    for rank in range(size):
        roles = leaf_roles(cfg, defs, size, rank)
        assert roles["embed"] == roles["head"] == ("split", -1)
        for norm in ("final_norm", "enc_final_norm"):
            assert roles[norm] == ("gathered",)
        for stack, blocks in (("encoder", ("attn",)),
                              ("decoder", ("attn", "xattn"))):
            for block in blocks:
                for w in ("wq", "wk", "wv"):
                    assert roles[stack][block][w] == ("split", -1), (
                        stack, block, w)
                assert roles[stack][block]["wo"] == ("split", -2)
            assert roles[stack]["mlp"]["w1"] == roles[stack]["mlp"]["w3"] \
                == ("split", -1)
            assert roles[stack]["mlp"]["w2"] == ("split", -2)
            norms = ("ln1", "ln2") + (("lnx",) if stack == "decoder" else ())
            for norm in norms:
                assert roles[stack][norm] == ("gathered",), (stack, norm)
    assert gathered_leaves(cfg, defs, size) == []


def test_encdec_layout_at_the_reduced_width():
    """Reduced seamless-m4t-large-v2 (4 q / 2 kv heads): attention split
    on 2 ranks and "kv_slice" on 4 (ranks 2r and 2r + 1 read kv head r),
    the cross-attention's ``wk`` / ``wv`` as the self-attention's,
    named so; on one rank every "model"-tagged leaf is its whole shard;
    3 q heads on 2 ranks leave all three attention blocks gathered."""
    import dataclasses
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, leaf_roles,
                                             tp_layout)
    cfg = get_config("seamless-m4t-large-v2").reduced()
    defs = ModelZoo(cfg).param_defs()
    assert tp_layout(cfg, 2)["attn"] == "split"
    assert tp_layout(cfg, 4)["attn"] == "kv_slice"
    for rank in range(4):
        roles = leaf_roles(cfg, defs, 4, rank)
        want = ("slice", -1, ((rank // 2 * 16, rank // 2 * 16 + 16),))
        for stack, block in (("encoder", "attn"), ("decoder", "attn"),
                             ("decoder", "xattn")):
            assert roles[stack][block]["wk"] == roles[stack][block]["wv"] \
                == want, (stack, block, rank)
            assert roles[stack][block]["wq"] == ("split", -1)
    named = {g["leaf"]: g["reason"] for g in gathered_leaves(cfg, defs, 4)}
    assert sorted(named) == sorted(KV_LEAVES), named
    assert set(named.values()) == {
        "2 kv heads on 4 ranks: each rank computes the kv heads its q "
        "heads read"}, named
    roles = leaf_roles(cfg, defs, 1, 0)
    for path, d in tree_flatten_with_path(defs):
        role = roles
        for k in path:
            role = role[k]
        assert role[0] == ("split" if "model" in d.spec else "gathered"), (
            path, role)
    assert gathered_leaves(cfg, defs, 1) == []
    odd = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
    assert tp_layout(odd, 2)["attn"] == "gathered"
    named = {g["leaf"]: g["reason"] for g in
             gathered_leaves(odd, ModelZoo(odd).param_defs(), 2)}
    assert sorted(named) == sorted(f"{b}/{w}" for b in (
        "encoder/attn", "decoder/attn", "decoder/xattn")
        for w in ("wq", "wk", "wv", "wo")), named
    assert set(named.values()) == {"3 q heads on 2 ranks"}, named
