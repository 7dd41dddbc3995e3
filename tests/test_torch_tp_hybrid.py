"""The hybrid family's train, prefill and decode steps split over
"model" (``launch.train`` with ``models.parallel``,
``models.transformer.shared_attn_apply`` and ``models.mamba2``), on gloo
CPU worlds (``tests/torch_gloo.py``).

Reduced zamba2-7b (d 64, the shared block's 4 q / 2 kv heads of 16 and
d_ff 128, Mamba2 layers of 8 heads of 16 and state 16; 4 layers in 2
groups of 2, no tail) and a 5-layer variant with a tail of 1:

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model): the shared
    block's ``w_in`` column-parallel on its output d and gathered along
    d, its attention split by heads on 2 ranks and "kv_slice" on 4 (each
    rank computes the kv head its q head reads), its MLP column /
    row-parallel; the Mamba2 layers of the groups and the tail on their
    heads.  The split train step's loss, gradient norm and first moments
    (the shared block's sum the two groups' applications), the split
    prefill's logits and caches and two split decode steps' logits and
    caches equal the plain calls within ``PERF.md`` §2's bars (loss
    within rel 2e-3, gradients within rtol 5e-2 / atol 5e-4, logits
    within 2e-2) and ``tests/test_torch_models_zoo.py``'s cache bar (ten
    bf16 ulps of each leaf's max |plain|).  A gradient leaf over the
    elementwise bar is held as ``tests/test_torch_train_zoo.py`` holds
    such a leaf against the reference: within ``GRAD_WITNESS_RATIO`` ×
    the plain step's own parting (its largest error against the same
    step with an f32 forward, the embedding's bf16 cast left out) and
    within the bar taken at the leaf's largest |gradient|; a cache leaf
    over its bar, within ``GRAD_WITNESS_RATIO`` × the plain calls' own
    parting from the same calls with an f32 forward.  Here the split's
    gradients part from the plain step's by 1.8–7.3 % of a leaf's norm,
    as the plain step's part from the f32 forward's by 1.8–5.6 % (bf16
    rounding through the shared block's attention and the scans at this
    gain; the test prints both): a few elements of the groups' ``out_proj``
    and the shared ``wv`` and the embedding lie past the elementwise
    bar, and the tail's state (the last layer's, after two decode steps)
    past the cache bar.  ``in_proj`` and the conv run at ``GAIN`` × their initial
    weights, as ``tests/test_torch_tp_ssm.py`` runs them.  The prompt
    is 19 tokens for the 4-layer config (prefill's caches replicated
    over "model", decode's first step on the sequence split over it at
    20 slots, its second replicated at 21) and 20 for the 5-layer one
    (prefill's caches handed out by the sequence, an all-to-all where
    the heads split; decode at 21 and 22 slots).  The decode steps'
    greedy tokens are the plain chain's where the plain logits' top two
    lie further apart than twice the step's logit error, else one of the
    tied ones (``tests/test_torch_tp_decode.py``'s rule); both chains go
    on with the plain chain's token.  The caches lie as ``cache_defs`` +
    ``fit_spec_to_shape`` place them, in and out, and a decode step's
    collectives are counted: none moves a K/V cache or a state;
  * on a one-rank mesh three split train steps, the split prefill and
    two split decode steps of both configs equal the plain calls bit for
    bit;
  * ``tp_layout``, ``leaf_roles`` and ``gathered_leaves`` of every
    zamba2-7b leaf on 2, 4 and 16 ranks (the published widths: 32 q /
    32 kv heads of 112, d_ff 14,336, 112 Mamba2 heads, N 64, the groups'
    and the tail's stacked leaves) and of the reduced config, and the
    encoder-decoder family's split layout.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
CACHE_REL = 10 * 2.0 ** -8   # its CACHE_REL: ten bf16 ulps of max |ref|
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4
GRAD_WITNESS_RATIO = 2.0  # tests/test_torch_train_zoo.py's
GAIN = 6.0

CONFIGS = """
import dataclasses
import numpy as np
from repro_torch.configs import get_config

# reduced zamba2-7b: 2 groups of 2, no tail; and 2 groups of 2 + a tail
# of 1, with the prompt length each runs at
CONFIGS = ((get_config("zamba2-7b").reduced(), 19),
           (dataclasses.replace(get_config("zamba2-7b").reduced(),
                                num_layers=5), 20))


def gain(params, g):
    # in_proj and the conv scaled up from init's std 0.02, at which the
    # scan's B and C terms are lost beside D·x; in place, DTensors or not
    with torch.no_grad():
        for stack in ("groups", "tail"):
            for name in ("in_proj", "conv_w"):
                if stack in params:
                    params[stack]["mamba"][name].mul_(g)
    return params
"""

SPLIT = CONFIGS + """
import contextlib
import json
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_mesh_from_devices, make_prefill_step,
                                make_train_step, widen_mesh_caches)
from repro_torch.launch.hloanalysis import OpCounter
from repro_torch.launch.train import (_cache_placements, _compute_view,
                                      _tensor_parallel)
from repro_torch.models import ModelZoo, transformer, widen_caches
from repro_torch.models.parallel import gathered_leaves
from repro_torch.models.transformer import hybrid_layout

bf16_embed = transformer.hidden_for_tokens


@contextlib.contextmanager
def f32_forward():
    # the plain calls' own rounding: the same calls with an f32 forward
    # (the embedding's bf16 cast left out)
    transformer.hidden_for_tokens = (
        lambda params, tokens, cfg, tp=None: params["embed"][tokens.long()])
    try:
        yield
    finally:
        transformer.hidden_for_tokens = bf16_embed


mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


def cache_parting(got, want, own):
    got, want, own = got.float(), want.float(), own.float()
    err = float((got - want).abs().max())
    return dict(excess=err - CACHE_REL * float(want.abs().max()), err=err,
                own=float((want - own).abs().max()))


def compare(cfg, got_l, got_c, want_l, want_c, own_c):
    flat = tree_flatten_with_path(got_c)
    return dict(
        logits=excess(got_l.full_tensor(), want_l),
        cache={"/".join(path): cache_parting(a.full_tensor(), b, c)
               for (path, a), b, c in zip(flat, tree_leaves(want_c),
                                          tree_leaves(own_c))},
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


out = {}
for cfg, prompt_len in CONFIGS:
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
    prompt = {"tokens": batch["tokens"][:, :prompt_len]}

    tp, roles = _tensor_parallel(cfg, mesh, p_m)
    held = {"/".join(path): [list(_compute_view(t, r, mesh).shape),
                             list(t.shape), r[0]]
            for (path, t), r in zip(tree_flatten_with_path(p_m),
                                    tree_leaves(roles))}

    step = make_train_step(cfg)
    _, opt_m, m_m = step(p_m, o_m, batch, 1000)
    _, opt_p, m_p = step(p, o, batch, 1000)
    with f32_forward():
        _, opt_32, _ = step(p, o, batch, 1000)
    grads = {}
    for (path, a), b, c in zip(tree_flatten_with_path(opt_m["mu"]),
                               tree_leaves(opt_p["mu"]),
                               tree_leaves(opt_32["mu"])):
        a, b, c = a.full_tensor() / (1 - B1), b / (1 - B1), c / (1 - B1)
        err = (a - b).abs()
        grads["/".join(path)] = dict(
            excess=float((err - (GRAD_ATOL + GRAD_RTOL * b.abs())).max()),
            err=float(err.max()), own=float((b - c).abs().max()),
            leaf_bar=GRAD_ATOL + GRAD_RTOL * float(b.abs().max()),
            rel_norm=float((a - b).norm() / b.norm()),
            own_rel_norm=float((b - c).norm() / b.norm()))

    named = gathered_leaves(cfg, zoo.param_defs(), SHAPE[1])
    groups, _, tail = hybrid_layout(cfg)

    def want_ops(seq_split):
        # per group: w_in's output, q, k and v gathered, wo and the MLP
        # all-reduced, and the combine's three where "model" splits the
        # sequence; per Mamba2 layer the new token's raw [x | B | C]
        # gathered, Σy² and out_proj all-reduced; the conv tails
        # gathered at once (groups, tail); the gathered leaves, the
        # embedding along d and the logits over the vocabulary
        return {"all-gather": 4 * groups + cfg.num_layers + 1 + bool(tail)
                + len(named) + 2,
                "all-reduce": (2 + 3 * seq_split) * groups
                + 2 * cfg.num_layers,
                "all-to-all": 0}

    with torch.no_grad():
        got_l, got_c = make_prefill_step(cfg)(p_m, prompt)
        want_l, want_c = zoo.prefill(p, prompt)
        with f32_forward():
            _, own_c = zoo.prefill(p, prompt)
        res = {"prefill": compare(cfg, got_l, got_c, want_l, want_c, own_c)}
        for n in range(2):
            res[f"greedy{n}"] = greedy(got_l, want_l)
            tok = want_l.argmax(-1).to(torch.int32)
            got_in = widen_mesh_caches(cfg, got_c)
            seq = got_in["shared_kv"].shape[3]
            with OpCounter() as counter:
                got_l, got_c = make_decode_step(cfg)(p_m, got_in,
                                                     {"tokens": tok})
            want_l, want_c = zoo.decode(p, widen_caches(want_c),
                                        {"tokens": tok})
            with f32_forward():
                _, own_c = zoo.decode(p, widen_caches(own_c),
                                      {"tokens": tok})
            res[f"decode{n}"] = compare(cfg, got_l, got_c, want_l, want_c,
                                        own_c)
            res[f"decode{n}"]["ops"] = {
                k: counter.collective_stats()[k]["count"]
                for k in ("all-gather", "all-reduce", "all-to-all")}
            res[f"decode{n}"]["want_ops"] = want_ops(seq % SHAPE[1] == 0)
            res[f"decode{n}"]["seq"] = seq
    res.update(
        layout=dict(attn=tp.attn, mlp=tp.mlp, embed=tp.embed, head=tp.head,
                    ssm=tp.ssm),
        held=held, tail=tail, prompt=prompt_len,
        loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
        / abs(float(m_p["loss"])),
        gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
        / abs(float(m_p["grad_norm"])),
        grads=grads, all_reduces=m_m["all_reduces"],
        model_all_reduces=m_m["model_all_reduces"],
        leaves=len(tree_leaves(p)))
    out[str(cfg.num_layers)] = res
if RANK == 0:
    with open(WORKDIR + "/hybrid.json", "w") as f:
        json.dump(out, f)
"""

# the leaves each rank computes with its "model" shard of, by the
# dimension "model" divides (the stacked leaves' dims counted from the
# end), on 2 and on 4 ranks; the fused Mamba2 leaves and, on 4, the
# shared block's wk / wv sliced; every other whole
SPLIT_LEAVES = {"embed": -1, "head": -1, "shared_attn/w_in": -1,
                "shared_attn/attn/wq": -1, "shared_attn/attn/wo": -2,
                "shared_attn/mlp/w1": -1, "shared_attn/mlp/w3": -1,
                "shared_attn/mlp/w2": -2}
for _stack in ("groups", "tail"):
    SPLIT_LEAVES.update({f"{_stack}/mamba/{k}": -1 for k in
                         ("A_log", "D", "dt_bias", "norm_g")})
    SPLIT_LEAVES[f"{_stack}/mamba/out_proj"] = -2
# per rank of m: in_proj's z, x and dt of its heads and N/m of B and C;
# the conv's x of its heads and the whole B and C; on 4 ranks the one kv
# head of 16 columns that a rank's q head reads
SLICED = {"mamba/in_proj": lambda m: 2 * 128 // m + 2 * 16 // m + 8 // m,
          "mamba/conv_w": lambda m: 128 // m + 2 * 16,
          "mamba/conv_b": lambda m: 128 // m + 2 * 16}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_hybrid_split_steps_on_four_ranks_match_the_plain_calls(tmp_path,
                                                                shape):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"SHAPE = {shape}\nTOL = {SERVE_TOL}\nGAIN = {GAIN}\n"
                    f"CACHE_REL = {CACHE_REL}\n"
                    f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + SPLIT, 4, tmp_path,
                    timeout=400)
    assert_ranks_ok(res)
    out = json.loads((tmp_path / "hybrid.json").read_text())
    model, data = shape[1], shape[0]
    assert sorted(out) == ["4", "5"], sorted(out)
    for layers, r in out.items():
        attn = "split" if model == 2 else "kv_slice"
        assert r["layout"] == dict(attn=attn, mlp=True, embed=True,
                                   head="vocab", ssm=True), r
        assert r["tail"] == (1 if layers == "5" else 0), r
        sliced = 0
        for leaf, (compute, full, role) in r["held"].items():
            stem = leaf.split("/", 1)[-1]
            if leaf in SPLIT_LEAVES or (model == 2 and stem in (
                    "attn/wk", "attn/wv")):
                d = SPLIT_LEAVES.get(leaf, -1) % len(full)
                assert role == "split", (leaf, role)
                assert compute[d] * model == full[d], (leaf, compute, full)
                assert compute[:d] + compute[d + 1:] == full[:d] + \
                    full[d + 1:], (leaf, compute, full)
            elif stem in SLICED or stem in ("attn/wk", "attn/wv"):
                want = SLICED[stem](model) if stem in SLICED else 16
                assert role == "slice", (leaf, role)
                assert compute[-1] == want, (leaf, compute)
                assert compute[:-1] == full[:-1], (leaf, compute, full)
                sliced += 1
            else:
                assert role == "gathered" and compute == full, (leaf,
                                                                compute)
        assert sliced == 3 * (1 + (layers == "5")) + 2 * (model == 4), r
        assert r["all_reduces"] == r["leaves"] + 1, r
        # the norm's all-reduce over "model", and one per sliced leaf
        assert r["model_all_reduces"] == 1 + sliced, r
        assert r["loss_rel"] <= LOSS_REL, r
        assert r["gnorm_rel"] <= GRAD_RTOL, r
        over = {k: g for k, g in r["grads"].items() if g["excess"] > 0}
        norms = [(g["rel_norm"], g["own_rel_norm"])
                 for g in r["grads"].values()]
        print(f"{shape} × {layers} layers: gradients' parting by the leaf's "
              "norm, split from plain",
              [min(n[0] for n in norms), max(n[0] for n in norms)],
              "plain from the f32 forward",
              [min(n[1] for n in norms), max(n[1] for n in norms)],
              "; leaves over the elementwise bar", over,
              "serving excess (<= 0 holds)",
              {k: (r[k]["logits"], {c: g["excess"] for c, g in
                                    r[k]["cache"].items()})
               for k in ("prefill", "decode0", "decode1")},
              "greedy", r["greedy0"], r["greedy1"])
        for leaf, g in over.items():
            assert g["err"] <= GRAD_WITNESS_RATIO * g["own"], (leaf, g)
            assert g["err"] <= g["leaf_bar"], (leaf, g)
        for part in ("prefill", "decode0", "decode1"):
            c = r[part]
            assert c["logits"] <= 0.0, (part, c)
            for leaf, g in c["cache"].items():
                assert g["excess"] <= 0.0 or \
                    g["err"] <= GRAD_WITNESS_RATIO * g["own"], (part, leaf, g)
            assert c["placed"], (part, c)
            # batch 4 over the data ranks; the states' 8 heads and the
            # conv tails' 160 channels over the model ranks; shared_kv's
            # sequence over them where "model" divides it
            seq = r["prompt"] + (0 if part == "prefill" else
                                 1 + int(part[-1]))
            want = {"mamba/conv": [2, 2, 4 // data, 3, 160 // model],
                    "mamba/state": [2, 2, 4 // data, 8 // model, 16, 16],
                    "shared_kv": [2, 2, 4 // data,
                                  seq // model if seq % model == 0 else seq,
                                  2, 16]}
            if layers == "5":
                want.update({"mamba_tail/conv": [1, 4 // data, 3,
                                                 160 // model],
                             "mamba_tail/state": [1, 4 // data, 8 // model,
                                                  16, 16]})
            assert c["local"] == want, (part, c["local"])
        for n in range(2):
            assert r[f"greedy{n}"]["ok"], r[f"greedy{n}"]
            assert r[f"decode{n}"]["ops"] == r[f"decode{n}"]["want_ops"], \
                r[f"decode{n}"]
    # both prefill paths and both decode paths ran
    assert [out["4"]["decode0"]["seq"], out["4"]["decode1"]["seq"],
            out["5"]["decode0"]["seq"]] == [20, 21, 21]


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
for cfg, prompt_len in CONFIGS:
    p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
    p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                            device="cpu")
    p_m, p = gain(p_m, GAIN), gain(p, GAIN)
    tp, _ = _tensor_parallel(cfg, mesh, p_m)
    assert (tp.size, tp.attn, tp.mlp, tp.ssm, tp.embed) == (
        1, "split", True, True, True), tp
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 64))
    batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
             "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                    dtype=torch.int32)}
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
    prompt = {"tokens": batch["tokens"][:, :prompt_len]}
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
            want_l, want_c = zoo.decode(p, widen_caches(want_c),
                                        {"tokens": tok})
            got_l, got_c = make_decode_step(cfg)(
                p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok})
print("HYBRID_ONE_RANK_OK")
"""


def test_hybrid_split_steps_on_one_rank_are_bit_identical(tmp_path):
    res = run_ranks(f"GAIN = {GAIN}\n" + ONE_RANK, 1, tmp_path)
    assert_ranks_ok(res)
    assert "HYBRID_ONE_RANK_OK" in res[0][1]


@pytest.mark.parametrize("size", [2, 4, 16])
def test_hybrid_layout_and_roles(size):
    """Every zamba2-7b leaf's role at its published widths: the shared
    block's ``w_in`` split on its output d (``("fsdp", "model")`` in the
    reference), its attention (32 q / 32 kv heads) and MLP (d_ff 14,336)
    split as the dense blocks, the embedding on d and the untied head on
    the padded vocabulary; the Mamba2 leaves of the 13 groups of 6 and
    of the tail of 3 (stacked twice and once: their roles' dims count
    from the end) on their heads, ``in_proj`` and the conv sliced to the
    rank's columns; the norms whole.  ``gathered_leaves`` names only the
    sliced Mamba2 leaves, of the groups and of the tail."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, leaf_roles,
                                             tp_layout)
    from repro_torch.models.transformer import hybrid_layout
    cfg = get_config("zamba2-7b")
    assert hybrid_layout(cfg) == (13, 6, 3)
    assert tp_layout(cfg, size) == dict(attn="split", mlp=True, embed=True,
                                        head="vocab", ssm=True)
    defs = ModelZoo(cfg).param_defs()
    width = {"in_proj": 2 * 7168 + 2 * 64 + 112, "conv_w": 7168 + 128,
             "conv_b": 7168 + 128}
    for rank in range(size):
        roles = leaf_roles(cfg, defs, size, rank)
        assert roles["embed"] == roles["head"] == ("split", -1)
        shared = roles["shared_attn"]
        assert shared["w_in"] == ("split", -1)
        assert shared["ln1"] == shared["ln2"] == ("gathered",)
        for w in ("wq", "wk", "wv"):
            assert shared["attn"][w] == ("split", -1), (w, shared)
        assert shared["attn"]["wo"] == ("split", -2)
        assert shared["mlp"]["w1"] == shared["mlp"]["w3"] == ("split", -1)
        assert shared["mlp"]["w2"] == ("split", -2)
        for stack in ("groups", "tail"):
            assert roles[stack]["ln1"] == ("gathered",)
            mamba = roles[stack]["mamba"]
            for name in ("A_log", "D", "dt_bias", "norm_g"):
                assert mamba[name] == ("split", -1), (stack, name, mamba)
            assert mamba["out_proj"] == ("split", -2)
            for name, w in width.items():
                kind, dim, ranges = mamba[name]
                assert (kind, dim) == ("slice", -1), mamba[name]
                assert defs[stack]["mamba"][name].shape[-1] == w
                assert all(0 <= lo < hi <= w for lo, hi in ranges)
        # the same columns in the groups and the tail
        assert roles["groups"]["mamba"] == roles["tail"]["mamba"]
    # w_in (2d, d) by its output d, the shared K/V by whole kv heads
    assert defs["shared_attn"]["w_in"].shape == (7168, 3584)
    assert defs["shared_attn"]["w_in"].spec == ("fsdp", "model")
    assert 3584 % size == 0 and 32 % size == 0 and 14336 % size == 0
    named = {g["leaf"]: g for g in gathered_leaves(cfg, defs, size)}
    assert sorted(named) == sorted(f"{s}/mamba/{k}" for s in ("groups",
                                                               "tail")
                                   for k in ("conv_b", "conv_w",
                                             "in_proj")), named
    assert all(g["role"] == "slice" and "across their bounds" in g["reason"]
               for g in named.values()), named
    assert "14576 [z | x | B | C | dt] columns" in \
        named["tail/mamba/in_proj"]["reason"]


def test_hybrid_layout_at_the_reduced_width_and_the_gathered_family():
    """Reduced zamba2-7b (4 q / 2 kv heads): the shared attention split on
    2 ranks and "kv_slice" on 4 (ranks 2r and 2r + 1 read kv head r),
    named so; on one rank every "model"-tagged leaf is its whole shard;
    ``_check_tp`` takes the hybrid and the encoder-decoder family, which
    splits too, no leaf of seamless-m4t-large-v2 named on 16 ranks
    (``tests/test_torch_tp_encdec.py``), and refuses a family it does
    not know."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (TensorParallel,
                                             gathered_leaves, kv_head_range,
                                             leaf_roles, tp_layout)
    from repro_torch.models.transformer import _check_tp
    cfg = get_config("zamba2-7b").reduced()
    defs = ModelZoo(cfg).param_defs()
    assert tp_layout(cfg, 2)["attn"] == "split"
    assert tp_layout(cfg, 4)["attn"] == "kv_slice"
    assert [kv_head_range(cfg, 4, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    shared = leaf_roles(cfg, defs, 4, 3)["shared_attn"]["attn"]
    assert shared["wk"] == shared["wv"] == ("slice", -1, ((16, 32),))
    named = {g["leaf"]: g["reason"] for g in gathered_leaves(cfg, defs, 4)}
    assert named["shared_attn/attn/wk"] == (
        "2 kv heads on 4 ranks: each rank computes the kv heads its q "
        "heads read"), named
    assert sorted(named) == ["groups/mamba/conv_b", "groups/mamba/conv_w",
                             "groups/mamba/in_proj", "shared_attn/attn/wk",
                             "shared_attn/attn/wv"], named
    roles = leaf_roles(cfg, defs, 1, 0)
    from repro_torch._tree import tree_flatten_with_path
    for path, d in tree_flatten_with_path(defs):
        role = roles
        for k in path:
            role = role[k]
        assert role[0] == ("split" if "model" in d.spec else "gathered"), (
            path, role)
    assert gathered_leaves(cfg, defs, 1) == []
    # 3 q heads on 2 ranks: the shared attention stays gathered, named so
    import dataclasses
    odd = dataclasses.replace(get_config("zamba2-7b"), num_heads=24,
                              num_kv_heads=24, d_ff=14334)
    layout = tp_layout(odd, 16)
    assert (layout["attn"], layout["mlp"], layout["ssm"]) == (
        "gathered", False, True), layout
    named = {g["leaf"]: g["reason"] for g in
             gathered_leaves(odd, ModelZoo(odd).param_defs(), 16)}
    assert named["shared_attn/attn/wq"] == "24 q heads on 16 ranks"
    assert named["shared_attn/mlp/w2"] == "d_ff 14334 on 16 ranks"
    tp = TensorParallel(None, 1, 0, **tp_layout(cfg, 1))
    _check_tp(tp, cfg)
    seamless = get_config("seamless-m4t-large-v2")
    assert tp_layout(seamless, 16) == dict(attn="split", mlp=True,
                                           embed=True, head="vocab")
    _check_tp(tp, seamless)
    assert gathered_leaves(seamless, ModelZoo(seamless).param_defs(),
                           16) == []
    with pytest.raises(ValueError, match="encoder-decoder families, not"):
        _check_tp(tp, dataclasses.replace(cfg, family="retrieval"))
