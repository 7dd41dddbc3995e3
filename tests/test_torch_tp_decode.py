"""Decode split over "model" as the reference lays out its caches
(``launch.train``'s serving steps with ``models.parallel`` and
``attention.decode_attention_split``), on gloo CPU worlds
(``tests/torch_gloo.py``).

  * on 4 ranks as (2 data, 2 model) and as (1 data, 4 model), for
    reduced llama3-8b (4 q / 2 kv heads: split by whole heads on 2
    ranks, each rank computing the kv head its q heads read on 4),
    reduced smollm-135m with its published 9 q / 3 kv heads (the
    attention projections stay gathered; attention still splits over
    the caches' sequence) and reduced pixtral-12b (the VLM family): the
    split decode on caches placed as ``cache_defs`` + ``fit_spec_to_shape``
    place them, at a cache length that "model" divides (each rank holds
    its slice of the sequence) and at one it does not (the caches
    replicated over "model"), against ``ModelZoo.decode`` on the whole
    caches: logits within 2e-2 and caches within the serving bar
    (``tests/test_torch_mesh_steps.py``'s, ``PERF.md`` §2), and the split
    prefill of the prompts before it (15 and 16 tokens: its caches
    gathered over the kv heads, or handed out by the sequence) within
    the same bars; the caches
    come back in that layout, each rank holding only its shard; the
    step's collectives are exactly the split's (no cache moves);
  * a prefill → widen → decode chain of 3 greedy tokens on the mesh
    (``make_prefill_step``, ``widen_mesh_caches``, ``make_decode_step``;
    the sequence split, then replicated, then split again on 2 ranks)
    gives the plain chain's tokens, where the plain logits' top two lie
    further apart than twice the step's logit error (a closer tie is
    rounding's to break, and the mesh's token must be one of the tied
    ones; both chains go on with the plain chain's token), and its
    logits and caches stay within the serving bar;
  * the combine against ``decode_attention`` on 2 and 4 ranks, with and
    without ``valid_len`` (a shard that holds only masked slots among
    them): f32 within 1e-5, bf16 within the serving bar;
  * on a one-rank mesh the split decode and the chain equal the plain
    calls bit for bit.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
F32_TOL = 1e-5            # the combine's f32 rounding against the softmax

# reduced configs: llama3-8b and pixtral-12b as .reduced() gives them
# (4 q / 2 kv heads); smollm-135m with its published 9 q / 3 kv heads at
# head_dim 8
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

DECODE = CONFIGS + """
import json
import numpy as np
from torch.distributed.tensor import distribute_tensor
from repro_torch._tree import tree_leaves
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_mesh_from_devices, make_prefill_step,
                                widen_mesh_caches)
from repro_torch.launch.hloanalysis import OpCounter
from repro_torch.launch.train import _cache_placements, _tensor_parallel
from repro_torch.models import ModelZoo, widen_caches
from repro_torch.models.parallel import gathered_leaves

cfg = config(ARCH)
mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")
zoo = ModelZoo(cfg)
p_m, _ = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, _ = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
tp, _ = _tensor_parallel(cfg, mesh, p_m)
model = SHAPE[1]
B = 4
rng = np.random.default_rng(7)


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


def bits(got, want):
    return got.dtype == want.dtype and torch.equal(got, want)


def place(caches):
    return {k: distribute_tensor(c, mesh, _cache_placements(cfg, mesh, k,
                                                            c.shape))
            for k, c in caches.items()}


# the collectives of one split decode step: per layer the new token's q,
# k and v gathered along the heads where attention splits, the combine's
# three all-reduces where "model" splits the sequence, wo's and the
# MLP's all-reduces; the embedding's gather along d, the logits' gather
# over the vocabulary (untied) or their all-reduce (tied, row-parallel);
# and one all-gather per "model"-tagged leaf that the step computes
# whole (gathered_leaves), none of a cache
named = gathered_leaves(cfg, zoo.param_defs(), model)
attn_split = tp.attn != "gathered"


def expected(seq_split):
    layers = cfg.num_layers
    return {"all-gather": len(named) + layers * 3 * attn_split + tp.embed
            + (tp.head == "vocab"),
            "all-reduce": layers * (3 * seq_split + attn_split + tp.mlp)
            + (tp.head == "rows"),
            "all-to-all": 0}


out = {"layout": tp.attn, "named": sorted(g["leaf"] for g in named),
       "cases": {}}
with torch.no_grad():
    for s0 in (S_DIVIDES - 1, S_DIVIDES):
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, s0)),
                            dtype=torch.int32)
        want_l, want_c = zoo.prefill(p, {"tokens": toks})
        pre_l, pre_c = make_prefill_step(cfg)(p_m, {"tokens": toks})
        tok = want_l.argmax(-1).to(torch.int32)
        wide = widen_caches(want_c)
        want_l2, want_c2 = zoo.decode(p, wide, {"tokens": tok})
        placed = place(wide)
        seq = s0 + 1
        seq_split = seq % model == 0
        with OpCounter() as counter:
            got_l2, got_c2 = make_decode_step(cfg)(p_m, placed,
                                                   {"tokens": tok})
        kv = got_c2["kv"]
        out["cases"][seq] = dict(
            seq_split=seq_split,
            prefill_excess=max(excess(pre_l.full_tensor(), want_l),
                               excess(pre_c["kv"].full_tensor(),
                                      want_c["kv"])),
            prefill_seq_split=pre_c["kv"].placements[1].is_shard(3),
            logits_excess=excess(got_l2.full_tensor(), want_l2),
            cache_excess=max(excess(a.full_tensor(), b) for a, b in
                             zip(tree_leaves(got_c2), tree_leaves(want_c2))),
            bit_identical=bits(got_l2.full_tensor(), want_l2) and all(
                bits(a.full_tensor(), b) for a, b in
                zip(tree_leaves(got_c2), tree_leaves(want_c2))),
            placements_kept=(tuple(kv.placements)
                             == tuple(placed["kv"].placements)),
            local_seq=kv.to_local().shape[3],
            in_local_seq=placed["kv"].to_local().shape[3],
            logits_placements=str(tuple(got_l2.placements)),
            collectives={k: counter.collective_stats()[k]["count"]
                         for k in ("all-gather", "all-reduce", "all-to-all")},
            expected=expected(seq_split))

    # a prefill -> widen -> decode chain of 3 greedy tokens
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 16)),
                        dtype=torch.int32)
    want_l, want_c = zoo.prefill(p, {"tokens": toks})
    got_l, got_c = make_prefill_step(cfg)(p_m, {"tokens": toks})
    prefill_layout = str(tuple(got_c["kv"].placements))
    steps, chain_bits = [], bits(got_l.full_tensor(), want_l)
    for _ in range(3):
        got_full = got_l.full_tensor()
        want_t = want_l.argmax(-1).to(torch.int32)
        got_t = got_full.argmax(-1).to(torch.int32)
        # a tie closer than twice this step's logit error is decided by
        # rounding, in either chain: there the mesh's token must be one
        # of the tied ones
        err = float((got_full - want_l).abs().max())
        top2 = want_l.topk(2, dim=-1).values
        picked = want_l.gather(-1, got_t.long()[..., None])[..., 0]
        steps.append(dict(
            want=want_t.flatten().tolist(), got=got_t.flatten().tolist(),
            decided=(top2[..., 0] - top2[..., 1] > 2 * err).flatten().tolist(),
            near=(picked >= top2[..., 0] - 2 * err).flatten().tolist(),
            excess=excess(got_full, want_l)))
        # both chains go on with the plain chain's token
        want_l, want_c = zoo.decode(p, widen_caches(want_c),
                                    {"tokens": want_t})
        got_l, got_c = make_decode_step(cfg)(
            p_m, widen_mesh_caches(cfg, got_c), {"tokens": want_t})
        chain_bits = chain_bits and bits(got_l.full_tensor(), want_l) and \\
            bits(got_c["kv"].full_tensor(), want_c["kv"])
    out["chain"] = dict(steps=steps, bit_identical=chain_bits,
                        prefill_layout=prefill_layout,
                        final_excess=excess(got_l.full_tensor(), want_l),
                        final_cache_excess=excess(got_c["kv"].full_tensor(),
                                                  want_c["kv"]))
if RANK == 0:
    with open(WORKDIR + "/decode.json", "w") as f:
        json.dump(out, f)
"""

# (arch, mesh) -> what "model" does to attention's projections
CASES = {
    ("llama3-8b", (2, 2)): "split",
    ("llama3-8b", (1, 4)): "kv_slice",
    ("smollm-135m", (2, 2)): "gathered",
    ("smollm-135m", (1, 4)): "gathered",
    ("pixtral-12b", (2, 2)): "split",
    ("pixtral-12b", (1, 4)): "kv_slice",
}


@pytest.mark.parametrize("arch,shape", sorted(CASES))
def test_split_decode_on_four_ranks_matches_the_plain_decode(tmp_path, arch,
                                                             shape):
    res = run_ranks(f"ARCH = {arch!r}\nSHAPE = {shape}\nTOL = {SERVE_TOL}\n"
                    "S_DIVIDES = 16\n" + DECODE, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "decode.json").read_text())
    model = shape[1]
    assert r["layout"] == CASES[(arch, shape)], r["layout"]
    if r["layout"] == "gathered":
        assert r["named"] == ["layers/attn/" + w
                              for w in ("wk", "wo", "wq", "wv")], r
    cases = r["cases"]
    assert sorted(cases) == ["16", "17"]
    assert cases["16"]["seq_split"] and not cases["17"]["seq_split"]
    for seq, c in cases.items():
        assert c["logits_excess"] <= 0.0, (seq, c)
        assert c["cache_excess"] <= 0.0, (seq, c)
        assert c["placements_kept"], (seq, c)
        assert c["logits_placements"] == "(Shard(dim=0), Replicate())", c
        # the prefill before it, of seq - 1 tokens, in the decode layout
        assert c["prefill_excess"] <= 0.0, (seq, c)
        assert c["prefill_seq_split"] == ((int(seq) - 1) % model == 0), c
        # each rank reads and writes only its slice of a split sequence
        held = int(seq) // model if c["seq_split"] else int(seq)
        assert c["local_seq"] == c["in_local_seq"] == held, (seq, c)
        assert c["collectives"] == c["expected"], (seq, c)
    chain = r["chain"]
    decided = 0
    for step in chain["steps"]:
        assert step["excess"] <= 0.0, chain
        for want, got, sure, near in zip(step["want"], step["got"],
                                         step["decided"], step["near"]):
            assert near and (got == want or not sure), chain
            decided += sure
    assert decided >= len(chain["steps"]) * 4 // 2, chain
    assert chain["final_excess"] <= 0.0, chain
    assert chain["final_cache_excess"] <= 0.0, chain
    # prefill hands decode its caches in the decode layout
    assert chain["prefill_layout"] == "(Shard(dim=2), Shard(dim=3))", chain


@pytest.mark.parametrize("arch", ["llama3-8b", "smollm-135m", "pixtral-12b"])
def test_split_decode_on_one_rank_is_bit_identical(tmp_path, arch):
    """A (1, 1) mesh: the split decode on a "model" group of one (every
    block split, the sequence "split" into one slice) and the chain of 3
    tokens equal the plain calls bit for bit."""
    res = run_ranks(f"ARCH = {arch!r}\nSHAPE = (1, 1)\nTOL = {SERVE_TOL}\n"
                    "S_DIVIDES = 16\n" + DECODE, 1, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "decode.json").read_text())
    for seq, c in r["cases"].items():
        assert c["seq_split"] and c["bit_identical"], (seq, c)
        assert c["collectives"] == {"all-gather": 0, "all-reduce": 0,
                                    "all-to-all": 0}, c
    assert r["chain"]["bit_identical"], r["chain"]


COMBINE = """
import json
import numpy as np
from repro_torch.models.attention import (decode_attention,
                                          decode_attention_split)
from repro_torch.models.parallel import TensorParallel

tp = TensorParallel(dist.group.WORLD, WORLD, RANK, attn="split", mlp=True,
                    embed=True, head=None)
rng = np.random.default_rng(11)
B, S, H, KH, D = 3, 24, 8, 2, 16
out = {}
for dtype in (torch.float32, torch.bfloat16):
    q = torch.tensor(rng.normal(0, 1, (B, 1, H, D)), dtype=torch.float32)
    k = torch.tensor(rng.normal(0, 1, (B, S, KH, D)), dtype=torch.float32)
    v = torch.tensor(rng.normal(0, 1, (B, S, KH, D)), dtype=torch.float32)
    q, k, v = (t.to(DEVICE, dtype) for t in (q, k, v))
    n = S // WORLD
    lo = RANK * n
    # valid_len None; S - 1; inside the first shard, so that every other
    # shard holds only masked slots
    for valid in (None, S - 1, n // 2):
        want = decode_attention(q, k, v, valid)
        got = decode_attention_split(q, k[:, lo:lo + n], v[:, lo:lo + n],
                                     lo, tp, valid)
        key = f"{str(dtype)[6:]}/{valid}"
        out[key] = dict(
            err=float((got.float() - want.float()).abs().max()),
            scale=float(want.float().abs().max()),
            dtype=str(got.dtype), shape=list(got.shape),
            device=got.device.type,
            finite=bool(torch.isfinite(got.float()).all()))
if RANK == 0:
    with open(WORKDIR + "/combine.json", "w") as f:
        json.dump(out, f)
"""


def check_combine(out, device):
    """The combine's results (``COMBINE``'s JSON) within their bars."""
    assert len(out) == 6
    for key, r in out.items():
        tol = F32_TOL if key.startswith("float32") else SERVE_TOL
        assert r["finite"] and r["shape"] == [3, 1, 8, 16], (key, r)
        assert r["dtype"] == "torch." + key.split("/")[0], (key, r)
        assert r["device"] == device, (key, r)
        assert r["err"] <= tol * (1 + r["scale"]), (key, r)


@pytest.mark.parametrize("world", [2, 4])
def test_combine_matches_decode_attention(tmp_path, world):
    res = run_ranks("DEVICE = 'cpu'\n" + COMBINE, world, tmp_path)
    assert_ranks_ok(res)
    check_combine(json.loads((tmp_path / "combine.json").read_text()),
                  "cpu")
