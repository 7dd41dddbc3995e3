"""The port's steps on a mesh (``launch.train``): serving on DTensor
leaves, and the sharding profiles' batch split, on gloo CPU worlds
(``tests/torch_gloo.py``).

  * on 4 ranks as (2 data, 2 model), reduced dense (smollm-135m) and ssm
    (mamba2-370m): ``make_prefill_step`` / ``make_decode_step`` on the
    parameters ``init_train_state`` places, and on decode caches placed
    as ``abstract_serve_args`` places them (batch over "data", the K/V
    sequence or the SSM heads over "model"), equal the plain zoo call on
    the same batch within the serving bar (rtol / atol 2e-2), logits and
    caches; the outputs are sharded on their batch dimension over "data";
  * on a one-rank mesh the same steps equal the plain calls bit for bit;
  * the ``dp`` and ``zero3`` profiles split the batch over "model" too
    (their gradients all-reduced over both axes; ``tp`` over "data"
    only), and each step equals the plain step within the training bars
    (``PERF.md`` §2: loss within rel 2e-3, gradients — here the first
    update's first moment, the clipped mean gradient times 1 - b1, and
    the gradient norm — within rtol 5e-2 / atol 5e-4).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
LOSS_REL = 2e-3           # tests/test_torch_train_zoo.py
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4

SERVE = """
import json
import numpy as np
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.launch import (dp_axes_of, init_train_state,
                                make_decode_step, make_mesh_from_devices,
                                make_prefill_step)
from repro_torch.launch.train import _profile
from repro_torch.models import ModelZoo, widen_caches
from repro_torch.models.layers import (fit_spec_to_shape, resolve_spec,
                                       spec_placements)
from repro_torch.models.transformer import cache_defs

cfg = get_config(ARCH).reduced()
mesh = make_mesh_from_devices(range(WORLD), SHAPE, ("data", "model"),
                              device_type="cpu")
zoo = ModelZoo(cfg)
params, _ = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
full = tree_map(lambda p: p.full_tensor(), params)
B, S = 4, 16
rng = np.random.default_rng(1)
batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                dtype=torch.int32)}
dp, use_tp, _ = _profile(cfg, dp_axes_of(mesh))


def place(caches, seq):
    defs = cache_defs(cfg, B, seq)
    return tree_map(lambda c, d: distribute_tensor(c, mesh, spec_placements(
        fit_spec_to_shape(d.shape, resolve_spec(d.spec, use_fsdp=False,
                                                dp_axes=dp, use_tp=use_tp),
                          mesh), mesh)), caches, defs)


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs()
                  - (TOL + TOL * want.abs())).max())


def bits(got, want):
    return got.dtype == want.dtype and torch.equal(got, want)


out = {}
with torch.no_grad():
    want_l, want_c = zoo.prefill(full, batch)
    got_l, got_c = make_prefill_step(cfg)(params, batch)
    tok = want_l.argmax(-1).to(torch.int32)
    wide = widen_caches(want_c)
    want_l2, want_c2 = zoo.decode(full, wide, {"tokens": tok})
    placed = place(wide, S + 1)
    got_l2, got_c2 = make_decode_step(cfg)(params, placed, {"tokens": tok})
for name, (gl, gc, wl, wc) in (("prefill", (got_l, got_c, want_l, want_c)),
                               ("decode", (got_l2, got_c2, want_l2,
                                           want_c2))):
    leaves = tree_flatten_with_path(gc)
    assert all(isinstance(t, DTensor) for _, t in leaves)
    assert isinstance(gl, DTensor)
    gl_full = gl.full_tensor()
    full_c = [t.full_tensor() for _, t in leaves]
    want_leaves = tree_leaves(wc)
    out[name] = dict(
        logits_excess=excess(gl_full, wl),
        cache_excess=max(excess(a, b) for a, b in zip(full_c, want_leaves)),
        bit_identical=bits(gl_full, wl) and all(
            bits(a, b) for a, b in zip(full_c, want_leaves)),
        logits_placements=str(tuple(gl.placements)),
        cache_batch_sharded=all(
            any(p.is_shard() for p in t.placements) == (WORLD > 1)
            for _, t in leaves),
        leaves=len(leaves))
if RANK == 0:
    with open(WORKDIR + "/serve.json", "w") as f:
        json.dump(out, f)
"""


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_serve_steps_on_four_ranks_match_the_plain_calls(tmp_path, arch):
    res = run_ranks(f"ARCH = {arch!r}\nSHAPE = (2, 2)\nTOL = {SERVE_TOL}\n"
                    + SERVE, 4, tmp_path)
    assert_ranks_ok(res)
    out = json.loads((tmp_path / "serve.json").read_text())
    for name in ("prefill", "decode"):
        r = out[name]
        assert r["logits_excess"] <= 0.0, (name, r)
        assert r["cache_excess"] <= 0.0, (name, r)
        assert r["logits_placements"] == "(Shard(dim=0), Replicate())", r
        assert r["cache_batch_sharded"] and r["leaves"] > 0, r


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_serve_steps_on_one_rank_are_bit_identical(tmp_path, arch):
    res = run_ranks(f"ARCH = {arch!r}\nSHAPE = (1, 1)\nTOL = {SERVE_TOL}\n"
                    + SERVE, 1, tmp_path)
    assert_ranks_ok(res)
    out = json.loads((tmp_path / "serve.json").read_text())
    for name in ("prefill", "decode"):
        assert out[name]["bit_identical"], (name, out[name])


PROFILES = """
import dataclasses, json
import numpy as np
from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.launch import (init_train_state, make_mesh_from_devices,
                                make_train_step)

mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"),
                              device_type="cpu")
rng = np.random.default_rng(2)
out = {}
for profile in ("tp", "dp", "zero3"):
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              sharding_profile=profile)
    toks = rng.integers(0, cfg.vocab_size, (8, 32))
    batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
             "labels": torch.tensor(np.roll(toks, -1, axis=1),
                                    dtype=torch.int32)}
    p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
    p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                            device="cpu")
    step = make_train_step(cfg)
    _, opt_m, m_m = step(p_m, o_m, batch, 1000)
    _, opt_p, m_p = step(p, o, batch, 1000)
    # the first update's mu is (1 - b1) times the clipped mean gradient
    worst = -1.0
    for (path, a), b in zip(tree_flatten_with_path(opt_m["mu"]),
                            tree_leaves(opt_p["mu"])):
        a, b = a.full_tensor() / (1 - B1), b / (1 - B1)
        worst = max(worst, float(((a - b).abs()
                                  - (GRAD_ATOL + GRAD_RTOL * b.abs())).max()))
    out[profile] = dict(
        loss_rel=abs(float(m_m["loss"]) - float(m_p["loss"]))
        / abs(float(m_p["loss"])),
        gnorm_rel=abs(float(m_m["grad_norm"]) - float(m_p["grad_norm"]))
        / abs(float(m_p["grad_norm"])),
        grad_excess=worst, all_reduces=m_m["all_reduces"],
        leaves=len(tree_leaves(p)))
if RANK == 0:
    with open(WORKDIR + "/profiles.json", "w") as f:
        json.dump(out, f)
"""


def test_profiles_split_the_batch_over_model_too(tmp_path):
    from repro_torch.optim import AdamWConfig
    res = run_ranks(f"GRAD_RTOL = {GRAD_RTOL}\nGRAD_ATOL = {GRAD_ATOL}\n"
                    f"B1 = {AdamWConfig().b1}\n" + PROFILES, 4, tmp_path)
    assert_ranks_ok(res)
    out = json.loads((tmp_path / "profiles.json").read_text())
    for profile, axes in (("tp", 1), ("dp", 2), ("zero3", 2)):
        r = out[profile]
        assert r["all_reduces"] == (r["leaves"] + 1) * axes, (profile, r)
        assert r["loss_rel"] <= LOSS_REL, (profile, r)
        assert r["gnorm_rel"] <= GRAD_RTOL, (profile, r)
        assert r["grad_excess"] <= 0.0, (profile, r)
