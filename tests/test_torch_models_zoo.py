"""``repro_torch.models.ModelZoo`` against ``repro.models.ModelZoo``, whole
model, for every architecture at ``.reduced()``.

The reference's weights (``materialize`` with ``PRNGKey(0)``) are carried
across leaf for leaf by ``repro_torch.convert.model_params``; the same
seeded numpy batch goes through the reference's jitted ``prefill`` /
``decode`` (plain jnp on the CPU) and the port's on the CPU.  Bars:

  * ``param_defs`` / ``cache_defs`` / ``input_defs``: equal in shapes,
    logical specs, inits and stds (dtypes by name);
  * logits: the reference's own decode-vs-forward bar, rtol 2e-2 and
    atol 2e-2 (``tests/test_models_modules.py``; activations are bf16);
  * caches: within ten bf16 ulps (10 · 2⁻⁸) of each leaf's max |ref|:
    every leaf, the f32 SSM states too, is computed from bf16
    activations, and the two packages' bf16 sigmoid / silu / softplus
    differ by an ulp in a third of the elements;
  * 4 teacher-forced decode steps on caches widened one slot per step
    (``examples/serve_decode.py``'s loop), each at the same bars.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import ARCH_NAMES, SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import ModelZoo as RefZoo  # noqa: E402
from repro.models.layers import ParamDef as RefParamDef  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ModelZoo, widen_caches  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402

LOGIT_TOL = 2e-2
CACHE_REL = 10 * 2.0 ** -8   # ten bf16 ulps of each leaf's max |ref|
STEPS = 4
F8_REL = 0.02              # tests/test_perf_knobs.py's f8-cache bar


def ref_widen(caches):
    """examples/serve_decode.py's widen: one slot more per attention cache."""
    out = dict(caches)
    for k in ("kv", "shared_kv"):
        if k in out:
            out[k] = jnp.pad(out[k], [(0, 0)] * 2 + [(0, 0), (0, 1), (0, 0),
                                                      (0, 0)])
    return out


def np_batch(cfg, rng, b, s):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(
            np.float32)
    return out


def both_batches(batch):
    """A numpy batch as the reference's and the port's (tokens int32,
    embeddings bf16)."""
    ref = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.bfloat16)
           for k, v in batch.items()}
    port = {k: torch.tensor(v) if k == "tokens"
            else torch.tensor(v).to(torch.bfloat16) for k, v in batch.items()}
    return ref, port


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def assert_logits(got, ref, what):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                               err_msg=what)


def assert_caches(got, ref, what):
    g, r = leaves(to_np(got)), leaves(to_np(ref))
    assert [p for p, _ in g] == [p for p, _ in r], what
    for (path, a), (_, b) in zip(g, r):
        assert a.shape == b.shape, (what, path)
        err = np.abs(a - b).max()
        assert err <= CACHE_REL * np.abs(b).max(), (what, path, err)


def run_both(name, cfg_ref, cfg, b=2, s=32, seed=0, steps=STEPS):
    """Prefill and ``steps`` teacher-forced decode steps on both packages,
    holding logits and caches at every step."""
    rz, tz = RefZoo(cfg_ref), ModelZoo(cfg)
    params = ref_materialize(rz.param_defs(), jax.random.PRNGKey(0),
                             jnp.float32)
    tparams = convert.model_params(jax.tree.map(np.asarray, params),
                                   device="cpu")
    rng = np.random.default_rng(seed)
    rb, tb = both_batches(np_batch(cfg, rng, b, s))
    rlog, rcache = jax.jit(rz.prefill)(params, rb)
    with torch.inference_mode():
        tlog, tcache = tz.prefill(tparams, tb)
    assert tlog.dtype == torch.float32
    assert tlog.shape == (b, 1, cfg.vocab_size)
    assert_logits(tlog, rlog, f"{name} prefill")
    assert_caches(tcache, rcache, f"{name} prefill caches")
    toks = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    decode = jax.jit(rz.decode)
    for i in range(steps):
        rcache, tcache = ref_widen(rcache), widen_caches(tcache)
        rlog, rcache = decode(params, rcache,
                              {"tokens": jnp.asarray(toks[:, i:i + 1])})
        with torch.inference_mode():
            tlog, tcache = tz.decode(tparams, tcache,
                                     {"tokens": torch.tensor(toks[:, i:i + 1])})
        assert_logits(tlog, rlog, f"{name} decode step {i}")
        assert_caches(tcache, rcache, f"{name} decode step {i} caches")


def _defs_equal(got, ref):
    g, r = leaves(got), leaves(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        assert isinstance(a, ParamDef) and isinstance(b, RefParamDef), path
        assert (tuple(a.shape), tuple(a.spec), a.init, a.std) == (
            tuple(b.shape), tuple(b.spec), b.init, b.std), path


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_defs_equal_reference(name):
    cfg_ref, cfg = ref_config(name).reduced(), get_config(name).reduced()
    rz, tz = RefZoo(cfg_ref), ModelZoo(cfg)
    _defs_equal(tz.param_defs(), rz.param_defs())
    for shape in SHAPES.values():
        shape = shape.reduced()
        _defs_equal(tz.cache_defs(shape), rz.cache_defs(shape))
        got, ref = tz.input_defs(shape), rz.input_defs(shape)
        assert sorted(got) == sorted(ref)
        for k in got:
            assert (got[k].shape, got[k].spec) == (ref[k].shape, ref[k].spec)
            assert str(got[k].dtype).split(".")[-1] == \
                np.dtype(ref[k].dtype).name


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name):
    run_both(name, ref_config(name).reduced(), get_config(name).reduced())


def zero_caches(defs, kv_dtype):
    """Zero decode caches for ``cache_defs``, declared as the reference's
    serving launcher declares them (``repro/launch/train.py``): the
    attention K/V streams in ``kv_cache_dtype``, the SSM leaves in bf16."""
    kv = {"bfloat16": ml_dtypes.bfloat16,
          "float8_e4m3fn": ml_dtypes.float8_e4m3fn}[kv_dtype]

    def zeros(t, dt):
        if isinstance(t, dict):
            return {k: zeros(v, dt) for k, v in t.items()}
        return np.zeros(t.shape, dt)

    return {k: zeros(v, kv if k in ("kv", "shared_kv", "cross_kv")
                     else ml_dtypes.bfloat16) for k, v in defs.items()}


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_from_zero_caches_matches_reference(name, kv_dtype):
    """One decode step from zero caches of ``cache_defs``' shapes, in both
    cache dtypes, carried across by ``convert.model_params``.  With bf16
    caches the port's logits and new caches match the reference's at the
    logit and cache bars.  With f8 K/V caches the new K/V rows are f8
    roundings of bf16 rows held to the cache bar; two roundings part by
    at most their inputs' difference plus one f8 ulp (3 mantissa bits:
    at most 2^-3 of the value, 2^-9 among the subnormals), so the K/V
    leaves are held to the cache bar plus one f8 ulp, and the logits to
    the f8 knob's bar against the port's own bf16-cache decode, within
    ``F8_REL`` of max |logit| (``tests/test_perf_knobs.py``)."""
    rz, tz = {}, {}
    for dt in ("bfloat16", kv_dtype):
        rz[dt] = RefZoo(dataclasses.replace(ref_config(name).reduced(),
                                            kv_cache_dtype=dt))
        tz[dt] = ModelZoo(dataclasses.replace(get_config(name).reduced(),
                                              kv_cache_dtype=dt))
    shape = SHAPES["decode_32k"].reduced()
    params = ref_materialize(rz[kv_dtype].param_defs(),
                             jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.model_params(jax.tree.map(np.asarray, params),
                                   device="cpu")
    toks = np.random.default_rng(5).integers(
        0, tz[kv_dtype].cfg.vocab_size,
        (shape.global_batch, 1)).astype(np.int32)
    tlog = {}
    for dt in tz:
        zeros = zero_caches(rz[dt].cache_defs(shape), dt)
        tcache = convert.model_params(zeros, device="cpu")
        want = {"bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn}[dt]
        for (path, c), (_, d) in zip(leaves(tcache),
                                     leaves(tz[dt].cache_defs(shape))):
            assert tuple(c.shape) == d.shape, path
            kv = path.split("/")[1] in ("kv", "shared_kv", "cross_kv")
            assert c.dtype == (want if kv else torch.bfloat16), path
        with torch.inference_mode():
            tlog[dt], tnew = tz[dt].decode(tparams, tcache,
                                           {"tokens": torch.tensor(toks)})
    rlog, rnew = jax.jit(rz[kv_dtype].decode)(
        params, jax.tree.map(jnp.asarray, zeros), {"tokens": jnp.asarray(toks)})
    got = tlog[kv_dtype]
    assert got.shape == (shape.global_batch, 1, tz[kv_dtype].cfg.vocab_size)
    assert torch.isfinite(got).all()
    assert [p for p, _ in leaves(tnew)] == [p for p, _ in leaves(rnew)]
    for (path, c), (_, r) in zip(leaves(tnew), leaves(rnew)):
        assert str(c.dtype).split(".")[-1] == np.dtype(r.dtype).name, path
        if c.dtype == torch.float8_e4m3fn:
            a, b = to_np(c), to_np(r)
            one_ulp = np.maximum(2.0 ** -3 * np.maximum(np.abs(a), np.abs(b)),
                                 2.0 ** -9)
            bar = CACHE_REL * np.abs(b).max() + one_ulp
            assert (np.abs(a - b) <= bar).all(), (name, path)
        else:
            assert_caches(c, r, f"{name} {path} after decode from zero")
    if kv_dtype == "bfloat16":
        assert_logits(got, rlog, f"{name} decode from zero caches")
    else:
        base = tlog["bfloat16"]
        assert float((got - base).abs().max() / base.abs().max()) < F8_REL
