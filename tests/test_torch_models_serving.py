"""Serving on the port's model stack: the reference's serving properties
mirrored on ``repro_torch.models`` (CPU), and full-width smollm-135m.

  * decode == forward: prefill(S-1) + decode(1) equals prefill(S)'s last
    logits within the reference's bar, rtol 2e-2 / atol 2e-2
    (``tests/test_models_modules.py``), on the port's own random weights;
  * the f8 KV cache: decode within 2 % of max |logit| of the bf16 cache
    (``tests/test_perf_knobs.py``), and within the logit bar of the
    reference's f8 decode; the cast into float8_e4m3fn gives NaN past the
    rounding range as ``ml_dtypes`` does (torch's own cast saturates);
  * ``examples/serve_decode.py --smoke``'s loop: (2, 4) int32 greedy
    tokens, equal to the example's wherever the reference's top-1 /
    top-2 logit margin exceeds ``MARGIN`` (a token past a narrower margin
    may flip on a bf16 ulp, and the sequences part there);
  * smollm-135m at full width (d 576, 9 / 3 heads: a GQA group of 3 that
    the reduced configs lack; vocab 49,152) with depth cut to 2 layers,
    held to the reference as ``tests/test_torch_models_zoo.py`` holds the
    reduced configs;
  * at depth the reference's own decode and forward part by more than
    its bar (mamba2-370m at 8 layers, smollm-135m at its full 30): on the
    reference's weights the port parts by at most ``WITNESS_RATIO`` × the
    reference, and both keep the sure greedy tokens.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from test_torch_models_zoo import (LOGIT_TOL, both_batches,  # noqa: E402
                                   ref_widen, run_both)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import ModelZoo as RefZoo  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ModelZoo, materialize, widen_caches  # noqa: E402
from repro_torch.models.transformer import to_kv_dtype  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "examples"))
import serve_decode  # noqa: E402

MARGIN = 4e-2
WITNESS_RATIO = 1.5   # the port's parting over the reference's, at most


def _port_params(cfg, seed=0):
    return materialize(ModelZoo(cfg).param_defs(),
                       torch.Generator().manual_seed(seed), torch.float32,
                       device="cpu")


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-370m", "zamba2-7b"])
def test_decode_consistent_with_forward(name):
    """prefill(S-1) + decode(1) == prefill(S)'s last logits."""
    cfg = get_config(name).reduced()
    zoo = ModelZoo(cfg)
    params = _port_params(cfg)
    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                        dtype=torch.int32)
    with torch.inference_mode():
        full, _ = zoo.prefill(params, {"tokens": toks})
        _, caches = zoo.prefill(params, {"tokens": toks[:, :-1]})
        dec, _ = zoo.decode(params, widen_caches(caches),
                            {"tokens": toks[:, -1:]})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_f8_cast_follows_ml_dtypes():
    vals = np.array([0.0, -0.0, 1e-9, 0.3, -2.5, 17.0, 447.0, 448.0, 455.0,
                     463.9, 464.0, -464.0, 464.1, 479.0, 480.0, 500.0, 1e4,
                     -1e4, np.inf, -np.inf, np.nan], np.float32)
    for dt, jdt in ((torch.float32, np.float32),
                    (torch.bfloat16, ml_dtypes.bfloat16)):
        src = vals.astype(jdt)
        want = src.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
        got = to_kv_dtype(torch.tensor(src.astype(np.float32)).to(dt),
                          torch.float8_e4m3fn)
        assert got.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(got.float().numpy(), want)
    # torch's own cast saturates where ml_dtypes gives NaN
    plain = torch.tensor([500.0, np.inf]).to(torch.float8_e4m3fn).float()
    assert plain.tolist() == [448.0, 448.0]
    # other cache dtypes are a plain cast
    x = torch.tensor([1e5, -3.0])
    assert torch.equal(to_kv_dtype(x, torch.bfloat16), x.bfloat16())


def test_f8_kv_cache_decode_close_to_bf16_and_to_the_reference():
    cfg_ref, cfg = (ref_config("smollm-135m").reduced(),
                    get_config("smollm-135m").reduced())
    rz, zoo = RefZoo(cfg_ref), ModelZoo(cfg)
    params = ref_materialize(rz.param_defs(), jax.random.PRNGKey(0),
                             jnp.float32)
    tparams = convert.model_params(jax.tree.map(np.asarray, params),
                                   device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    dec = {"tokens": toks[:, -1:]}
    _, caches = jax.jit(rz.prefill)(params, {"tokens": jnp.asarray(
        toks[:, :-1])})
    kv = ref_widen(caches)["kv"]
    ref8, _ = jax.jit(rz.decode)(params, {"kv": kv.astype(
        jnp.float8_e4m3fn)}, {"tokens": jnp.asarray(toks[:, -1:])})
    tdec = {"tokens": torch.tensor(dec["tokens"])}
    with torch.inference_mode():
        _, tcaches = zoo.prefill(tparams, {"tokens": torch.tensor(
            toks[:, :-1])})
        tkv = widen_caches(tcaches)["kv"]
        base, _ = zoo.decode(tparams, {"kv": tkv}, tdec)
        got, new = zoo.decode(
            tparams, {"kv": to_kv_dtype(tkv, torch.float8_e4m3fn)}, tdec)
    assert new["kv"].dtype == torch.float8_e4m3fn
    scale = base.abs().max()
    assert float((got - base).abs().max() / scale) < 0.02
    np.testing.assert_allclose(got.numpy(), np.asarray(ref8), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_serve_decode_smoke_loop_matches_the_example():
    """examples/serve_decode.py --smoke on the port, from the example's
    weights (PRNGKey(0)) and batch (default_rng(0))."""
    want = serve_decode.main(["--smoke"])
    cfg_ref, cfg = (ref_config("smollm-135m").reduced(),
                    get_config("smollm-135m").reduced())
    rz, zoo = RefZoo(cfg_ref), ModelZoo(cfg)
    params = ref_materialize(rz.param_defs(), jax.random.PRNGKey(0),
                             jnp.float32)
    tparams = convert.model_params(jax.tree.map(np.asarray, params),
                                   device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(
        np.int32)}
    rb, tb = both_batches(batch)
    rlog, rcache = jax.jit(rz.prefill)(params, rb)
    with torch.inference_mode():
        tlog, tcache = zoo.prefill(tparams, tb)
    decode = jax.jit(rz.decode)
    got, ref_toks = [], []
    for i in range(4):
        r = np.asarray(rlog)[:, -1, :]
        rtok = r.argmax(-1).astype(np.int32)[:, None]
        ttok = tlog[:, -1, :].argmax(-1).to(torch.int32)[:, None]
        top2 = np.sort(r, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > MARGIN
        np.testing.assert_array_equal(ttok.numpy()[sure], rtok[sure])
        got.append(ttok)
        ref_toks.append(rtok)
        if not sure.all():
            break   # the sequences may part here
        if i < 3:
            rcache, tcache = ref_widen(rcache), widen_caches(tcache)
            rlog, rcache = decode(params, rcache, {"tokens": jnp.asarray(rtok)})
            with torch.inference_mode():
                tlog, tcache = zoo.decode(tparams, tcache, {"tokens": ttok})
    ref_out = np.concatenate(ref_toks, axis=1)
    np.testing.assert_array_equal(ref_out, want[:, :ref_out.shape[1]])
    out = torch.cat(got, dim=1).numpy()
    assert out.dtype == np.int32 and out.min() >= 0
    assert len(got) < 4 or out.shape == want.shape == (2, 4)


def test_smollm_full_width_two_layers_matches_reference():
    cfg_ref = dataclasses.replace(ref_config("smollm-135m"), num_layers=2)
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size) \
        == (576, 9, 3, 49152)
    run_both("smollm-135m x 2 layers", cfg_ref, cfg, b=2, s=24)


def _parting(name, layers, b, s):
    """prefill(S-1) + decode(1) against prefill(S)'s last logits, at full
    width and ``layers`` deep, on the reference and on the port with the
    reference's weights carried across: the reference's and the port's
    forward and decode logits."""
    cfg_ref = dataclasses.replace(ref_config(name), num_layers=layers)
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    rz, zoo = RefZoo(cfg_ref), ModelZoo(cfg)
    params = ref_materialize(rz.param_defs(), jax.random.PRNGKey(0),
                             jnp.float32)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    full, _ = jax.jit(rz.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, caches = jax.jit(rz.prefill)(params, {"tokens": jnp.asarray(
        toks[:, :-1])})
    dec, _ = jax.jit(rz.decode)(params, caches, {"tokens": jnp.asarray(
        toks[:, -1:])})
    full, dec = np.asarray(full), np.asarray(dec)
    tparams = convert.model_params(jax.tree.map(np.asarray, params),
                                   device="cpu")
    del params
    tt = torch.tensor(toks)
    with torch.inference_mode():
        tfull, _ = zoo.prefill(tparams, {"tokens": tt})
        _, tcaches = zoo.prefill(tparams, {"tokens": tt[:, :-1]})
        tdec, _ = zoo.decode(tparams, tcaches, {"tokens": tt[:, -1:]})
    return full, dec, tfull.numpy(), tdec.numpy()


def _assert_parting_is_the_reference_s(full, dec, tfull, tdec):
    """The reference parts by more than its bar; the port parts by no more
    than ``WITNESS_RATIO`` × the reference, and both keep the greedy token wherever the
    forward's margin exceeds ``MARGIN``."""
    bar = lambda f: LOGIT_TOL + LOGIT_TOL * np.abs(f)
    ref_err, port_err = np.abs(dec - full), np.abs(tdec - tfull)
    assert (ref_err > bar(full)).any()
    assert port_err.max() <= WITNESS_RATIO * ref_err.max()
    for f, d in ((full, dec), (tfull, tdec)):
        top2 = np.sort(f[:, -1], axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > MARGIN
        np.testing.assert_array_equal(d[:, -1].argmax(-1)[sure],
                                      f[:, -1].argmax(-1)[sure])


def test_decode_forward_parting_at_depth_is_the_reference_s():
    """At full width the reference's own decode and forward part by more
    than its bar once the stack is deep (mamba2-370m with 8 of its 48
    layers: its chunked scan rounds the intra-chunk weights to bf16, the
    recurrence keeps the state in f32).  On the same weights and tokens the
    port parts by no more than 1.5 × the reference.  This is why phase 12
    (b) of chip_smoke.py holds the bar with the depth cut to 2 layers and
    the greedy tokens at full depth."""
    _assert_parting_is_the_reference_s(*_parting("mamba2-370m", 8, 2, 1024))


def test_attention_decode_forward_parting_at_full_depth_is_the_reference_s():
    """The same witness for attention: smollm-135m at full width and full
    depth (30 layers, 9 / 3 heads), one 1,024-token sequence.  The
    forward's 1,024 query rows and decode's single row go through
    matmuls of other shapes and a softmax over another layout, each
    rounding its output to bf16; the residual stream carries those
    one-ulp differences through every layer, and the logits, of order 1
    with a bf16 ulp of 2^-8 to 2^-6, part by a few ulps, more than the
    2e-2 bar admits.  The port parts by no more than 1.5 × the
    reference."""
    full, dec, tfull, tdec = _parting("smollm-135m", 30, 1, 1024)
    _assert_parting_is_the_reference_s(full, dec, tfull, tdec)
