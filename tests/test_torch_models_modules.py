"""The port's model modules against ``repro.models``, module by module.

The same seeded numpy inputs go through the reference (plain jnp on the
CPU: none of these modules reaches a Pallas kernel) and through
``repro_torch.models`` on the CPU.  Bars:

  * float32 outputs: rtol 1e-5 (atol 1e-5 of max |ref| for entries that
    cancel to near zero);
  * bf16 outputs: within 1e-2 of max |ref| (the two packages round
    elementwise chains in different places);
  * MoE expert choices: exactly equal, including a tie in the router
    logits (the lower expert index wins, as ``jax.lax.top_k`` picks).

The reference's own module properties are mirrored on the port: chunked
attention equals full attention, decode equals the last row of full
attention, the chunked SSD scan equals the naive recurrence, the MoE
equals the explicit per-token loop, and a capacity drop never duplicates
a token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypcompat import given, settings, st  # noqa: E402
from test_models_modules import naive_ssd  # noqa: E402

import repro.models.attention as ra  # noqa: E402
import repro.models.layers as rl  # noqa: E402
import repro.models.mamba2 as rm  # noqa: E402
import repro.models.moe as rmoe  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402

import repro_torch.models.attention as ta  # noqa: E402
import repro_torch.models.layers as tl  # noqa: E402
import repro_torch.models.mamba2 as tm  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

F32_RTOL = 1e-5
BF16_REL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, kind="f32"):
    """One numpy array as a reference and a port array of ``kind``."""
    jdt, tdt = DTYPES[kind]
    return jnp.asarray(a, jdt), torch.tensor(np.asarray(a, np.float32)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, kind="f32"):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    if kind == "f32":
        np.testing.assert_allclose(got, ref, rtol=F32_RTOL,
                                   atol=F32_RTOL * scale)
    else:
        assert np.abs(got - ref).max() <= BF16_REL * scale, \
            (np.abs(got - ref).max(), scale)


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, s).astype(np.float32) for s in shapes]


def _params_both(defs_ref, seed=1):
    """Reference-initialized params and the same weights on the port."""
    p = rl.materialize(defs_ref, jax.random.PRNGKey(seed), jnp.float32)
    return p, convert.model_params(jax.tree.map(np.asarray, p), device="cpu")


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_rmsnorm_matches_reference(kind):
    x, g = _rng_arrays(0, (2, 5, 48), (48,))
    (xj, xt), (gj, gt) = _both(x, kind), _both(1 + 0.1 * g)
    _close(tl.rmsnorm(xt, gt), rl.rmsnorm(xj, gj), kind)


def test_layernorm_matches_reference():
    x, g, b = _rng_arrays(1, (3, 7, 32), (32,), (32,))
    (xj, xt), (gj, gt), (bj, bt) = _both(x), _both(g), _both(b)
    _close(tl.layernorm(xt, gt, bt), rl.layernorm(xj, gj, bj))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_reference(kind, offset):
    (x,) = _rng_arrays(2, (2, 9, 3, 16))
    xj, xt = _both(x, kind)
    pos = np.arange(9)[None, :] + offset
    _close(tl.rope(xt, torch.tensor(pos), 1e4),
           rl.rope(xj, jnp.asarray(pos), 1e4), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_swiglu_matches_reference(kind):
    x, w1, w3, w2 = _rng_arrays(3, (4, 24), (24, 40), (24, 40), (40, 24),
                                scale=0.3)
    ref = rl.swiglu(*(_both(a, kind)[0] for a in (x, w1, w3, w2)))
    got = tl.swiglu(*(_both(a, kind)[1] for a in (x, w1, w3, w2)))
    _close(got, ref, kind)


def test_gelu_mlp_is_the_tanh_approximation():
    x, w1, w2 = _rng_arrays(4, (6, 24), (24, 40), (40, 24), scale=0.5)
    ref = rl.gelu_mlp(*(_both(a)[0] for a in (x, w1, w2)))
    got = tl.gelu_mlp(*(_both(a)[1] for a in (x, w1, w2)))
    _close(got, ref)
    # torch's exact gelu would miss the reference by far more than 1e-5.
    h = torch.tensor(x) @ torch.tensor(w1)
    exact = torch.nn.functional.gelu(h) @ torch.tensor(w2)
    assert np.abs(exact.numpy() - _np(ref)).max() > 1e-4


def test_materialize_inits_and_generator():
    defs = {"w": tl.ParamDef((64, 32), (None, "model"), std=0.5),
            "b": {"z": tl.ParamDef((7,), (None,), init="zeros"),
                  "o": tl.ParamDef((3, 2), (None, None), init="ones")}}
    gen = lambda: torch.Generator().manual_seed(11)
    a = tl.materialize(defs, gen(), torch.float32, device="cpu")
    b = tl.materialize(defs, gen(), torch.bfloat16, device="cpu")
    assert a["w"].dtype == torch.float32 and b["w"].dtype == torch.bfloat16
    assert torch.equal(a["w"].bfloat16(), b["w"])
    assert torch.equal(a["b"]["z"], torch.zeros(7))
    assert torch.equal(a["b"]["o"], torch.ones(3, 2))
    assert abs(float(a["w"].std()) - 0.5) < 0.05
    c = tl.materialize(defs, torch.Generator().manual_seed(12), torch.float32,
                       device="cpu")
    assert not torch.equal(a["w"], c["w"])
    stacked = tl.stack_defs(defs, 4)
    assert stacked["w"].shape == (4, 64, 32)
    assert stacked["w"].spec == (None, None, "model")
    assert stacked["b"]["z"].init == "zeros"
    with pytest.raises(ValueError, match="rank"):
        tl.ParamDef((2, 3), (None,))


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kh", [(4, 1), (6, 2), (9, 3)])
def test_attention_matches_reference(kind, causal, h, kh):
    q, k, v = _rng_arrays(5, (2, 24, h, 8), (2, 24, kh, 8), (2, 24, kh, 8))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, kind) for a in (q, k, v))
    _close(ta.attention(qt, kt, vt, causal=causal),
           ra.attention(qj, kj, vj, causal=causal), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("causal,unroll,q_offset", [
    (True, False, 0), (True, True, 0), (False, False, 0), (True, False, 16),
    (False, True, 0)])
def test_chunked_attention_matches_reference(kind, causal, unroll, q_offset):
    q, k, v = _rng_arrays(6, (2, 64, 6, 8), (2, 64 + q_offset, 2, 8),
                          (2, 64 + q_offset, 2, 8))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, kind) for a in (q, k, v))
    kw = dict(causal=causal, chunk=16, q_offset=q_offset,
              causal_unroll=unroll)
    _close(ta.chunked_attention(qt, kt, vt, **kw),
           ra.chunked_attention(qj, kj, vj, **kw), kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("valid_len", [None, 19])
def test_decode_attention_matches_reference(kind, valid_len):
    q, k, v = _rng_arrays(7, (3, 1, 6, 8), (3, 32, 2, 8), (3, 32, 2, 8))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, kind) for a in (q, k, v))
    _close(ta.decode_attention(qt, kt, vt, valid_len),
           ra.decode_attention(qj, kj, vj, valid_len), kind)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 999), causal=st.booleans(),
       h=st.sampled_from([4, 6]), kh=st.sampled_from([1, 2]),
       unroll=st.booleans())
def test_chunked_attention_matches_full_on_the_port(seed, causal, h, kh,
                                                     unroll):
    q, k, v = (torch.tensor(a) for a in _rng_arrays(
        seed, (2, 64, h, 8), (2, 64, kh, 8), (2, 64, kh, 8)))
    full = ta.attention(q, k, v, causal=causal)
    chunked = ta.chunked_attention(q, k, v, causal=causal, chunk=16,
                                   causal_unroll=unroll)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_decode_attention_matches_last_row_of_full_on_the_port():
    q, k, v = (torch.tensor(a) for a in _rng_arrays(
        0, (2, 32, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8)))
    full = ta.attention(q, k, v, causal=True)
    dec = ta.decode_attention(q[:, -1:], k, v)
    np.testing.assert_allclose(dec.numpy(), full[:, -1:].numpy(), rtol=2e-5,
                               atol=2e-5)


def test_chunked_attention_refuses_a_ragged_chunk():
    q = torch.zeros(1, 24, 2, 4)
    with pytest.raises(ValueError, match="divisible"):
        ta.chunked_attention(q, q, q, causal=True, chunk=16)


# ------------------------------------------------------------------ mamba2

def _ssm_cfg():
    return ref_config("mamba2-370m").reduced(), get_config(
        "mamba2-370m").reduced()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_causal_conv_matches_reference(kind):
    x, w, b = _rng_arrays(8, (2, 13, 40), (4, 40), (40,))
    (xj, xt), (wj, wt), (bj, bt) = (_both(a, kind) for a in (x, w, b))
    _close(tm._causal_conv(xt, wt, bt), rm._causal_conv(xj, wj, bj), kind)


def _ssd_inputs(seed, b=2, s=32, h=3, p=4, n=8, kind="f32"):
    rng = np.random.default_rng(seed)
    xh = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, (b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1, 0.5, (h,)).astype(np.float32)
    bm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    ref = (_both(xh, kind)[0], jnp.asarray(dt), jnp.asarray(a_log),
           _both(bm, kind)[0], _both(cm, kind)[0])
    port = (_both(xh, kind)[1], torch.tensor(dt), torch.tensor(a_log),
            _both(bm, kind)[1], _both(cm, kind)[1])
    return (xh, dt, a_log, bm, cm), ref, port


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (32, 64)])
def test_ssd_chunked_matches_reference(kind, s, chunk):
    _, ref_in, port_in = _ssd_inputs(9, s=s, kind=kind)
    y_r, st_r = rm._ssd_chunked(*ref_in, chunk)
    y_t, st_t = tm._ssd_chunked(*port_in, chunk)
    _close(y_t, y_r, kind)
    assert st_t.dtype == torch.float32
    _close(st_t, st_r, "f32" if kind == "f32" else kind)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 999), chunk=st.sampled_from([4, 8, 16]))
def test_ssd_chunked_matches_naive_recurrence_on_the_port(seed, chunk):
    raw, _, port_in = _ssd_inputs(seed)
    y, final = tm._ssd_chunked(*port_in, chunk)
    y_ref, final_ref = naive_ssd(*raw)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), final_ref, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_mamba_apply_and_decode_match_reference(kind):
    rcfg, cfg = _ssm_cfg()
    pr, pt = _params_both(rm.mamba_defs(rcfg))
    # non-trivial A, D, Δ bias and conv bias
    rng = np.random.default_rng(10)
    for key in ("A_log", "dt_bias", "conv_b"):
        extra = rng.uniform(-0.5, 0.5, pr[key].shape).astype(np.float32)
        pr[key] = jnp.asarray(extra)
        pt[key] = torch.tensor(extra)
    (x,) = _rng_arrays(11, (2, 40, rcfg.d_model))
    xj, xt = _both(x, kind)
    y_r, c_r = rm.mamba_apply(pr, xj, rcfg)
    y_t, c_t = tm.mamba_apply(pt, xt, cfg)
    _close(y_t, y_r, kind)
    _close(c_t["conv"], c_r["conv"], kind)
    _close(c_t["state"], c_r["state"], kind)
    (x1,) = _rng_arrays(12, (2, 1, rcfg.d_model))
    x1j, x1t = _both(x1, kind)
    o_r, n_r = rm.mamba_decode_step(pr, c_r, x1j, rcfg)
    o_t, n_t = tm.mamba_decode_step(pt, convert.model_params(
        jax.tree.map(np.asarray, c_r), device="cpu"), x1t, cfg)
    _close(o_t, o_r, kind)
    _close(n_t["conv"], n_r["conv"], kind)
    _close(n_t["state"], n_r["state"], kind)
    assert n_t["conv"].dtype == c_t["conv"].dtype


def test_mamba_decode_continues_the_full_sequence_on_the_port():
    _, cfg = _ssm_cfg()
    pr, pt = _params_both(rm.mamba_defs(_ssm_cfg()[0]))
    (x,) = _rng_arrays(13, (2, 21, cfg.d_model))
    x = torch.tensor(x)
    full, _ = tm.mamba_apply(pt, x, cfg)
    _, cache = tm.mamba_apply(pt, x[:, :-1], cfg)
    last, _ = tm.mamba_decode_step(pt, cache, x[:, -1:], cfg)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), rtol=2e-4,
                               atol=2e-5)


# --------------------------------------------------------------------- moe

def _moe_cfgs(**kw):
    rcfg = ref_config("qwen2-moe-a2.7b").reduced()
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(cfg, **kw)


def test_top_k_keeps_the_lower_index_on_ties():
    rng = np.random.default_rng(14)
    logits = np.round(rng.normal(0, 1, (64, 16)), 1).astype(np.float32)
    logits[:, 5] = logits[:, 9] = logits[:, 2] = 3.0   # a three-way tie
    logits[:7] = 0.0                                    # all tied
    for k in (1, 2, 4, 16):
        v_r, i_r = jax.lax.top_k(jnp.asarray(logits), k)
        v_t, i_t = tmoe.top_k(torch.tensor(logits), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_reference(kind, shared):
    rcfg, cfg = _moe_cfgs(num_shared_experts=shared)
    pr, pt = _params_both(rmoe.moe_defs(rcfg))
    (x,) = _rng_arrays(15, (2, 32, rcfg.d_model))
    xj, xt = _both(x, kind)
    out_r, aux_r = rmoe.moe_apply(pr, xj, rcfg)
    out_t, aux_t = tmoe.moe_apply(pt, xt, cfg)
    _close(out_t, out_r, kind)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-4)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_moe_expert_choice_on_a_router_tie(kind):
    """Experts 1 and 2 share a router column, so every token's logits tie
    there; the choice must fall on expert 1 as in the reference, and the
    different expert weights make a wrong choice visible in the output."""
    rcfg, cfg = _moe_cfgs(num_shared_experts=0, moe_capacity_factor=8.0,
                          num_experts_per_tok=1)
    pr, pt = _params_both(rmoe.moe_defs(rcfg))
    router = np.abs(np.asarray(pr["router"]))
    router[:, 1] = router[:, 2] = 4.0 * router[:, 1]
    pr["router"], pt["router"] = jnp.asarray(router), torch.tensor(router)
    (x,) = _rng_arrays(16, (2, 32, rcfg.d_model))
    x = np.abs(x)          # every token's top logit is the 1 / 2 tie
    xj, xt = _both(x, kind)
    lg_r = np.asarray((xj @ pr["router"].astype(xj.dtype)).astype(jnp.float32))
    lg_t = (xt @ pt["router"].to(xt.dtype)).float()
    _close(lg_t, lg_r, kind)
    # the tie is exact in each package
    assert (lg_r[..., 1] == lg_r[..., 2]).all()
    assert torch.equal(lg_t[..., 1], lg_t[..., 2])
    _, idx_r = jax.lax.top_k(jnp.asarray(lg_r), 1)
    _, idx_t = tmoe.top_k(lg_t, 1)
    assert (np.asarray(idx_r) == 1).all()
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    out_r, _ = rmoe.moe_apply(pr, xj, rcfg)
    out_t, _ = tmoe.moe_apply(pt, xt, cfg)
    _close(out_t, out_r, kind)


def test_moe_matches_explicit_loop_on_the_port():
    """With ample capacity, grouped one-hot dispatch == per-token loop."""
    _, cfg = _moe_cfgs(moe_capacity_factor=8.0, num_shared_experts=0)
    params = tl.materialize(tmoe.moe_defs(cfg),
                            torch.Generator().manual_seed(1), torch.float32,
                            device="cpu")
    (x,) = _rng_arrays(0, (2, 32, cfg.d_model))
    out, aux = tmoe.moe_apply(params, torch.tensor(x), cfg)
    xt = x.reshape(-1, cfg.d_model)
    logits = xt @ params["router"].numpy()
    logits[:, cfg.num_experts:] = -1e30
    w1, w3, w2 = (params[k].numpy() for k in ("w1", "w3", "w2"))
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-logits[t], kind="stable")[:cfg.num_experts_per_tok]
        gl = logits[t][top]
        gates = np.exp(gl - gl.max())
        gates /= gates.sum()
        for gate, e in zip(gates, top):
            hsil = xt[t] @ w1[e]
            ref[t] += gate * (((hsil / (1 + np.exp(-hsil))) * (xt[t] @ w3[e]))
                              @ w2[e])
    np.testing.assert_allclose(out.numpy().reshape(-1, cfg.d_model), ref,
                               rtol=5e-4, atol=5e-4)
    assert np.isfinite(float(aux))


def test_moe_capacity_drops_and_never_duplicates_on_the_port():
    """Identical tokens all pick the same experts; at capacity 1 per group
    only each group's first token is served (its full output) and the rest
    are dropped to 0 — none is served twice."""
    _, cfg = _moe_cfgs(moe_capacity_factor=0.25, num_shared_experts=0)
    params = tl.materialize(tmoe.moe_defs(cfg),
                            torch.Generator().manual_seed(1), torch.float32,
                            device="cpu")
    x = torch.ones(2, 32, cfg.d_model)
    out, _ = tmoe.moe_apply(params, x, cfg)
    full, _ = tmoe.moe_apply(params, x, dataclasses.replace(
        cfg, moe_capacity_factor=8.0))
    gs = min(cfg.moe_group_size, 64)
    cap = int(np.ceil(0.25 * gs * cfg.num_experts_per_tok
                      / tmoe.padded_experts(cfg.num_experts)))
    flat, flat_full = out.reshape(-1, gs, cfg.d_model), full.reshape(
        -1, gs, cfg.d_model)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(flat[:, :cap], flat_full[:, :cap])
    assert (flat[:, cap:] == 0).all()
