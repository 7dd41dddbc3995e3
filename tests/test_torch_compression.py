"""The port's error-feedback int8 compression against the JAX package's,
on the CPU.

``compress`` / ``decompress`` / ``ef_roundtrip`` are held bit for bit to
``repro.optim.compression`` under hypothesis (seeds, scales over ten
decades, shapes, a carried error); mirrors of
``tests/test_substrates.py``'s ``test_compression_bounded_error`` and
``test_error_feedback_accumulates_exactly``, at their tolerances.  The
collective ``compressed_psum`` is in ``tests/test_torch_distributed.py``.
"""
import numpy as np
import pytest
from hypcompat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.optim import compression as ref  # noqa: E402

from repro_torch.optim.compression import (compress, decompress,  # noqa: E402
                                           ef_roundtrip, init_error_state)


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 10_000), scale=st.floats(1e-6, 1e4),
       n=st.integers(1, 300))
def test_compress_bit_equal_to_reference(seed, scale, n):
    rng = np.random.default_rng(seed)
    g = (rng.normal(0, scale, n) * rng.uniform(0, 1, n)).astype(np.float32)
    q, s = compress(torch.from_numpy(g))
    rq, rs = ref.compress(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(bits(s.numpy()), bits(rs))
    np.testing.assert_array_equal(bits(decompress(q, s).numpy()),
                                  bits(ref.decompress(rq, rs)))


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 10_000), scale=st.floats(1e-6, 1e4))
def test_ef_roundtrip_bit_equal_to_reference(seed, scale):
    """Twenty error-feedback rounds from a zero error, payload and
    residual bit for bit each round, on a (8, 16) gradient."""
    rng = np.random.default_rng(seed)
    e_t = init_error_state({"w": torch.zeros(8, 16)})["w"]
    e_r = jnp.zeros((8, 16), jnp.float32)
    for _ in range(20):
        g = rng.normal(0, scale, (8, 16)).astype(np.float32)
        p_t, e_t = ef_roundtrip(torch.from_numpy(g), e_t)
        p_r, e_r = ref.ef_roundtrip(jnp.asarray(g), e_r)
        np.testing.assert_array_equal(bits(p_t.numpy()), bits(p_r))
        np.testing.assert_array_equal(bits(e_t.numpy()), bits(e_r))


def test_round_half_to_even_and_clip_as_reference():
    """Ties at ±0.5 / ±1.5 / ±2.5 of the grid, zeros, and a lone extreme."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -0.0, 63.5],
                 np.float32)
    q, s = compress(torch.from_numpy(g))
    rq, rs = ref.compress(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist()[:7] == [127, 0, 2, 2, 0, -2, -2]
    np.testing.assert_array_equal(bits(s.numpy()), bits(rs))
    z = np.zeros(5, np.float32)   # all zeros: the 1e-12 floor of the scale
    q, s = compress(torch.from_numpy(z))
    rq, rs = ref.compress(jnp.asarray(z))
    np.testing.assert_array_equal(bits(s.numpy()), bits(rs))
    assert not q.any()


def test_init_error_state_is_f32_zeros_of_each_leaf():
    tree = {"a": torch.ones(2, 3, dtype=torch.bfloat16),
            "b": {"c": torch.ones(4)}}
    e = init_error_state(tree)
    assert e["a"].dtype == e["b"]["c"].dtype == torch.float32
    assert e["a"].shape == (2, 3) and not e["a"].any()


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 10_000), scale=st.floats(1e-6, 1e4))
def test_compression_bounded_error(seed, scale):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(0, scale, 32).astype(np.float32))
    q, s = compress(g)
    err = (decompress(q, s) - g).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-9  # half-ulp of the int8 grid


def test_error_feedback_accumulates_exactly():
    """Sum of EF-compressed payloads + final residual == sum of true grads."""
    rng = np.random.default_rng(0)
    e = torch.zeros(16)
    total_payload = np.zeros(16)
    total_true = np.zeros(16)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(0, 1, 16).astype(np.float32))
        payload, e = ef_roundtrip(g, e)
        total_payload += payload.numpy()
        total_true += g.numpy()
    np.testing.assert_allclose(total_payload + e.numpy(), total_true,
                               rtol=1e-4, atol=1e-4)
