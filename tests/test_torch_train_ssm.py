"""``ModelZoo.train_loss`` and its gradients on the port against the JAX
package for the SSM and hybrid families (mamba2-370m, zamba2-7b) at
``.reduced()``, at ``tests/test_torch_train_zoo.py``'s bars and with its
cases; and the SSD scan's backward at mamba2-370m's own chunk (256):
the reference's gradients are not finite there (``exp`` of the masked
segment sums overflows, and 0 · inf is NaN); the port's are, and equal
the reference's at a chunk of 64 (the same sums in shorter segments) at
those bars.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_train_zoo import (LOSS_REL, SSM_ARCHS,  # noqa: E402
                                  assert_grads_close, both_batches, case,
                                  check_forward_loss,
                                  check_gradients_match_reference,
                                  check_train_loss_matches_reference,
                                  check_train_step_reduces_loss, leaf_bar,
                                  leaves, over_bar, to_np)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import ModelZoo as RefZoo  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import value_and_grad  # noqa: E402
from repro_torch.models import ModelZoo  # noqa: E402


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_train_loss_matches_reference(name):
    check_train_loss_matches_reference(name)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_gradients_match_reference(name):
    check_gradients_match_reference(name)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_forward_loss(name):
    check_forward_loss(name)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_train_step_reduces_loss(name):
    check_train_step_reduces_loss(name)


def test_reference_own_gradients_part_past_the_bar():
    """Why a witness: the reference's jitted and op-by-op gradients of
    mamba2-370m (reduced) part by more than the elementwise bar on the
    convolution's leaves (bf16 sums that cancel), by less than the bar
    taken at the leaf's largest |gradient|."""
    c = case("mamba2-370m")
    _, jitted = c.reference()
    own = dict(leaves(c.reference_op_by_op()))
    for path in ("/layers/mamba/conv_b", "/layers/mamba/conv_w"):
        want = to_np(dict(leaves(jitted))[path])
        got = to_np(own[path])
        assert over_bar(got, want), path
        assert np.abs(got - want).max() <= leaf_bar(want)


def test_ssd_backward_at_a_long_chunk_is_finite():
    def cfgs(chunk):
        kw = dict(num_layers=1, ssm_chunk=chunk)
        return (dataclasses.replace(ref_config("mamba2-370m").reduced(), **kw),
                dataclasses.replace(get_config("mamba2-370m").reduced(), **kw))
    rng = np.random.default_rng(6)
    np_b = {k: rng.integers(0, 512, (1, 256)).astype(np.int32)
            for k in ("tokens", "labels")}
    rb, tb = both_batches(np_b)
    ref256, cfg256 = cfgs(256)
    ref64 = cfgs(64)[0]
    rz256, rz64 = RefZoo(ref256), RefZoo(ref64)
    rp = ref_materialize(rz256.param_defs(), jax.random.PRNGKey(0),
                         jnp.float32)
    _, g256 = jax.jit(jax.value_and_grad(rz256.train_loss))(rp, rb)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(g256))   # the reference's fault
    ref_loss, g64 = jax.jit(jax.value_and_grad(rz64.train_loss))(rp, rb)
    tp = convert.model_params(jax.tree.map(np.asarray, rp), device="cpu")
    loss, grads = value_and_grad(ModelZoo(cfg256).train_loss)(tp, tb)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_REL)

    def op_by_op():
        with jax.disable_jit():
            return jax.value_and_grad(rz64.train_loss)(rp, rb)[1]

    assert_grads_close(grads, g64, op_by_op, "mamba2 chunk 256 vs 64")
