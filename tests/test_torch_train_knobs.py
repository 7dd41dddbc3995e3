"""The training path's knobs, its train step and smollm-135m at full width
on the port, against the JAX package on the CPU.

  * ``tests/test_perf_knobs.py``'s knobs (``remat_policy`` dots / none,
    ``attn_causal_unroll``, ``loss_chunk=16``, ``attn_chunk=16``) keep
    the port's loss within rel 2e-3 and its gradients within rtol 5e-2 /
    atol 5e-4 of the base configuration's;
  * one ``launch.make_train_step`` step against the reference's
    ``train_step`` (``lr_schedule`` warm-up, default AdamW): loss,
    ``grad_norm``, ``step`` and the updated parameters;
  * smollm-135m at full width (d 576, 9 / 3 heads, vocab 49,152, the
    tied head) with depth cut to 2 layers, B 1, S 64: loss and every
    gradient leaf against the reference's at the zoo tests' bars.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_train_zoo import (GRAD_ATOL, GRAD_RTOL, LOSS_REL,  # noqa: E402
                                  assert_grads_close, both_batches, leaves,
                                  np_batch, to_np)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.train import make_train_step as ref_make_train_step  # noqa: E402
from repro.models import ModelZoo as RefZoo  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import make_train_step, value_and_grad  # noqa: E402
from repro_torch.models import ModelZoo, materialize  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

KNOBS = [dict(remat_policy="dots"), dict(remat_policy="none"),
         dict(attn_causal_unroll=True), dict(loss_chunk=16),
         dict(attn_chunk=16)]


def _base():
    cfg = get_config("smollm-135m").reduced()
    params = materialize(ModelZoo(cfg).param_defs(),
                         torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    _, batch = both_batches(np_batch(cfg, np.random.default_rng(0)))
    return cfg, params, batch


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_knobs_preserve_loss_and_gradients(knob):
    cfg, params, batch = _base()
    loss0, g0 = value_and_grad(ModelZoo(cfg).train_loss)(params, batch)
    loss1, g1 = value_and_grad(
        ModelZoo(dataclasses.replace(cfg, **knob)).train_loss)(params, batch)
    assert float(loss1) == pytest.approx(float(loss0), rel=LOSS_REL), knob
    for (path, a), (_, b) in zip(leaves(g1), leaves(g0)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{knob} {path}")


def test_make_train_step_matches_reference():
    name = "smollm-135m"
    cfg_ref, cfg = ref_config(name).reduced(), get_config(name).reduced()
    rp = ref_materialize(RefZoo(cfg_ref).param_defs(), jax.random.PRNGKey(0),
                         jnp.float32)
    np_b = np_batch(cfg, np.random.default_rng(2))
    rb, tb = both_batches(np_b)
    ref_step = jax.jit(ref_make_train_step(cfg_ref))
    from repro.optim import AdamWConfig as RefAdamWConfig
    rs = ref_adamw_init(rp, RefAdamWConfig(moment_dtype=cfg_ref.opt_moment_dtype))
    rp1, rs1, rm = ref_step(rp, rs, rb, jnp.asarray(0, jnp.int32))

    tp = convert.model_params(jax.tree.map(np.asarray, rp), device="cpu")
    from repro_torch.optim import AdamWConfig
    ts = adamw_init(tp, AdamWConfig(moment_dtype=cfg.opt_moment_dtype))
    tp1, ts1, tm = make_train_step(cfg)(tp, ts, tb, 0)
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_REL)
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=2e-2)
    assert int(tm["step"]) == int(rm["step"]) == 1
    assert int(ts1["count"]) == int(rs1["count"]) == 1
    # step 0's learning rate is 1.5e-6 and an Adam step moves a weight by
    # at most ~lr (+ decay): a leaf whose gradient's sign differs parts
    # by at most 2 lr
    lr0 = 3e-4 / 200
    for (path, a), (_, b) in zip(leaves(tp1), leaves(rp1)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0,
                                   atol=2.5 * lr0, err_msg=path)


def test_smollm_full_width_two_layers_matches_reference():
    cfg_ref = dataclasses.replace(ref_config("smollm-135m"), num_layers=2)
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=2)
    rz, zoo = RefZoo(cfg_ref), ModelZoo(cfg)
    rp = ref_materialize(rz.param_defs(), jax.random.PRNGKey(0), jnp.float32)
    rb, tb = both_batches(np_batch(cfg, np.random.default_rng(4), b=1, s=64))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(rz.train_loss))(rp, rb)
    tp = convert.model_params(jax.tree.map(np.asarray, rp), device="cpu")
    loss, grads = value_and_grad(zoo.train_loss)(tp, tb)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_REL)

    def op_by_op():
        with jax.disable_jit():
            return jax.value_and_grad(rz.train_loss)(rp, rb)[1]

    assert_grads_close(grads, ref_grads, op_by_op, "smollm-135m x 2 layers")
    assert grads["embed"].shape == (49_152, 576)

