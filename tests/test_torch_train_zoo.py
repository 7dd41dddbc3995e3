"""``ModelZoo.train_loss`` and its gradients on the port against the JAX
package, for every architecture at ``.reduced()`` (B 2, S 64, the
reference's smoke sizes): the attention families here, the SSM and
hybrid families in ``tests/test_torch_train_ssm.py`` (two files, so that
``--dist loadfile`` spreads them).

The reference's weights (``materialize`` with ``PRNGKey(0)``) are
carried across by ``convert.model_params``; one seeded numpy batch goes
through the reference's jitted ``jax.value_and_grad(train_loss)`` and the
port's ``torch.autograd`` on the CPU.  Bars:

  * the loss within rel 2e-3 (``tests/test_perf_knobs.py``'s);
  * every gradient leaf within rtol 5e-2 / atol 5e-4 (the same file's
    gradient bar).  Where a leaf's gradient is a long sum of bf16 terms
    that cancel (the SSM convolution's, the embedding's) the reference's
    own jitted and op-by-op gradients part by more than that bar
    (``tests/test_torch_train_ssm.py::
    test_reference_own_gradients_part_past_the_bar``); such a leaf is
    held instead within ``GRAD_WITNESS_RATIO`` × the reference's own
    parting (its largest error, op-by-op against jitted) and within the
    bar taken at the leaf's largest |gradient| (atol + rtol · max |g|:
    the card's fallback against the CPU, ``chip_smoke.train_card_vs_cpu``);
  * ``tests/test_models_smoke.py``'s properties on the port: the
    untrained loss within 1 of ln V, and 5 SGD steps (lr 0.1) on one
    batch lower it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import ModelZoo as RefZoo  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import value_and_grad  # noqa: E402
from repro_torch.models import ModelZoo  # noqa: E402

SSM_ARCHS = [n for n in ARCH_NAMES
             if get_config(n).family in ("ssm", "hybrid")]
ATTENTION_ARCHS = [n for n in ARCH_NAMES if n not in SSM_ARCHS]
LOSS_REL = 2e-3
GRAD_RTOL, GRAD_ATOL = 5e-2, 5e-4
GRAD_WITNESS_RATIO = 2.0
B, S = 2, 64


def np_batch(cfg, rng, b=B, s=S):
    """``tests/test_models_smoke.py``'s batch, as numpy."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(
            np.float32)
    return out


def both_batches(batch):
    """A numpy batch as the reference's and the port's (ints int32,
    embeddings bf16)."""
    ref = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int32
                          else jnp.bfloat16) for k, v in batch.items()}
    port = {k: torch.tensor(v) if v.dtype == np.int32
            else torch.tensor(v).to(torch.bfloat16) for k, v in batch.items()}
    return ref, port


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def over_bar(got, want) -> bool:
    return bool((np.abs(got - want) > GRAD_ATOL + GRAD_RTOL * np.abs(want))
                .any())


def leaf_bar(want) -> float:
    """The gradient bar at the leaf's largest |gradient|."""
    return GRAD_ATOL + GRAD_RTOL * float(np.abs(want).max())


def assert_grads_close(got, want, witness, what):
    """Every leaf within the gradient bar, or within both
    ``GRAD_WITNESS_RATIO`` × the reference's own parting (``witness()``:
    the reference's op-by-op gradients, computed only when needed) and
    the bar taken at the leaf's largest |gradient|."""
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    own = None
    for (path, a), (_, b) in zip(g, w):
        a, b = to_np(a), to_np(b)
        assert a.shape == b.shape and np.isfinite(a).all(), (what, path)
        if not over_bar(a, b):
            continue
        if own is None:
            own = dict(leaves(witness()))
        err = np.abs(a - b).max()
        ref_err = np.abs(to_np(own[path]) - b).max()
        assert err <= GRAD_WITNESS_RATIO * ref_err, (what, path, err,
                                                     ref_err)
        assert err <= leaf_bar(b), (what, path, err)


class Case:
    """One architecture's reference weights, batch, jitted loss and
    gradients, and the port's copies."""

    def __init__(self, name, seed=0):
        self.cfg_ref = ref_config(name).reduced()
        self.cfg = get_config(name).reduced()
        self.rz, self.zoo = RefZoo(self.cfg_ref), ModelZoo(self.cfg)
        self.ref_params = ref_materialize(self.rz.param_defs(),
                                          jax.random.PRNGKey(0), jnp.float32)
        self.params = convert.model_params(
            jax.tree.map(np.asarray, self.ref_params), device="cpu")
        self.ref_batch, self.batch = both_batches(
            np_batch(self.cfg, np.random.default_rng(seed)))
        self._ref = None

    def reference(self):
        if self._ref is None:
            self._ref = jax.jit(jax.value_and_grad(self.rz.train_loss))(
                self.ref_params, self.ref_batch)
        return self._ref

    def reference_op_by_op(self):
        with jax.disable_jit():
            return jax.value_and_grad(self.rz.train_loss)(
                self.ref_params, self.ref_batch)[1]


_CASES = {}


def case(name) -> Case:
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


def check_train_loss_matches_reference(name):
    c = case(name)
    with torch.no_grad():
        loss = c.zoo.train_loss(c.params, c.batch)
    ref_loss, _ = c.reference()
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_REL)


def check_gradients_match_reference(name):
    c = case(name)
    loss, grads = value_and_grad(c.zoo.train_loss)(c.params, c.batch)
    ref_loss, ref_grads = c.reference()
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_REL)
    assert_grads_close(grads, ref_grads, c.reference_op_by_op, name)


def check_forward_loss(name):
    c = case(name)
    rng = np.random.default_rng(0)
    _, batch = both_batches(np_batch(c.cfg, rng))
    with torch.no_grad():
        loss = float(c.zoo.train_loss(c.params, batch))
    assert np.isfinite(loss)
    # untrained loss should be near ln(V)
    assert abs(loss - np.log(c.cfg.vocab_size)) < 1.0


def check_train_step_reduces_loss(name):
    c = case(name)
    _, batch = both_batches(np_batch(c.cfg, np.random.default_rng(1)))
    step = value_and_grad(c.zoo.train_loss)
    p, losses = c.params, []
    for _ in range(5):
        loss, g = step(p, batch)
        p = {k: v for k, v in _sgd(p, g).items()}
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # same-batch SGD must reduce loss


def _sgd(p, g, lr=0.1):
    if isinstance(p, dict):
        return {k: _sgd(p[k], g[k], lr) for k in p}
    return p - lr * g


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_train_loss_matches_reference(name):
    check_train_loss_matches_reference(name)


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_gradients_match_reference(name):
    check_gradients_match_reference(name)


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_forward_loss(name):
    check_forward_loss(name)


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_train_step_reduces_loss(name):
    check_train_step_reduces_loss(name)
