"""The port's training modules against the JAX package's, on the CPU.

  * ``models.losses.chunked_xent``: value and gradients (hidden, head)
    against the reference's, with padded vocab and two chunk sizes, and
    the reference's ``ValueError`` when S % chunk != 0;
  * ``optim.adamw``: ``adamw_update`` over 10 steps given the same
    gradients, within 2 f32 ulps of each leaf's max |p| with f32 moments
    and one bf16 ulp with bf16 moments; ``global_norm``; ``lr_schedule``
    at steps 0, 199, 200, 5,000 and 10,000; mirrors of
    ``tests/test_substrates.py``'s optimizer tests;
  * ``data.pipeline``: mirrors of ``tests/test_substrates.py``'s data
    test (the draws are a torch generator's, not threefry's, so the
    tokens themselves differ from the reference's);
  * ``checkpoint.manager``: mirrors of the substrate tests, an async save
    snapshotted before its thread starts, and checkpoints across the two
    packages both ways, bit for bit, with equal ``meta.json``;
  * ``convert.model_params`` carries an AdamW state across;
  * activation checkpointing (``remat_policy``) changes what is saved
    and recomputed, not the values.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from test_torch_train_zoo import (GRAD_ATOL, GRAD_RTOL, LOSS_REL,  # noqa: E402
                                  leaves, to_np)

from repro.checkpoint import restore as ref_restore  # noqa: E402
from repro.checkpoint import save as ref_save  # noqa: E402
from repro.launch.train import lr_schedule as ref_lr_schedule  # noqa: E402
from repro.models.losses import chunked_xent as ref_xent  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import global_norm as ref_global_norm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore, save)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch import lr_schedule, value_and_grad  # noqa: E402
from repro_torch.models import ModelZoo, materialize  # noqa: E402
from repro_torch.models.losses import chunked_xent  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, global_norm)

F32_ULP_BAR, BF16_ULP_BAR = 2, 1    # AdamW: ulps of each leaf's max |p|


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("valid_vocab", [0, 90])
def test_chunked_xent_matches_reference(chunk, valid_vocab):
    rng = np.random.default_rng(chunk + valid_vocab)
    b, s, d, v = 2, 64, 32, 96
    hidden = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    head = rng.normal(0, 0.1, (d, v)).astype(np.float32)
    labels = rng.integers(0, valid_vocab or v, (b, s)).astype(np.int32)

    def ref_loss(h, w):
        return ref_xent(h, w, jnp.asarray(labels), chunk, valid_vocab)

    rh = jnp.asarray(hidden, jnp.bfloat16)
    rloss, (rgh, rgw) = jax.value_and_grad(ref_loss, (0, 1))(
        rh, jnp.asarray(head))
    th = torch.tensor(hidden).to(torch.bfloat16).requires_grad_(True)
    tw = torch.tensor(head).requires_grad_(True)
    tloss = chunked_xent(th, tw, torch.tensor(labels), chunk, valid_vocab)
    tgh, tgw = torch.autograd.grad(tloss, (th, tw))
    assert float(tloss.detach()) == pytest.approx(float(rloss), rel=LOSS_REL)
    np.testing.assert_allclose(to_np(tgh), to_np(rgh), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(to_np(tgw), to_np(rgw), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if valid_vocab:   # no probability mass, so no gradient, on pad classes
        assert not tgw[:, valid_vocab:].any()


def test_chunked_xent_rejects_a_ragged_chunk():
    h = torch.zeros((1, 48, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="loss_chunk"):
        chunked_xent(h, torch.zeros((4, 8)), torch.zeros((1, 48),
                                                          dtype=torch.int32),
                     32)


# ----------------------------------------------------------------- optim

def _opt_tree(rng):
    return {"a": rng.normal(0, 1, (4, 8)).astype(np.float32),
            "z": {"b": rng.normal(0, 0.1, (16,)).astype(np.float32),
                  "c": rng.normal(0, 3, (2, 3, 5)).astype(np.float32)}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_ten_steps_match_reference(moments):
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(10)]
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
                  moment_dtype=moments)
    from repro.optim import AdamWConfig as RefAdamWConfig
    rcfg, tcfg = RefAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_adamw_init(rp, rcfg)
    tp = convert.model_params(params, device="cpu")
    ts = adamw_init(tp, tcfg)
    for i, g in enumerate(grads):
        scale = 0.5 + i / 4     # clipped in the later steps
        rg = jax.tree.map(lambda x: jnp.asarray(x * scale), g)
        tg = convert.model_params(jax.tree.map(lambda x: x * scale, g),
                                  device="cpu")
        rp, rs, rn = ref_adamw_update(rg, rs, rp, rcfg)
        tp, ts, tn = adamw_update(tg, ts, tp, tcfg)
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
    assert int(ts["count"]) == int(rs["count"]) == 10
    assert ts["count"].dtype == torch.int32
    ulps, dt = ((F32_ULP_BAR, np.float32) if moments == "float32"
                else (BF16_ULP_BAR, ml_dtypes.bfloat16))
    for (path, got), (_, want) in zip(leaves(tp),
                                      leaves(jax.tree.map(np.asarray, rp))):
        bar = ulps * float(np.spacing(dt(np.abs(want).max())))
        err = np.abs(to_np(got) - np.asarray(want, np.float32)).max()
        assert err <= bar, (path, err, bar)
    for key in ("mu", "nu"):
        for (path, got), (_, want) in zip(
                leaves(ts[key]), leaves(jax.tree.map(np.asarray,
                                                       rs[key]))):
            assert got.dtype == getattr(torch, moments), path
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2,
                                       atol=1e-7, err_msg=f"{key}{path}")


def test_global_norm_matches_reference():
    tree = _opt_tree(np.random.default_rng(3))
    want = float(ref_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm(convert.model_params(tree, device="cpu")))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("step", [0, 199, 200, 5_000, 10_000])
def test_lr_schedule_matches_reference(step):
    got = lr_schedule(step)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(ref_lr_schedule(step)),
                                       rel=1e-6, abs=1e-12)


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clips_global_norm():
    cfg = AdamWConfig(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params, cfg)
    _, _, gnorm = adamw_update({"w": torch.full((4,), 100.0)}, state, params,
                               cfg)
    assert float(gnorm) == pytest.approx(200.0, rel=1e-5)


def test_adamw_update_leaves_its_inputs_unchanged():
    """The update is functional: a snapshot of the old state stays valid
    (the async checkpoint relies on no in-place write)."""
    cfg = AdamWConfig(lr=1e-2)
    params = {"w": torch.ones(3)}
    state = adamw_init(params, cfg)
    before = (params["w"].clone(), state["mu"]["w"].clone())
    new_p, new_s, _ = adamw_update({"w": torch.ones(3)}, state, params, cfg)
    assert torch.equal(params["w"], before[0])
    assert torch.equal(state["mu"]["w"], before[1])
    assert int(state["count"]) == 0 and int(new_s["count"]) == 1
    assert not torch.equal(new_p["w"], params["w"])


def test_convert_carries_a_reference_adamw_state():
    from repro.optim import AdamWConfig as RefAdamWConfig
    rng = np.random.default_rng(5)
    rp = jax.tree.map(jnp.asarray, _opt_tree(rng))
    rcfg = RefAdamWConfig(moment_dtype="bfloat16")
    _, rs, _ = ref_adamw_update(jax.tree.map(jnp.asarray, _opt_tree(rng)),
                                ref_adamw_init(rp, rcfg), rp, rcfg)
    ts = convert.model_params(jax.tree.map(np.asarray, rs), device="cpu",
                              dtype=torch.float32)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 1
    assert ts["mu"]["a"].dtype == torch.float32
    np.testing.assert_array_equal(to_np(ts["nu"]["z"]["c"]),
                                  to_np(rs["nu"]["z"]["c"]))


# ------------------------------------------------------------------ data

def test_data_deterministic_and_stateless():
    cfg = DataConfig(vocab_size=101, seq_len=16, global_batch=4, seed=7)
    p1, p2 = SyntheticPipeline(cfg), SyntheticPipeline(cfg)
    b1, b2 = p1.batch_numpy(12), p2.batch_numpy(12)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = p1.batch_numpy(13)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 101
    assert b1["tokens"].dtype == np.int32 and b1["tokens"].shape == (4, 16)
    # labels are next-token shifts of one underlying sequence
    cfg2 = DataConfig(vocab_size=101, seq_len=16, global_batch=4, seed=7,
                      noise=0.0)
    b = SyntheticPipeline(cfg2).batch_numpy(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    # noiseless chain is the affine map
    np.testing.assert_array_equal(b["labels"],
                                  (b["tokens"] * 17 + 31) % 101)


def test_data_noise_share_and_seeds():
    cfg = DataConfig(vocab_size=1009, seq_len=256, global_batch=8, seed=0)
    b = SyntheticPipeline(cfg).batch_numpy(3)
    follows = b["labels"] == (b["tokens"].astype(np.int64) * 17 + 31) % 1009
    assert 0.75 < follows.mean() < 0.85           # noise 0.2 (+ 1 / V)
    other = SyntheticPipeline(dataclasses.replace(cfg, seed=1)).batch_numpy(3)
    assert not np.array_equal(b["tokens"], other["tokens"])
    got = SyntheticPipeline(cfg).batch(3, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), b["tokens"])
    assert got["labels"].dtype == torch.int32


# ------------------------------------------------------------ checkpoint

def _ckpt_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.linspace(-3, 3, 4).to(torch.bfloat16)},
            "count": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _ckpt_tree()
    save(str(tmp_path), 42, tree, extra={"note": "hi"})
    assert latest_step(str(tmp_path)) == 42
    out = restore(str(tmp_path), 42, tree, device="cpu")
    for k in ("a", "count"):
        assert torch.equal(out[k], tree[k]) and out[k].dtype == tree[k].dtype
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    assert out["nested"]["b"].dtype == torch.bfloat16


def test_checkpoint_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((3,), float(s))}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]  # keep=2
    step, out = mgr.restore_latest(tree, device="cpu")
    assert step == 4 and float(out["w"][0]) == 4.0


def test_checkpoint_async_save_snapshots_before_its_thread(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.ones(1 << 16)
    mgr.save(1, {"w": w}, blocking=False)
    w.mul_(5.0)                    # the next step changes the tensor
    mgr.wait()
    out = restore(str(tmp_path), 1, {"w": w}, device="cpu")
    assert torch.equal(out["w"], torch.ones(1 << 16))


def test_checkpoint_atomicity(tmp_path):
    """A valid older checkpoint survives even if a later save is
    interrupted (simulated by a tmp dir left behind)."""
    save(str(tmp_path), 1, {"w": torch.ones(2)})
    os.makedirs(tmp_path / ".tmp_save_interrupted")
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_rejects_another_structure(tmp_path):
    save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore(str(tmp_path), 1, {"v": torch.ones(2)}, device="cpu")


def _ref_ckpt_tree():
    return {"opt": {"count": jnp.asarray(7, jnp.int32),
                    "mu": {"w": jnp.linspace(-1, 1, 6, dtype=jnp.float32)
                           .reshape(2, 3)}},
            "params": {"embed": jnp.asarray(
                np.random.default_rng(0).normal(0, 1, (4, 5)),
                jnp.bfloat16),
                "norm": jnp.ones((5,), jnp.float32)}}


def _meta(path, step):
    with open(os.path.join(path, f"step_{step:09d}", "meta.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    ref_tree = _ref_ckpt_tree()
    ref_save(str(tmp_path / "ref"), 5, ref_tree, extra={"k": 1})
    template = convert.model_params(jax.tree.map(np.asarray, ref_tree),
                                    device="cpu")
    out = restore(str(tmp_path / "ref"), 5, template, device="cpu")
    for (path, got), (_, want) in zip(leaves(out), leaves(ref_tree)):
        want = np.asarray(want)
        assert str(got.dtype).split(".")[1] == want.dtype.name, path
        view = np.uint16 if want.dtype.name == "bfloat16" else want.dtype
        got_bits = (got.view(torch.int16).numpy().view(np.uint16)
                    if got.dtype == torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(got_bits, want.view(view), path)
    # the port writes the same meta.json
    save(str(tmp_path / "port"), 5, template, extra={"k": 1})
    assert _meta(tmp_path / "port", 5) == _meta(tmp_path / "ref", 5)
    assert _meta(tmp_path / "ref", 5)["names"][0] == "['opt']/['count']"


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    ref_tree = _ref_ckpt_tree()
    tree = convert.model_params(jax.tree.map(np.asarray, ref_tree),
                                device="cpu")
    save(str(tmp_path), 9, tree)
    out = ref_restore(str(tmp_path), 9, ref_tree)
    for (path, got), (_, want) in zip(leaves(out), leaves(ref_tree)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, path
        view = np.uint16 if want.dtype.name == "bfloat16" else want.dtype
        np.testing.assert_array_equal(got.view(view), want.view(view), path)
    with np.load(tmp_path / "step_000000009" / "arrays.npz") as data:
        assert data["['params']/['embed']"].dtype == np.uint16


# ----------------------------------------------------------------- remat

def _smollm_grads(policy):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              remat_policy=policy)
    zoo = ModelZoo(cfg)
    params = materialize(zoo.param_defs(), torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 64)),
                             dtype=torch.int32) for k in ("tokens", "labels")}
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = zoo.train_loss(params, batch)
    with FlopCounterMode(display=False) as flops:
        grads = torch.autograd.grad(loss, live)
    return loss, grads, sum(saved), flops.get_total_flops()


def test_remat_policies_change_memory_not_values():
    """"nothing" saves only the checkpointed bodies' inputs and
    recomputes their matmuls in the backward; "dots" saves the matmuls'
    outputs (no matmul recomputed); "none" saves everything.  Loss and
    gradients are bit-identical across the three."""
    out = {p: _smollm_grads(p) for p in ("nothing", "dots", "none")}
    base_loss, base_grads, _, _ = out["nothing"]
    for policy, (loss, grads, _, _) in out.items():
        assert torch.equal(loss, base_loss), policy
        for g, b in zip(grads, base_grads):
            assert torch.equal(g, b), policy
    saved = {p: out[p][2] for p in out}
    flops = {p: out[p][3] for p in out}
    assert saved["nothing"] < saved["none"] / 2, saved
    assert flops["dots"] == flops["none"] < flops["nothing"], flops


def test_value_and_grad_matches_autograd_on_the_leaves():
    params = {"b": {"x": torch.tensor([1.0, 2.0])}, "a": torch.tensor(3.0)}
    loss, grads = value_and_grad(
        lambda p, k: k * p["a"] * (p["b"]["x"] ** 2).sum())(params, 2.0)
    assert float(loss) == 30.0 and not loss.requires_grad
    assert float(grads["a"]) == 10.0
    assert torch.equal(grads["b"]["x"], torch.tensor([12.0, 24.0]))
    assert not params["a"].requires_grad
