"""The port's examples 8–9 against the reference's examples (CPU).

``examples/torch_serve_decode.py`` and
``examples/torch_train_bittide_cluster.py`` make their weights with the
port's ``materialize`` from a seeded ``torch.Generator`` and their batches
with the port's synthetic stream; neither gives the reference's bits
(``ROADMAP.md`` §3).  So each test runs the port's example on the
reference's own weights, carried across with ``repro_torch.convert``
(``materialize(..., PRNGKey(0))`` as the reference's example makes them),
and, for training, on the reference's own batches, by replacing the
example's ``init_params`` / ``make_pipeline``; the reference's examples
run untouched beside them.

Tolerances: greedy tokens equal wherever the reference's top-1 / top-2
logit margin exceeds ``MARGIN`` (``tests/test_torch_models_serving.py``;
past a narrower margin a token may flip on a bf16 ulp and the sequences
part there); the first step's loss at rel ``LOSS_REL``
(``tests/test_torch_train_zoo.py``) of the reference's printed loss;
the ring schedule's integers exactly; other printed numbers within one
unit of the reference's last digit.  The cluster's sync runs the
discrete controller, which rounds to whole FINC/FDEC pulses: β differs
from the reference's by float32 ulps from the first periods (XLA's fused
multiply-adds), and where the pulse count lies at a rounding tie the two
packages part by one pulse (``fs`` = 0.1 ppm) and follow their own
trajectories from there.  The test finds the first such record in both
packages' ``sync`` records, holds every record before it at
``FREQ_ATOL_PPM``, the parting at a whole number of pulses, and the
convergence time exactly; the printed spread is held only where no
record parted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from engine_harness import FREQ_ATOL_PPM  # noqa: E402
from test_torch_models_serving import MARGIN  # noqa: E402
from test_torch_train_zoo import LOSS_REL  # noqa: E402
from torch_examples import (assert_printed, assert_same_lines,  # noqa: E402
                            one_torch_thread,
                            load, numbers, run_main, run_port, run_script)

import repro.core as rc  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.models import ModelZoo as RefZoo  # noqa: E402
from repro.models.layers import materialize as ref_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402

RATE = (r"in \d+ ms", r"\(\d+ tok/s\)", r"tok/s\s+\d+")
FS_PPM = 0.1            # the cluster sync's FINC/FDEC step, 1e-7, in ppm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def reference_params(arch):
    """The reference example's weights, and the port's copy of them."""
    cfg = ref_config(arch).reduced() if isinstance(arch, str) else arch
    params = ref_materialize(RefZoo(cfg).param_defs(), jax.random.PRNGKey(0),
                             jnp.float32)
    return params, convert.model_params(jax.tree.map(np.asarray, params),
                                        device="cpu")


def reference_logits(arch, params, tokens, prompt):
    """The reference's last-position logits along its own greedy tokens:
    prefill on the prompt, then one decode step per token fed back."""
    zoo = RefZoo(ref_config(arch).reduced())
    logits, caches = jax.jit(zoo.prefill)(params, {"tokens": prompt})
    decode = jax.jit(zoo.decode)
    out = [np.asarray(logits)[:, -1, :]]
    for i in range(tokens.shape[1] - 1):
        caches = {k: (jnp.pad(v, [(0, 0)] * 3 + [(0, 1), (0, 0), (0, 0)])
                      if k in ("kv", "shared_kv") else v)
                  for k, v in caches.items()}
        logits, caches = decode(params, caches,
                                {"tokens": jnp.asarray(tokens[:, i:i + 1])})
        out.append(np.asarray(logits)[:, -1, :])
    return np.stack(out, axis=1)


def test_serve_decode_matches_the_reference(monkeypatch):
    arch = "smollm-135m"
    ref_mod = load("serve_decode")
    want, ref = run_main(ref_mod, ["--smoke"])
    params, tparams = reference_params(arch)
    mod = load("torch_serve_decode")
    monkeypatch.setattr(mod, "init_params", lambda zoo, device: tparams)
    got, lines = run_port("serve_decode", ["--smoke"], mod=mod)
    assert_same_lines(lines, ref, reworded={0}, masks=RATE)
    assert lines[0].startswith("[prefill] 2 x 8 tokens in ")
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    prompt = np.random.default_rng(0).integers(
        0, ref_config(arch).reduced().vocab_size, (2, 8)).astype(np.int32)
    logits = reference_logits(arch, params, want, prompt)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > MARGIN
    compared = 0
    for b in range(want.shape[0]):
        for i in range(want.shape[1]):
            if not sure[b, i]:
                break       # the sequences may part from here
            assert got[b, i] == want[b, i], (b, i)
            compared += 1
    assert compared > 0


class ReferenceBatches:
    """The reference's synthetic batches as the port's tensors."""

    def __init__(self, cfg, seq, batch):
        self.ref = RefPipeline(RefDataConfig(cfg.vocab_size, seq, batch,
                                             seed=0))

    def batch(self, step, device=None):
        return {k: torch.as_tensor(np.asarray(v), device=device)
                for k, v in self.ref.batch(step).items()}


def sync_parting(port_freq, ref_freq):
    """The first record where the two syncs part by more than
    ``FREQ_ATOL_PPM`` (None if none), after checking that it parts by a
    whole number of pulses."""
    diff = np.abs(port_freq - ref_freq)
    bad = np.nonzero(diff.max(axis=1) > FREQ_ATOL_PPM)[0]
    if not len(bad):
        return None
    first = diff[bad[0]]
    pulses = np.round(first / FS_PPM)
    assert pulses.max() >= 1
    np.testing.assert_allclose(first, pulses * FS_PPM, rtol=0,
                               atol=FREQ_ATOL_PPM)
    return int(bad[0])


def test_train_bittide_cluster_matches_the_reference(monkeypatch, tmp_path):
    """``--tiny --steps 3`` on the reference's weights and batches, then
    ``--resume --steps 4`` from the port's own checkpoint."""
    ref = run_script("train_bittide_cluster",
                     ["--tiny", "--steps", "3",
                      "--ckpt-dir", str(tmp_path / "ref")])
    cfg_ref = ref_config("smollm-135m").reduced()
    _, tparams = reference_params(cfg_ref)
    mod = load("torch_train_bittide_cluster")
    monkeypatch.setattr(mod, "init_params", lambda zoo, device: tparams)
    monkeypatch.setattr(mod, "make_pipeline", ReferenceBatches)
    argv = ["--tiny", "--ckpt-dir", str(tmp_path / "port")]
    got, lines = run_port("train_bittide_cluster", argv + ["--steps", "3"],
                          mod=mod)
    steps = (r"loss\s+[\d.]+ gnorm\s+[\d.]+ tok/s\s+\d+",
             r"loss [\d.]+ -> [\d.]+", r"checkpoint at \S+")
    assert_same_lines(lines, ref, reworded={0}, masks=steps)

    # the sync: the reference's records beside the port's
    net = rc.BittideNetwork.build(rc.mesh2d(4, 4), cable_m=2.0,
                                  osc=rc.OscillatorSpec(initial_ppm=8.0,
                                                        seed=0))
    want = net.sync(ctrl=rc.ControllerConfig(kind="discrete", kp=4e-8,
                                             fs=1e-7, pulses_per_update=50),
                    cfg=rc.SimConfig(dt=5e-5, steps=24_000, record_every=40,
                                     quantize_beta=True))
    parted = sync_parting(got["sync_freq_ppm"], np.asarray(want.sim.freq_ppm))
    printed = numbers(ref[0])
    assert got["converged"] and want.converged
    assert got["convergence_time_s"] == want.convergence_time_s
    assert_printed(got["convergence_time_s"] * 1e3, printed[1], "sync ms")
    if parted is None:
        assert_printed(got["freq_spread_ppm"], printed[2], "spread")
    else:
        assert got["sync_times"][parted] > got["convergence_time_s"]
        assert got["freq_spread_ppm"] <= 1.0
    assert got["ring_transfers"] == int(numbers(ref[1])[0])
    assert got["ring_makespan_ticks"] == int(numbers(ref[1])[1])

    # the first step's loss on the same weights and batch
    first = next(ln for ln in ref if ln.startswith("[train] step    0"))
    loss = float(first.split("loss")[1].split()[0])
    assert abs(got["first_loss"] - loss) <= LOSS_REL * abs(loss)
    assert sorted(got["losses"]) == [0, 1, 2] and got["steps"] == 3

    resumed, lines = run_port("train_bittide_cluster",
                              argv + ["--steps", "4", "--resume"], mod=mod)
    assert "[train] resumed from step 3" in lines
    assert resumed["start"] == 3 and sorted(resumed["losses"]) == [3]
    assert (tmp_path / "port" / "step_000000004").is_dir()
