"""The FSDP train step against the reference's, on the CPU: reduced
llama3-8b with FSDP forced in both packages (``FSDP_PARAM_THRESHOLD = 0``
in each, as a test sets it).

The reference's ``make_train_step`` is jitted on a (2 data, 2 model)
mesh of host devices (a jax subprocess of 4 forced host devices), its
state placed by its ``init_train_state`` (weights and moments sharded
over "data" on their "fsdp" dimension and over "model"), its batch over
"data", so that GSPMD partitions it, keeping the weights sharded through
its ``lax.scan``.  The port's ``make_train_step`` runs on a (2, 2) gloo
world (``tests/torch_gloo.py``) with the same weights (the reference's
``materialize`` from ``PRNGKey(0)``, converted by ``repro_torch.convert``
and distributed by ``state_shardings``), holding the stacked leaves as
shards and gathering each layer's slice in the layer loop.  The loss,
the gradient norm, the first moments and the new parameters lie within
``PERF.md`` §2's bars of the reference's (``tests/test_torch_fsdp_train.py``'s
rule for parameters whose two gradients have opposite signs).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp_train import (GRAD_ATOL, GRAD_RTOL,  # noqa: E402
                                   LOSS_REL)
from torch_gloo import ROOT, assert_ranks_ok, run_ranks  # noqa: E402

STEP = 1000

JAX_TRAIN = r"""
import sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.launch.train as train_mod
from repro.configs import get_config
from repro.launch.train import init_train_state, make_train_step

train_mod.FSDP_PARAM_THRESHOLD = 0
out, step_n = sys.argv[1], int(sys.argv[2])
cfg = get_config("llama3-8b").reduced()
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
params, opt_state = init_train_state(cfg, mesh, jax.random.PRNGKey(0))
assert "data" in str(params["layers"]["attn"]["wq"].sharding.spec)
rng = np.random.default_rng(3)
toks = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
batch = {k: jax.device_put(v, NamedSharding(mesh, P("data", None)))
         for k, v in batch.items()}
new, opt, m = jax.jit(make_train_step(cfg))(params, opt_state, batch,
                                            step_n)
save = {"loss": np.asarray(m["loss"]), "grad_norm": np.asarray(m["grad_norm"]),
        "tokens": toks}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/")
        else:
            save[prefix + k] = np.asarray(v)


flat(params, "param/")
flat(new, "new/")
flat(opt["mu"], "mu/")
np.savez(out, **save)
"""

PORT_TRAIN = """
import json
import numpy as np
import repro_torch.launch.train as train_mod
from torch.distributed.tensor import distribute_tensor
from repro_torch import convert
from repro_torch._tree import tree_flatten_with_path, tree_map
from repro_torch.configs import get_config
from repro_torch.launch import (make_mesh_from_devices, make_train_step,
                                state_shardings)
from repro_torch.optim import AdamWConfig, adamw_init

train_mod.FSDP_PARAM_THRESHOLD = 0
cfg = get_config("llama3-8b").reduced()
mesh = make_mesh_from_devices(range(WORLD), (2, 2), ("data", "model"),
                              device_type="cpu")
data = np.load(WORKDIR + "/ref.npz")


def unflat(prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return tree


p = convert.model_params(unflat("param/"), device="cpu")
opt = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
state = tree_map(lambda t, sh: distribute_tensor(t, *sh),
                 {"params": p, "opt": adamw_init(p, opt)},
                 state_shardings(cfg, mesh))
held = str(state["params"]["layers"]["attn"]["wq"].placements)
toks = torch.from_numpy(data["tokens"])
batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
new, opt_state, m = make_train_step(cfg, opt)(state["params"], state["opt"],
                                             batch, STEP)
want = lambda prefix: dict(tree_flatten_with_path(
    convert.model_params(unflat(prefix), device="cpu")))


def over(a, b):
    return float(((a - b).abs() - (GRAD_ATOL + GRAD_RTOL * b.abs())).max())


mu_want, new_want = want("mu/"), want("new/")
mu, params, flipped, elements = -1.0, -1.0, 0, 0
for path, a in tree_flatten_with_path(opt_state["mu"]):
    a, b = a.full_tensor() / (1 - B1), mu_want[path] / (1 - B1)
    mu = max(mu, over(a, b))
    keep = torch.sign(a) == torch.sign(b)
    flipped += int((~keep).sum())
    elements += a.numel()
    got_p = dict(tree_flatten_with_path(new))[path].full_tensor()
    params = max(params, over(got_p[keep], new_want[path][keep]))
out = dict(held=held, mu_excess=mu, params_excess=params, flipped=flipped,
           elements=elements, all_reduces=m["all_reduces"],
           loss_rel=abs(float(m["loss"]) - float(data["loss"]))
           / abs(float(data["loss"])),
           gnorm_rel=abs(float(m["grad_norm"]) - float(data["grad_norm"]))
           / abs(float(data["grad_norm"])))
if RANK == 0:
    with open(WORKDIR + "/port.json", "w") as f:
        json.dump(out, f)
"""


def test_fsdp_train_step_matches_the_partitioned_reference(tmp_path):
    from repro_torch.optim import AdamWConfig
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", JAX_TRAIN, str(tmp_path / "ref.npz"),
         str(STEP)], cwd=ROOT, capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = run_ranks(f"STEP = {STEP}\nGRAD_RTOL = {GRAD_RTOL}\n"
                    f"GRAD_ATOL = {GRAD_ATOL}\nB1 = {AdamWConfig().b1}\n"
                    + PORT_TRAIN, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "port.json").read_text())
    print(f"{r['flipped']} of {r['elements']} gradient signs flipped")
    # "data" on the leaf's "fsdp" dimension, "model" on its "model" one
    assert r["held"] == "(Shard(dim=1), Shard(dim=2))", r
    assert r["loss_rel"] <= LOSS_REL, r
    assert r["gnorm_rel"] <= GRAD_RTOL, r
    assert r["mu_excess"] <= 0.0, r
    assert r["params_excess"] <= 0.0, r
    assert r["flipped"] < r["elements"] // 100, r
