"""The MoE family's split decode against the reference's partitioned
decode, value for value, on the CPU.

The reference's ``make_decode_step`` is jitted on a (2 data, 2 model)
mesh of host devices (a jax subprocess of 4 forced host devices), its
parameters, caches and tokens placed by ``abstract_serve_args``, so
GSPMD partitions it: its MoE block groups the 8 tokens of the global
batch as one group (capacity 2), which spans both data ranks.  The
port's ``make_decode_step`` runs on a (2, 2) gloo world
(``tests/torch_gloo.py``) with the same weights (the reference's
``materialize`` from ``PRNGKey(0)``, converted by ``repro_torch.convert``
and distributed by ``state_shardings``), the same caches and the same
tokens: each data rank holds 4 of the group's tokens, and the ranks of
a "model" group 4 of the 16 padded experts each.  The MoE weights are
the reference's scaled by ``GAIN``, so that the block's output weighs
in the logits.  Reduced
qwen2-moe-a2.7b with 14 routed experts (two inert pads on the last
rank), at a cache length of 16 (split on the sequence over "model")
and 17 (replicated over "model"): the logits and the returned caches
lie within the serving bar of the reference's (``SERVE_TOL``).

The reference's layers are unrolled (``unroll_layers``) so that its
jitted step can return each layer's router logits and top-k beside its
outputs.  Router logits are bf16 products: where the port's top-k of a
token differs from the reference's, the flip is excused only where the
reference's k-th and (k+1)-th logits lie within twice the largest
router-logit difference of that layer, and the port then takes the
reference's experts for that token; the test prints how many it
excused.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import ROOT, assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
ARCH, EXPERTS = "qwen2-moe-a2.7b", 14
# the MoE weights scaled up from init's std 0.02, at which the block's
# output (|x| <= 0.015) is lost beside the residual stream's (about 1)
# at the serving bar, so that a routing or capacity fault shows
GAIN = 4.0
B = 8
SEQS = (16, 17)

JAX_DECODE = r"""
import dataclasses, sys
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.train import abstract_serve_args, make_decode_step
from repro.models import ModelZoo
from repro.models.layers import materialize

arch, out, batch, experts, gain = (sys.argv[1], sys.argv[2],
                                   int(sys.argv[3]), int(sys.argv[4]),
                                   float(sys.argv[5]))
seqs = [int(s) for s in sys.argv[6:]]
cfg = dataclasses.replace(get_config(arch).reduced(), num_experts=experts,
                          unroll_layers=True)
zoo = ModelZoo(cfg)
params = materialize(zoo.param_defs(), jax.random.PRNGKey(0), jnp.float32)
moe = params["layers"]["moe"]
for w in ("w1", "w3", "w2", "shared_w1", "shared_w3", "shared_w2"):
    moe[w] = moe[w] * gain
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rng = np.random.default_rng(7)
f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
save = {}

# each layer's router logits and top-k, returned beside the outputs
ROUTES = []
_top_k = jax.lax.top_k


def top_k(x, k):
    vals, idx = _top_k(x, k)
    ROUTES.append((x, idx))
    return vals, idx


jax.lax.top_k = top_k
decode = make_decode_step(cfg)


def with_routes(p, c, b):
    ROUTES.clear()
    logits, new = decode(p, c, b)
    return logits, new, list(ROUTES)


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/")
        else:
            save[prefix + k] = f32(v)


flat(params, "param/")
step = jax.jit(with_routes)
for seq in seqs:
    shape = ShapeSpec("d", "decode", seq, batch)
    p_abs, c_abs, b_abs = abstract_serve_args(cfg, shape, mesh, ("data",))
    caches = {k: rng.normal(0, 1, v.shape).astype(ml_dtypes.bfloat16)
              for k, v in c_abs.items()}
    tok = rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    put = lambda x, a: jax.device_put(x, a.sharding)
    logits, new, routes = step(jax.tree.map(put, params, p_abs),
                               jax.tree.map(put, caches, c_abs),
                               {"tokens": put(tok, b_abs["tokens"])})
    assert len(routes) == cfg.num_layers, len(routes)
    save[f"{seq}/tokens"] = tok
    save[f"{seq}/logits"] = f32(logits)
    for j, (lg, ix) in enumerate(routes):
        save[f"{seq}/router/{j}"] = f32(lg).reshape(batch, -1)
        save[f"{seq}/topk/{j}"] = np.asarray(ix).reshape(batch, -1)
    for k in caches:
        save[f"{seq}/cache_in/{k}"] = f32(caches[k])
        save[f"{seq}/cache_out/{k}"] = f32(new[k])
np.savez(out, **save)
"""

PORT_DECODE = """
import dataclasses, json
import numpy as np
from torch.distributed.tensor import distribute_tensor
import repro_torch.models.moe as moe_mod
from repro_torch import convert
from repro_torch._tree import tree_map
from repro_torch.configs import get_config
from repro_torch.launch import make_decode_step, make_mesh_from_devices
from repro_torch.launch.train import _cache_placements, state_shardings

cfg = dataclasses.replace(get_config(ARCH).reduced(), num_experts=EXPERTS)
mesh = make_mesh_from_devices(range(WORLD), (2, 2), ("data", "model"),
                              device_type="cpu")
data = np.load(WORKDIR + "/ref.npz")
tree = {}
for key in data.files:
    if key.startswith("param/"):
        *path, leaf = key.split("/")[1:]
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = data[key]
p = convert.model_params(tree, device="cpu")
p_m = tree_map(lambda t, sh: distribute_tensor(t, *sh), p,
               state_shardings(cfg, mesh)["params"])

# the reference's routing of this rank's tokens, adopted on near ties
_top_k = moe_mod.top_k
HOOK = dict(seq=None, calls=0, flips=0, excused=0)


def hooked_top_k(logits, k):
    vals, idx = _top_k(logits, k)
    j, seq = HOOK["calls"], HOOK["seq"]
    HOOK["calls"] += 1
    n = logits.shape[0] * logits.shape[1]
    lo = mesh.get_local_rank("data") * n
    ref_l = torch.tensor(data[f"{seq}/router/{j}"][lo:lo + n])
    ref_i = torch.tensor(data[f"{seq}/topk/{j}"][lo:lo + n]).long()
    flat_l, flat_i = logits.reshape(n, -1), idx.reshape(n, k)
    flip = (flat_i.sort(-1).values != ref_i.sort(-1).values).any(-1)
    if bool(flip.any()):
        err = float((ref_l - flat_l).abs().max())
        top = ref_l.sort(-1, descending=True).values
        near = (top[:, k - 1] - top[:, k]) <= 2 * err
        HOOK["flips"] += int(flip.sum())
        HOOK["excused"] += int((flip & near).sum())
        flat_i = torch.where(flip[:, None], ref_i, flat_i)
        idx = flat_i.reshape(idx.shape)
        vals = torch.gather(flat_l, -1, flat_i).reshape(vals.shape)
    return vals, idx


moe_mod.top_k = hooked_top_k


def excess(got, want):
    got, want = got.float(), torch.tensor(want)
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


out = {}
with torch.no_grad():
    for seq in SEQS:
        c = torch.tensor(data[f"{seq}/cache_in/kv"]).to(torch.bfloat16)
        caches = {"kv": distribute_tensor(
            c, mesh, _cache_placements(cfg, mesh, "kv", c.shape))}
        tok = torch.tensor(data[f"{seq}/tokens"])
        HOOK.update(seq=seq, calls=0)
        logits, new = make_decode_step(cfg)(p_m, caches, {"tokens": tok})
        out[seq] = dict(
            layers=HOOK["calls"],
            logits_excess=excess(logits.full_tensor(),
                                 data[f"{seq}/logits"]),
            logits_shape=list(logits.shape),
            cache_excess=excess(new["kv"].full_tensor(),
                                data[f"{seq}/cache_out/kv"]),
            local_batch=new["kv"].to_local().shape[2])
out["flips"], out["excused"] = HOOK["flips"], HOOK["excused"]
if RANK == 0:
    with open(WORKDIR + "/port.json", "w") as f:
        json.dump(out, f)
"""


def test_moe_split_decode_matches_the_partitioned_reference(tmp_path):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", JAX_DECODE, ARCH, str(tmp_path / "ref.npz"),
         str(B), str(EXPERTS), str(GAIN)] + [str(s) for s in SEQS],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = run_ranks(f"ARCH = {ARCH!r}\nEXPERTS = {EXPERTS}\n"
                    f"TOL = {SERVE_TOL}\nSEQS = {SEQS}\n" + PORT_DECODE, 4,
                    tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "port.json").read_text())
    print(f"{r['excused']} of {r['flips']} top-k flips against the "
          "reference excused as near ties")
    assert r["excused"] == r["flips"], r
    for seq in SEQS:
        c = r[str(seq)]
        assert c["layers"] == 3 and c["local_batch"] == B // 2, c
        assert c["logits_shape"] == [B, 1, c["logits_shape"][2]], c
        assert c["logits_excess"] <= 0.0, (seq, c)
        assert c["cache_excess"] <= 0.0, (seq, c)
