"""The split decode against the reference's partitioned decode, value for
value, on the CPU.

The reference's ``make_decode_step`` is jitted on a (2 data, 2 model)
mesh of host devices (a jax subprocess of 4 forced host devices), its
parameters, caches and tokens placed by ``abstract_serve_args`` (the
caches as ``cache_defs`` lays them out: batch over "data", sequence
over "model" where 2 divides it), so GSPMD partitions it.  The port's
``make_decode_step`` runs on a (2, 2) gloo world
(``tests/torch_gloo.py``) with the same weights (the reference's
``materialize`` from ``PRNGKey(0)``, converted by ``repro_torch.convert``
and distributed by ``state_shardings``), the same caches (random bf16
values, placed by ``launch.train._cache_placements``) and the same
tokens.  For reduced llama3-8b (heads split), reduced smollm-135m with
its published 9 q / 3 kv heads (attention projections gathered) and
reduced pixtral-12b (the VLM family), at a cache length of 16 (each
rank holds its slice of the sequence; the combine, the write of slot
S-1 by the rank that holds it) and of 17 (replicated over "model"):
the logits and the returned caches lie within the serving bar of the
reference's (``SERVE_TOL``, ``tests/test_torch_tp_decode.py``'s).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_decode import CONFIGS, SERVE_TOL  # noqa: E402
from torch_gloo import ROOT, assert_ranks_ok, run_ranks  # noqa: E402

B = 4
SEQS = (16, 17)

# the reference: weights, caches and tokens made here and saved, with its
# partitioned decode's logits and caches, as float32 (bf16 values exactly)
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

arch, out, batch = sys.argv[1], sys.argv[2], int(sys.argv[3])
seqs = [int(s) for s in sys.argv[4:]]
cfg = get_config(arch).reduced()
if arch == "smollm-135m":
    cfg = dataclasses.replace(cfg, num_heads=9, num_kv_heads=3, head_dim=8)
zoo = ModelZoo(cfg)
params = materialize(zoo.param_defs(), jax.random.PRNGKey(0), jnp.float32)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rng = np.random.default_rng(7)
f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
save = {}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/")
        else:
            save[prefix + k] = f32(v)


flat(params, "param/")
step = jax.jit(make_decode_step(cfg))
for seq in seqs:
    shape = ShapeSpec("d", "decode", seq, batch)
    p_abs, c_abs, b_abs = abstract_serve_args(cfg, shape, mesh, ("data",))
    caches = {k: rng.normal(0, 1, v.shape).astype(ml_dtypes.bfloat16)
              for k, v in c_abs.items()}
    tok = rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    put = lambda x, a: jax.device_put(x, a.sharding)
    logits, new = step(jax.tree.map(put, params, p_abs),
                       jax.tree.map(put, caches, c_abs),
                       {"tokens": put(tok, b_abs["tokens"])})
    save[f"{seq}/tokens"] = tok
    save[f"{seq}/logits"] = f32(logits)
    for k in caches:
        save[f"{seq}/cache_in/{k}"] = f32(caches[k])
        save[f"{seq}/cache_out/{k}"] = f32(new[k])
np.savez(out, **save)
"""

# the port on a (2, 2) gloo world, on the reference's inputs
PORT_DECODE = CONFIGS + """
import json
import numpy as np
from torch.distributed.tensor import distribute_tensor
from repro_torch import convert
from repro_torch._tree import tree_map
from repro_torch.launch import make_decode_step, make_mesh_from_devices
from repro_torch.launch.train import (_cache_placements, _seq_split,
                                      state_shardings)

cfg = config(ARCH)
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


def excess(got, want):
    got, want = got.float(), torch.tensor(want)
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


out = {}
with torch.no_grad():
    for seq in SEQS:
        keys = [k.split("/")[-1] for k in data.files
                if k.startswith(f"{seq}/cache_in/")]
        caches = {}
        for k in keys:
            c = torch.tensor(data[f"{seq}/cache_in/{k}"]).to(torch.bfloat16)
            caches[k] = distribute_tensor(
                c, mesh, _cache_placements(cfg, mesh, k, c.shape))
        tok = torch.tensor(data[f"{seq}/tokens"])
        logits, new = make_decode_step(cfg)(p_m, caches, {"tokens": tok})
        out[seq] = dict(
            seq_split=_seq_split(new["kv"].placements, mesh),
            local_seq=new["kv"].to_local().shape[3],
            logits_excess=excess(logits.full_tensor(),
                                 data[f"{seq}/logits"]),
            logits_shape=list(logits.shape),
            cache_excess={k: excess(new[k].full_tensor(),
                                    data[f"{seq}/cache_out/{k}"])
                          for k in keys},
            cache_dtypes=sorted({str(new[k].dtype) for k in keys}))
if RANK == 0:
    with open(WORKDIR + "/port.json", "w") as f:
        json.dump(out, f)
"""


@pytest.mark.parametrize("arch", ["llama3-8b", "pixtral-12b", "smollm-135m"])
def test_split_decode_matches_the_partitioned_reference(tmp_path, arch):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", JAX_DECODE, arch, str(tmp_path / "ref.npz"),
         str(B)] + [str(s) for s in SEQS],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = run_ranks(f"ARCH = {arch!r}\nTOL = {SERVE_TOL}\nSEQS = {SEQS}\n"
                    + PORT_DECODE, 4, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "port.json").read_text())
    assert sorted(r) == sorted(str(s) for s in SEQS)
    for seq, c in r.items():
        split = int(seq) % 2 == 0
        assert c["seq_split"] == split, (seq, c)
        assert c["local_seq"] == (int(seq) // 2 if split else int(seq)), c
        assert c["logits_shape"] == [B, 1, c["logits_shape"][2]], c
        assert c["logits_excess"] <= 0.0, (seq, c)
        assert c["cache_dtypes"] == ["torch.bfloat16"], c
        assert c["cache_excess"] and max(c["cache_excess"].values()) <= 0.0, \
            (seq, c)
