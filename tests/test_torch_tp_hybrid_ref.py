"""The hybrid family's split prefill and decode against the reference's
partitioned ones, value for value, on the CPU.

The reference's ``make_prefill_step`` and ``make_decode_step`` are
jitted on a (2 data, 2 model) mesh of host devices (a jax subprocess of
4 forced host devices), their parameters, caches and tokens placed by
``abstract_serve_args``, so GSPMD partitions them: the shared block's
``w_in`` on its output d, its attention and MLP on their heads and
columns, the Mamba2 layers' ``in_proj`` and conv on their even "model"
shards of columns and channels, the ``shared_kv`` caches on their
sequence, the states on their heads.  The port's ``make_prefill_step``
and ``make_decode_step`` run on a (2, 2) gloo world
(``tests/torch_gloo.py``) with the same weights (the reference's
``materialize`` from ``PRNGKey(0)``, converted by ``repro_torch.convert``
and distributed by ``state_shardings``), the same tokens and, for
decode, the same caches placed as the reference's (``cache_defs`` +
``fit_spec_to_shape``): each rank computes its 2 of the 4 q heads and of
the 2 kv heads, its half of ``w_in``'s output and of the MLP, its 4 of
the 8 Mamba2 heads, and attends over its 10 of the 20 slots.  Reduced
zamba2-7b (2 groups of 2 Mamba2 layers) with ``in_proj`` and the conv at
``GAIN`` × their initial weights (``tests/test_torch_tp_ssm_ref.py``'s
gain: from 4 on, the port's own unsplit calls part from the reference's
past the serving bar, as there): a prefill of 20 tokens (a chunk and a
part; its caches handed out by the sequence) and two decode steps from
random caches of 20 slots; the logits and the returned caches lie
within the serving bar of the reference's (``SERVE_TOL``), or, for a
cache leaf past it, within ``WITNESS_RATIO`` × the parting of the
port's own plain call (``ModelZoo.prefill`` / ``.decode`` on the same
weights, tokens and caches) from the reference's, as
``tests/test_torch_train_zoo.py`` holds a leaf past its bar: the
prefill's conv tail of the last layer (the raw bf16 projection, whose
inputs carry the bf16 all-reduces of the split blocks before it) lies
just past the bar where the plain call's lies just inside it.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import ROOT, assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
WITNESS_RATIO = 2.0       # tests/test_torch_train_zoo.py's
ARCH = "zamba2-7b"
GAIN = 2.0
B, S = 4, 20

JAX_SERVE = r"""
import sys
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.train import (abstract_serve_args, make_decode_step,
                                make_prefill_step)
from repro.models import ModelZoo
from repro.models.layers import materialize

arch, out, batch, seq, gain = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]), float(sys.argv[5]))
cfg = get_config(arch).reduced()
zoo = ModelZoo(cfg)
params = materialize(zoo.param_defs(), jax.random.PRNGKey(0), jnp.float32)
for stack in ("groups", "tail"):
    for w in ("in_proj", "conv_w"):
        if stack in params:
            params[stack]["mamba"][w] = params[stack]["mamba"][w] * gain
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rng = np.random.default_rng(11)
f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
put = lambda x, a: jax.device_put(x, a.sharding)
save = {}


def flat(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}{k}/")
        else:
            save[prefix + k] = f32(v)


flat(params, "param/")
p_abs, b_abs = abstract_serve_args(cfg, ShapeSpec("p", "prefill", seq, batch),
                                   mesh, ("data",))
tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
logits, caches = jax.jit(make_prefill_step(cfg))(
    jax.tree.map(put, params, p_abs), {"tokens": put(tok, b_abs["tokens"])})
save["prefill/tokens"] = tok
save["prefill/logits"] = f32(logits)
flat(caches, "prefill/cache/")

p_abs, c_abs, b_abs = abstract_serve_args(
    cfg, ShapeSpec("d", "decode", seq, batch), mesh, ("data",))
caches = jax.tree.map(
    lambda a: rng.normal(0, 1, a.shape).astype(ml_dtypes.bfloat16), c_abs)
flat(caches, "decode/cache_in/")
caches = jax.tree.map(put, caches, c_abs)
params = jax.tree.map(put, params, p_abs)
decode = jax.jit(make_decode_step(cfg))
for n in range(2):
    tok = rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
    logits, caches = decode(params, caches,
                            {"tokens": put(tok, b_abs["tokens"])})
    save[f"decode{n}/tokens"] = tok
    save[f"decode{n}/logits"] = f32(logits)
    flat(caches, f"decode{n}/cache/")
np.savez(out, **save)
"""

PORT_SERVE = """
import json
import numpy as np
from torch.distributed.tensor import distribute_tensor
from repro_torch import convert
from repro_torch._tree import (tree_flatten_with_path, tree_map,
                               tree_unflatten)
from repro_torch.configs import get_config
from repro_torch.launch import (make_decode_step, make_mesh_from_devices,
                                make_prefill_step)
from repro_torch.launch.train import _cache_placements, state_shardings
from repro_torch.models import ModelZoo

cfg = get_config(ARCH).reduced()
mesh = make_mesh_from_devices(range(WORLD), (2, 2), ("data", "model"),
                              device_type="cpu")
data = np.load(WORKDIR + "/ref.npz")


def tree(prefix):
    out = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return out


p = convert.model_params(tree("param/"), device="cpu")
p_m = tree_map(lambda t, sh: distribute_tensor(t, *sh), p,
               state_shardings(cfg, mesh)["params"])


def parting(got, plain, want):
    # the excess over the serving bar, and the largest errors of the
    # split and of the port's own plain call
    got, plain, want = got.float(), plain.float(), torch.tensor(want)
    return dict(
        excess=float(((got - want).abs() - (TOL + TOL * want.abs())).max()),
        err=float((got - want).abs().max()),
        own=float((plain - want).abs().max()))


def compare(tag, logits, caches, plain_logits, plain_caches):
    want = {"/".join(path): a for path, a in
            tree_flatten_with_path(tree(tag + "/cache/"))}
    got = tree_flatten_with_path(caches)
    plain = dict(tree_flatten_with_path(plain_caches))
    assert sorted("/".join(path) for path, _ in got) == sorted(want)
    return dict(
        logits=parting(logits.full_tensor(), plain_logits,
                       data[tag + "/logits"]),
        caches={"/".join(path): parting(c.full_tensor(), plain[path],
                                        want["/".join(path)])
                for path, c in got},
        placed=all(tuple(c.placements) == tuple(_cache_placements(
            cfg, mesh, path, c.shape)) for path, c in got))


zoo = ModelZoo(cfg)
out = {}
with torch.no_grad():
    prompt = {"tokens": torch.tensor(data["prefill/tokens"])}
    logits, caches = make_prefill_step(cfg)(p_m, prompt)
    out["prefill"] = compare("prefill", logits, caches,
                             *zoo.prefill(p, prompt))
    plain = tree_map(lambda c: torch.tensor(c).to(torch.bfloat16),
                     tree("decode/cache_in/"))
    flat = tree_flatten_with_path(plain)
    caches = tree_unflatten([path for path, _ in flat], [
        distribute_tensor(c, mesh, _cache_placements(cfg, mesh, path,
                                                     c.shape))
        for path, c in flat])
    assert sorted(caches) == ["mamba", "shared_kv"], sorted(caches)
    for n in range(2):
        tok = {"tokens": torch.tensor(data[f"decode{n}/tokens"])}
        logits, caches = make_decode_step(cfg)(p_m, caches, tok)
        plain_logits, plain = zoo.decode(p, plain, tok)
        out[f"decode{n}"] = compare(f"decode{n}", logits, caches,
                                    plain_logits, plain)
if RANK == 0:
    with open(WORKDIR + "/port.json", "w") as f:
        json.dump(out, f)
"""


def test_hybrid_split_serving_matches_the_partitioned_reference(tmp_path):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SERVE, ARCH, str(tmp_path / "ref.npz"),
         str(B), str(S), str(GAIN)],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = run_ranks(f"ARCH = {ARCH!r}\nTOL = {SERVE_TOL}\n" + PORT_SERVE, 4,
                    tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "port.json").read_text())
    print("parting from the reference (excess over the serving bar, "
          "<= 0 holds; the split's and the plain call's largest errors):",
          r)
    for part in ("prefill", "decode0", "decode1"):
        c = r[part]
        assert c["placed"], (part, c)
        assert c["logits"]["excess"] <= 0.0, (part, c)
        for leaf, g in c["caches"].items():
            assert g["excess"] <= 0.0 or \
                g["err"] <= WITNESS_RATIO * g["own"], (part, leaf, g)
