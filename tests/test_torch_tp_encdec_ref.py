"""The encoder-decoder family's split prefill and decode against the
reference's partitioned ones, value for value, on the CPU.

The reference's ``make_prefill_step`` and ``make_decode_step`` are
jitted on a (2 data, 2 model) mesh of host devices (a jax subprocess of
4 forced host devices), their parameters, caches and inputs placed by
``abstract_serve_args``, so GSPMD partitions them: the encoder's and the
decoder's attention (the cross-attention too) and MLPs on their heads
and columns, the embedding on d, the head on the vocabulary, the
``kv`` and ``cross_kv`` caches on their sequence.  The port's
``make_prefill_step`` and ``make_decode_step`` run on a (2, 2) gloo
world (``tests/torch_gloo.py``) with the same weights (the reference's
``materialize`` from ``PRNGKey(0)``, converted by ``repro_torch.convert``
and distributed by ``state_shardings``), the same inputs and, for
decode, the same caches placed as the reference's (``cache_defs`` +
``fit_spec_to_shape``): each rank computes its 2 of the 4 q heads and
its one of the 2 kv heads in each attention block, its half of the
MLPs, and attends over its 10 of the self cache's 20 slots and its 12
of the source's 24.  Reduced seamless-m4t-large-v2 (2 encoder and 2
decoder layers): a prefill of 20 tokens over 24 source frames (the
source placed as ``abstract_serve_args`` places it, at its own length),
then two decode steps from random caches of 20 and 24 slots; the logits
and the returned caches lie within the serving bar of the reference's
(``SERVE_TOL``).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import ROOT, assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL
ARCH = "seamless-m4t-large-v2"
B, S, SRC = 4, 20, 24

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

arch, out, batch, seq, src = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]), int(sys.argv[5]))
cfg = get_config(arch).reduced()
zoo = ModelZoo(cfg)
params = materialize(zoo.param_defs(), jax.random.PRNGKey(0), jnp.float32)
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
frames = rng.normal(0, 1, (batch, src, cfg.d_model)).astype(
    ml_dtypes.bfloat16)
# the source at its own length, placed as the inputs' spec places it
logits, caches = jax.jit(make_prefill_step(cfg))(
    jax.tree.map(put, params, p_abs),
    {"tokens": put(tok, b_abs["tokens"]),
     "src_embeds": put(frames, b_abs["src_embeds"])})
save["prefill/tokens"] = tok
save["prefill/src_embeds"] = f32(frames)
save["prefill/logits"] = f32(logits)
flat(caches, "prefill/cache/")

p_abs, c_abs, b_abs = abstract_serve_args(
    cfg, ShapeSpec("d", "decode", seq, batch), mesh, ("data",))
# cross_kv at the source's length, placed as abstract_serve_args places it
c_abs["cross_kv"] = abstract_serve_args(
    cfg, ShapeSpec("d", "decode", src, batch), mesh, ("data",))[1]["cross_kv"]
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
from repro_torch.launch.train import (_cache_placements, _cache_shards,
                                      _tensor_parallel, state_shardings)

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


def excess(got, want):
    got, want = got.float(), torch.tensor(want)
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


def compare(tag, logits, caches):
    want = {"/".join(path): a for path, a in
            tree_flatten_with_path(tree(tag + "/cache/"))}
    got = tree_flatten_with_path(caches)
    assert sorted("/".join(path) for path, _ in got) == sorted(want)
    return dict(
        logits=excess(logits.full_tensor(), data[tag + "/logits"]),
        caches={"/".join(path): excess(c.full_tensor(), want["/".join(path)])
                for path, c in got},
        placed=all(tuple(c.placements) == tuple(_cache_placements(
            cfg, mesh, path, c.shape)) for path, c in got),
        seq={"/".join(path): list(c.to_local().shape)[3] for path, c in got})


out = {}
with torch.no_grad():
    prompt = {"tokens": torch.tensor(data["prefill/tokens"]),
              "src_embeds": torch.tensor(data["prefill/src_embeds"]).to(
                  torch.bfloat16)}
    logits, caches = make_prefill_step(cfg)(p_m, prompt)
    out["prefill"] = compare("prefill", logits, caches)
    plain = tree_map(lambda c: torch.tensor(c).to(torch.bfloat16),
                     tree("decode/cache_in/"))
    flat = tree_flatten_with_path(plain)
    caches = tree_unflatten([path for path, _ in flat], [
        distribute_tensor(c, mesh, _cache_placements(cfg, mesh, path,
                                                     c.shape))
        for path, c in flat])
    assert sorted(caches) == ["cross_kv", "kv"], sorted(caches)
    tp = _cache_shards(cfg, mesh, caches,
                       _tensor_parallel(cfg, mesh, p_m)[0])[1]
    out["decode_tp"] = [tp.attn, tp.kv_seq, tp.cross_seq]
    for n in range(2):
        tok = {"tokens": torch.tensor(data[f"decode{n}/tokens"])}
        logits, caches = make_decode_step(cfg)(p_m, caches, tok)
        out[f"decode{n}"] = compare(f"decode{n}", logits, caches)
if RANK == 0:
    with open(WORKDIR + "/port.json", "w") as f:
        json.dump(out, f)
"""


def test_encdec_split_serving_matches_the_partitioned_reference(tmp_path):
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SERVE, ARCH, str(tmp_path / "ref.npz"),
         str(B), str(S), str(SRC)],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = run_ranks(f"ARCH = {ARCH!r}\nTOL = {SERVE_TOL}\n" + PORT_SERVE, 4,
                    tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "port.json").read_text())
    print("excess over the serving bar against the reference (<= 0 holds):",
          r)
    # each rank attends over its 10 of 20 self slots and 12 of 24 source
    assert r["decode_tp"] == ["split", S, SRC], r["decode_tp"]
    for part in ("prefill", "decode0", "decode1"):
        c = r[part]
        assert c["placed"], (part, c)
        assert c["seq"] == {"kv": S // 2, "cross_kv": SRC // 2}, (part, c)
        assert c["logits"] <= 0.0, (part, c)
        for leaf, e in c["caches"].items():
            assert e <= 0.0, (part, leaf, c)
