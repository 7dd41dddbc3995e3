"""The split decode's counts against the reference's partitioning of
decode, on the CPU: reduced llama3-8b's decode step (batch 2, a cache of
64 slots, which 2 divides), traced by the dry run's counters on a fake
4-rank world as (2 data, 2 model) with the caches split on the sequence
over "model", against the reference's ``make_decode_step`` jitted on
``abstract_serve_args``' placement (the caches as ``cache_defs`` lays
them out: batch over "data", sequence over "model") on a (2 data,
2 model) mesh of host devices (a jax subprocess of 8 forced host
devices, as ``tests/test_torch_tp_dryrun.py`` runs it; layers unrolled,
since XLA counts a scan body once).

The port's per-device FLOPs over XLA's per-device matmul FLOPs (its
partitioned HLO's ``dot`` operations, 2 × the output's elements × the
contracted size) on the mesh lie within 0.02 of the same ratio on one
device: the split decode does each rank's share of every decode matmul
GSPMD splits, and no more (the ratio is 1.0 on both).  By kind of dot:
the partitioned HLO splits its batched dots (attention's two einsums,
over the batch and the caches' sequence) and its unbatched ones (the
projections, the MLP, the head) four ways each, and on the mesh the
port's ``bmm`` FLOPs per device equal XLA's batched dots' and its
``mm`` FLOPs its unbatched dots' (on one device the port's ``wo``
product, whose input is a non-contiguous einsum output, lowers to a
``bmm``, so the kinds are compared on the mesh).  The port's per-device
FLOPs are its one-device FLOPs over 4 exactly.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_launch_analysis import RATIO_BAND  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

ARCH = "llama3-8b"
SEQ, BATCH = 64, 2

# the reference's decode on (1, 1) and (2, 2) meshes of host devices: the
# partitioned HLO's dot FLOPs, in all and by kind (batched or not)
JAX_PARTITIONED = r"""
import dataclasses, json, math, re, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.train import abstract_serve_args, make_decode_step

DEF = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*[a-z]+[0-9]*\[([0-9,]*)\]")
DOT = re.compile(r"=\s*[a-z]+[0-9]*\[([0-9,]*)\]\S*\s+dot\((%[\w.\-]+),")
CONTRACT = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def dims(text):
    return [int(d) for d in text.split(",") if d]


def dot_flops(hlo):
    shapes, per = {}, {}
    for line in hlo.splitlines():
        m = DEF.match(line)
        if m:
            shapes[m.group(1)] = dims(m.group(2))
    for line in hlo.splitlines():
        m = DOT.search(line)
        if m:
            lhs = shapes[m.group(2)]
            k = math.prod(lhs[i] for i in dims(CONTRACT.search(line).group(1)))
            # attention's einsums are the batched dots; the projections,
            # the MLP and the head the unbatched ones
            key = "batched" if "lhs_batch_dims" in line else "unbatched"
            per[key] = per.get(key, 0) + 2 * math.prod(dims(m.group(1))) * k
    return per


cfg = dataclasses.replace(get_config(sys.argv[1]).reduced(),
                          unroll_layers=True)
shape = ShapeSpec("d", "decode", int(sys.argv[2]), int(sys.argv[3]))
out = {}
for name, mesh_shape in (("one", (1, 1)), ("mesh", (2, 2))):
    mesh = Mesh(np.array(jax.devices()[:math.prod(mesh_shape)]).reshape(
        mesh_shape), ("data", "model"))
    args = abstract_serve_args(cfg, shape, mesh, ("data",))
    compiled = jax.jit(make_decode_step(cfg)).lower(*args).compile()
    per = dot_flops(compiled.as_text())
    out[name] = dict(dot_flops=sum(per.values()), per_dot=per)
print(json.dumps(out))
"""

# the port's decode: plain on one fake device, split on a fake (2, 2)
# world, the caches placed as abstract_serve_args places them
PORT_SPLIT = """
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import (abstract_serve_args, make_decode_step,
                                make_mesh_from_devices)
from repro_torch.launch.hloanalysis import StepCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
cfg = get_config(ARCH).reduced()
shape = ShapeSpec("d", "decode", SEQ, BATCH)
out = {}
for name, mesh_shape in (("one", None), ("mesh", (2, 2))):
    mesh = None if mesh_shape is None else make_mesh_from_devices(
        range(4), mesh_shape, ("data", "model"), device_type="cpu")
    with FakeTensorMode():
        args = abstract_serve_args(cfg, shape, mesh, ("data",),
                                   device="cpu")
        with StepCounter() as counter:
            logits, caches = make_decode_step(cfg)(*args)
        local = (caches["kv"].to_local().shape if mesh is not None
                 else caches["kv"].shape)
    per_op = counter._flops.get_flop_counts()["Global"]
    out[name] = dict(flops=counter.cost_analysis()["flops"],
                     per_op={str(k): v for k, v in per_op.items()},
                     unmatched=counter.unmatched,
                     collectives={k: v["count"] for k, v in
                                  counter.collective_stats().items()},
                     cache_local_shape=list(local))
print(json.dumps(out))
"""


def test_split_decode_flops_against_the_partitioned_reference():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_PARTITIONED, ARCH,
                           str(SEQ), str(BATCH)],
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    port_proc = run_fake(f"ARCH = {ARCH!r}\nSEQ = {SEQ}\nBATCH = {BATCH}\n"
                         + PORT_SPLIT)
    assert port_proc.returncode == 0, port_proc.stderr[-4000:]
    port = json.loads(port_proc.stdout.strip().splitlines()[-1])
    mesh = port["mesh"]
    assert mesh["unmatched"] == []
    # each rank holds its batch's and its sequence's slice of the caches
    layers, kv, hd = 3, 2, 16
    assert mesh["cache_local_shape"] == [layers, 2, BATCH // 2, SEQ // 2,
                                         kv, hd], mesh
    assert mesh["collectives"]["all-to-all"] == 0, mesh
    assert mesh["flops"] * 4 == port["one"]["flops"], port
    dots = {k: port[k]["flops"] / ref[k]["dot_flops"] for k in port}
    assert abs(dots["mesh"] - dots["one"]) <= RATIO_BAND, (dots, ref)
    # GSPMD splits both kinds of dot four ways, the attention's einsums
    # over the batch and the caches' sequence
    assert sorted(ref["one"]["per_dot"]) == ["batched", "unbatched"], ref
    for kind, flops in ref["one"]["per_dot"].items():
        assert ref["mesh"]["per_dot"].get(kind, 0) * 4 == flops, (kind, ref)
    assert mesh["per_op"] == {"aten.bmm": ref["mesh"]["per_dot"]["batched"],
                              "aten.mm": ref["mesh"]["per_dot"]["unbatched"]
                              }, (mesh, ref)


@pytest.mark.parametrize("seq,split", [(32768, True), (32767, False)])
def test_dry_run_reports_the_serving_steps_cache_placement(seq, split):
    """The dry run's ``kv_cache`` entry is the serving steps' own
    placement (``launch.train._cache_placements``) on the (16, 16) pod:
    llama3-8b's decode caches split on the sequence where 16 divides
    it, else replicated over "model", and one rank's GB of it at S and
    after one ``widen_mesh_caches``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import _tensor_parallel_report
    r = _tensor_parallel_report(get_config(ARCH),
                                ShapeSpec("d", "decode", seq, 128))
    assert r["model"] == 16 and r["layout"] is not None, r
    assert r["kv_cache"].startswith(
        "split on the sequence" if split else "replicated"), r
    # one rank's cache: its batch slice (128 / 16) of every slot, over 16
    # where "model" splits the sequence
    cfg = get_config(ARCH)
    whole = lambda n: (cfg.num_layers * 2 * 8 * n * cfg.num_kv_heads
                       * cfg.head_dim * 2 / 1e9)
    gb = r["kv_cache_gb_per_device"]
    assert gb["S"] == pytest.approx(whole(seq) / (16 if split else 1),
                                    rel=1e-12), gb
    # 32769 replicated, 32768 split
    assert gb["S+1 (after widen_mesh_caches)"] == pytest.approx(
        whole(seq + 1) / (1 if split else 16), rel=1e-12), gb
