"""The split step's counts against the reference's partitioning, on the
CPU: reduced llama3-8b's train step (2 × 64 tokens), traced by the dry
run's counters on a fake 4-rank world as (2 data, 2 model), against the
reference's step jitted on a (2 data, 2 model) mesh of host devices (a
jax subprocess of 8 forced host devices, as ``tests/test_multidevice.py``
runs it; its layers unrolled, since XLA counts a scan body once).

``FlopCounterMode`` counts matmul-class operations; XLA's
``cost_analysis`` counts those and the elementwise work.  So two ratios
of the port's per-device FLOPs to XLA's:

  * to XLA's per-device matmul FLOPs (its partitioned HLO's ``dot``
    operations, 2 × the output's elements × the contracted size): on the
    mesh within 0.02 of the same ratio on one device — the split step
    does each rank's share of every matmul GSPMD splits, and no more;
  * to XLA's whole count: on one device within 0.02 of the dense
    family's pinned ratio (``tests/test_torch_launch_analysis.py``'s
    smollm-135m).  On the mesh this ratio is lower (0.806 against 0.851
    when measured): GSPMD leaves part of the elementwise work replicated
    over "model" (AdamW on the leaves "data" replicates, the norms and
    residuals on replicated activations), which XLA counts per device
    and ``FlopCounterMode`` does not count at all.

The port's per-device FLOPs on the mesh are its one-device FLOPs over 4
exactly: the batch splits over "data" and every matmul over "model".
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_launch_analysis import FLOP_RATIOS, RATIO_BAND  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

ARCH = "llama3-8b"

# the reference's step on (1, 1) and (2, 2) meshes of host devices:
# cost_analysis's FLOPs and the partitioned HLO's dot FLOPs
JAX_PARTITIONED = r"""
import dataclasses, json, math, re, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.hloanalysis import cost_analysis_dict
from repro.launch.train import abstract_train_args, make_train_step

DEF = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*[a-z]+[0-9]*\[([0-9,]*)\]")
DOT = re.compile(r"=\s*[a-z]+[0-9]*\[([0-9,]*)\]\S*\s+dot\((%[\w.\-]+),")
CONTRACT = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def dims(text):
    return [int(d) for d in text.split(",") if d]


def dot_flops(hlo):
    shapes = {}
    for line in hlo.splitlines():
        m = DEF.match(line)
        if m:
            shapes[m.group(1)] = dims(m.group(2))
    total = 0
    for line in hlo.splitlines():
        m = DOT.search(line)
        if m:
            lhs = shapes[m.group(2)]
            k = math.prod(lhs[i] for i in dims(CONTRACT.search(line).group(1)))
            total += 2 * math.prod(dims(m.group(1))) * k
    return total


cfg = dataclasses.replace(get_config(sys.argv[1]).reduced(),
                          unroll_layers=True)
out = {}
for name, shape in (("one", (1, 1)), ("mesh", (2, 2))):
    mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                ("data", "model"))
    args = abstract_train_args(cfg, ShapeSpec("t", "train", 64, 2), mesh,
                               ("data",))
    compiled = jax.jit(make_train_step(cfg)).lower(*args).compile()
    out[name] = dict(flops=cost_analysis_dict(compiled)["flops"],
                     dot_flops=dot_flops(compiled.as_text()))
print(json.dumps(out))
"""

# the port's step: plain on one fake device, split on a fake (2, 2) world
PORT_SPLIT = """
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import (abstract_train_args, make_mesh_from_devices,
                                make_train_step)
from repro_torch.launch.hloanalysis import StepCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
cfg = get_config(ARCH).reduced()
out = {}
for name, shape in (("one", None), ("mesh", (2, 2))):
    mesh = None if shape is None else make_mesh_from_devices(
        range(4), shape, ("data", "model"), device_type="cpu")
    with FakeTensorMode():
        args = abstract_train_args(cfg, ShapeSpec("t", "train", 64, 2), mesh,
                                   ("data",), device="cpu")
        with StepCounter() as counter:
            make_train_step(cfg)(*args)
    out[name] = dict(flops=counter.cost_analysis()["flops"],
                     unmatched=counter.unmatched)
print(json.dumps(out))
"""


def test_split_step_flops_against_the_partitioned_reference():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_PARTITIONED, ARCH],
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    port_proc = run_fake(f"ARCH = {ARCH!r}\n" + PORT_SPLIT)
    assert port_proc.returncode == 0, port_proc.stderr[-4000:]
    port = json.loads(port_proc.stdout.strip().splitlines()[-1])
    assert port["mesh"]["unmatched"] == []
    assert port["mesh"]["flops"] * 4 == port["one"]["flops"], port
    dots = {k: port[k]["flops"] / ref[k]["dot_flops"] for k in port}
    assert abs(dots["mesh"] - dots["one"]) <= RATIO_BAND, (dots, ref)
    whole = {k: port[k]["flops"] / ref[k]["flops"] for k in port}
    assert abs(whole["one"] - FLOP_RATIOS["smollm-135m"]) <= RATIO_BAND, whole
    # GSPMD's elementwise work replicated over "model" lowers the mesh's
    # whole-count ratio; the matmuls' is what splits
    assert whole["mesh"] < whole["one"], whole
