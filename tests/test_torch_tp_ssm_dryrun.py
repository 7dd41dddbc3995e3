"""The SSM family's split step counted against the reference's
partitioning, on the CPU.

The train step of reduced mamba2-370m (3 layers, 8 heads, state 16,
chunk 16; batch 2 × 64 tokens), traced by the dry run's counters on a
fake 4-rank world as (2 data, 2 model) and as (1 data, 4 model),
against the reference's step jitted on the same meshes of host devices
(a jax subprocess of 8 forced host devices; its layers and chunks
unrolled, since XLA counts a scan body once), as
``tests/test_torch_tp_moe_dryrun.py`` does for the MoE family: XLA
splits every ``dot`` of the step 4 ways, the fused ``in_proj`` evenly
over its 296 columns and the head-independent ``C·Bᵀ`` of the SSD scan
over its contraction (the state size N, then a sum).  The split step
splits every matmul 4 ways too (``in_proj`` by the rank's z, x and dt
columns and its 1/m of B and C) but ``C·Bᵀ``, which it computes whole on
every "model" rank after B and C are gathered: one (Q, Q) product per
chunk and data rank, 2·B·S·Q·N FLOPs per layer and pass (forward,
recompute, two backward), of which XLA does 1/m per device.  Less that,
the port's FLOPs per device equal XLA's partitioned ``dot`` FLOPs at
the ratio found on one device, exactly.  The one-device ratio is pinned
with and without remat: the two counters count the SSD scan's einsums
differently with no split at all (with no remat, per layer, the port
counts 33 contractions of 131,072 FLOPs where XLA counts 32, and XLA 7
dots of 8,192, reductions over the head dim P in the backward, that
torch does as sums it does not count).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_moe_dryrun import JAX_STEPS, PORT_STEPS  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

ARCH = "mamba2-370m"
MESHES = (("nothing", (1, 1)), ("nothing", (2, 2)), ("nothing", (1, 4)),
          ("none", (1, 1)))
LOOP = ('for remat, shape in (("nothing", (1, 1)), ("nothing", (2, 2)),\n'
        '                     ("none", (1, 1))):')
assert JAX_STEPS.count(LOOP) == PORT_STEPS.count(LOOP) == 1
OURS = f"for remat, shape in {MESHES}:"

# port / XLA dot FLOPs of the reduced step on one device (measured on the
# CPU with torch 2.13 and jax 0.9), by remat policy
ONE_DEVICE_RATIO = {"nothing": 1.0048, "none": 1.0020}
RATIO_BAND = 1e-3


def test_split_ssm_step_flops_against_the_partitioned_reference():
    from repro_torch.configs import get_config
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c",
                           JAX_STEPS.replace(LOOP, OURS), ARCH],
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    port_proc = run_fake(f"ARCH = {ARCH!r}\n"
                         + PORT_STEPS.replace(LOOP, OURS))
    assert port_proc.returncode == 0, port_proc.stderr[-4000:]
    port = json.loads(port_proc.stdout.strip().splitlines()[-1])
    print(f"{ARCH}: port {port}, XLA dots {ref}")
    for remat in ("nothing", "none"):
        one = port[f"{remat}/1x1"] / ref[f"{remat}/1x1"]
        assert abs(one - ONE_DEVICE_RATIO[remat]) <= RATIO_BAND, (one, port,
                                                                  ref)
    cfg = get_config(ARCH).reduced()
    b, s = 2, 64
    # C·Bᵀ of one device: every chunk's (Q, Q) product, in the forward,
    # the recompute and the two backward products
    cb = cfg.num_layers * 4 * 2 * b * s * cfg.ssm_chunk * cfg.ssm_state
    one = port["nothing/1x1"] / ref["nothing/1x1"]
    for data, model in ((2, 2), (1, 4)):
        key = f"nothing/{data}x{model}"
        assert ref[key] * 4 == ref["nothing/1x1"], ref
        # whole on every "model" rank: split over "data" only
        whole_cb = cb / data - cb / 4
        assert port[key] == port["nothing/1x1"] / 4 + whole_cb, (key, port)
        assert (port[key] - whole_cb) / ref[key] == one, (key, port, ref)
