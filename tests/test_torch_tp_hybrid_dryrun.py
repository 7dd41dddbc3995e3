"""The hybrid family's split step counted against the reference's
partitioning, on the CPU.

The train step of reduced zamba2-7b (2 groups of a shared block and 2
Mamba2 layers; the shared block's 4 q / 2 kv heads, d_ff 128; 8 Mamba2
heads, state 16, chunk 16; batch 2 × 64 tokens), traced by the dry
run's counters on a fake 4-rank world as (2 data, 2 model) and as (1
data, 4 model), against the reference's step jitted on the same meshes
of host devices (a jax subprocess of 8 forced host devices, its layers
and chunks unrolled), as ``tests/test_torch_tp_ssm_dryrun.py`` does for
the SSM family.  With no remat XLA splits every ``dot`` of the step 4
ways on both meshes: the shared block's ``w_in`` on its output d, its
attention (the kv projections on 4 ranks across the 2 kv heads'
columns), its MLP, the Mamba2 blocks as in the SSM family.  The split
step splits every matmul 4 ways but two, pinned with their counts:

  * the head-independent ``C·Bᵀ`` of the SSD scan, whole on every
    "model" rank (as in the SSM family): 2·B·S·Q·N FLOPs per layer and
    pass, of which XLA does 1/m per device;
  * on 4 ranks the shared block's kv projections: its attention is
    "kv_slice" there (2 kv heads on 4 ranks), and each rank computes the
    one kv head its q head reads, so each kv head twice: 1/2 of the
    projections per device where XLA does 1/4.

Less those, the port's FLOPs per device equal XLA's partitioned ``dot``
FLOPs at the ratio found on one device (pinned: the two counters count
the SSD scan's einsums differently with no split at all), exactly.
The comparison runs with no remat because XLA's rematerialization
differs between its one-device and its partitioned programs: under
remat "nothing" its partitioned count per device is more than a
quarter of its one-device count (on both meshes), where with no remat
it is a quarter exactly.  Under remat "nothing" (each group one
checkpoint) the split step's own count on (2, 2) is a quarter of its
one-device count plus ``C·Bᵀ`` of four passes (the forward, the
group's recompute and the two backward products), exactly: the
recompute splits as the forward does.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_moe_dryrun import JAX_STEPS, PORT_STEPS  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

ARCH = "zamba2-7b"
REF_MESHES = (("none", (1, 1)), ("none", (2, 2)), ("none", (1, 4)))
PORT_MESHES = REF_MESHES + (("nothing", (1, 1)), ("nothing", (2, 2)))
LOOP = ('for remat, shape in (("nothing", (1, 1)), ("nothing", (2, 2)),\n'
        '                     ("none", (1, 1))):')
assert JAX_STEPS.count(LOOP) == PORT_STEPS.count(LOOP) == 1

# port / XLA dot FLOPs of the reduced step on one device with no remat
# (measured on the CPU with torch 2.13 and jax 0.9)
ONE_DEVICE_RATIO = 1.0014
RATIO_BAND = 1e-3


def test_split_hybrid_step_flops_against_the_partitioned_reference():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import hybrid_layout
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    # the reference compiles while the port traces
    jax_proc = subprocess.Popen(
        [sys.executable, "-c",
         JAX_STEPS.replace(LOOP, f"for remat, shape in {REF_MESHES}:"),
         ARCH], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        port_proc = run_fake(f"ARCH = {ARCH!r}\n" + PORT_STEPS.replace(
            LOOP, f"for remat, shape in {PORT_MESHES}:"))
        stdout, stderr = jax_proc.communicate(timeout=600)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, stderr[-4000:]
    assert port_proc.returncode == 0, port_proc.stderr[-4000:]
    ref = json.loads(stdout.strip().splitlines()[-1])
    port = json.loads(port_proc.stdout.strip().splitlines()[-1])
    print(f"{ARCH}: port {port}, XLA dots {ref}")
    one = port["none/1x1"] / ref["none/1x1"]
    assert abs(one - ONE_DEVICE_RATIO) <= RATIO_BAND, (one, port, ref)
    cfg = get_config(ARCH).reduced()
    b, s = 2, 64
    groups = hybrid_layout(cfg)[0]
    # per pass: C·Bᵀ of one device, every chunk's (Q, Q) product; the
    # shared block's k and v projections of one device
    cb = cfg.num_layers * 2 * b * s * cfg.ssm_chunk * cfg.ssm_state
    kv = groups * 2 * 2 * b * s * cfg.d_model * cfg.num_kv_heads \
        * cfg.head_dim
    for data, model in ((2, 2), (1, 4)):
        key = f"none/{data}x{model}"
        assert ref[key] * 4 == ref["none/1x1"], ref
        # three passes with no remat: the forward and two backward
        whole_cb = 3 * (cb / data - cb / 4)
        twice_kv = 3 * (kv / 2 - kv / 4) if model == 4 else 0
        assert port[key] == port["none/1x1"] / 4 + whole_cb + twice_kv, (
            key, port)
        assert (port[key] - whole_cb - twice_kv) / ref[key] == one, (
            key, port, ref)
    # each group one checkpoint: its recompute splits as the forward does
    assert port["nothing/2x2"] == port["nothing/1x1"] / 4 + 4 * (
        cb / 2 - cb / 4), port
