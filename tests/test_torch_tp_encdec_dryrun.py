"""The encoder-decoder family's split step counted against the
reference's partitioning, on the CPU.

The train step of reduced seamless-m4t-large-v2 (2 encoder and 2 decoder
layers; 4 q / 2 kv heads of 16, d_ff 128; batch 2 × 64 tokens over 64
source frames), traced by the dry run's counters on a fake 4-rank world
as (2 data, 2 model) and as (1 data, 4 model), against the reference's
step jitted on the same meshes of host devices (a jax subprocess of 8
forced host devices, its layers unrolled), as
``tests/test_torch_tp_hybrid_dryrun.py`` does for the hybrid family.
With no remat XLA splits every ``dot`` of the step 4 ways on both
meshes: the encoder's and the decoder's self-attention, the
cross-attention (its q from the decoder's stream, its k and v from the
encoder's output), the MLPs, the embedding's gradient and the head.
The split step splits every matmul 4 ways but one, pinned with its
count: on 4 ranks the kv projections of the three attention blocks
(the encoder's and the decoder's self-attention, the
cross-attention's from the encoder's output).  Attention is
"kv_slice" there (2 kv heads on 4 ranks), and each rank computes the
one kv head its q head reads, so each kv head twice: 1/2 of the
projections per device where XLA does 1/4.  Less that, the port's FLOPs
per device equal XLA's partitioned ``dot`` FLOPs exactly, as its
one-device count equals XLA's.  Under remat "nothing" (each encoder and
decoder layer one checkpoint) the split step's own count on (2, 2) is a
quarter of its one-device count, exactly: the recompute splits as the
forward does.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_moe_dryrun import JAX_STEPS, PORT_STEPS  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

ARCH = "seamless-m4t-large-v2"
REF_MESHES = (("none", (1, 1)), ("none", (2, 2)), ("none", (1, 4)))
PORT_MESHES = REF_MESHES + (("nothing", (1, 1)), ("nothing", (2, 2)))
LOOP = ('for remat, shape in (("nothing", (1, 1)), ("nothing", (2, 2)),\n'
        '                     ("none", (1, 1))):')
assert JAX_STEPS.count(LOOP) == PORT_STEPS.count(LOOP) == 1


def test_split_encdec_step_flops_against_the_partitioned_reference():
    from repro_torch.configs import get_config
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
    # with no remat the two counts are equal on one device
    assert port["none/1x1"] == ref["none/1x1"], (port, ref)
    cfg = get_config(ARCH).reduced()
    b, s = 2, 64
    # per pass: the k and v projections of one device, in the encoder's
    # and the decoder's self-attention and the cross-attention (its k
    # and v from the encoder's output of s frames)
    blocks = cfg.encoder_layers + 2 * cfg.decoder_layers
    kv = blocks * 2 * 2 * b * s * cfg.d_model * cfg.num_kv_heads \
        * cfg.head_dim
    for data, model in ((2, 2), (1, 4)):
        key = f"none/{data}x{model}"
        assert ref[key] * 4 == ref["none/1x1"], ref
        # three passes with no remat: the forward and two backward
        twice_kv = 3 * (kv / 2 - kv / 4) if model == 4 else 0
        assert port[key] == port["none/1x1"] / 4 + twice_kv, (key, port)
        assert port[key] - twice_kv == ref[key], (key, port, ref)
    # each layer one checkpoint: its recompute splits as the forward does
    assert port["nothing/2x2"] == port["nothing/1x1"] / 4, port
