"""The dry run of the FSDP steps (``tests/test_torch_fsdp_dryrun.py``)
for the other families, on a fake (4 data, 2 model) world with FSDP
forced: reduced qwen2-moe-a2.7b (the experts' "fsdp" dimension is dim 1
of a layer's slice), zamba2-7b (2 groups of 2 and a tail of 1:
``in_proj`` both sliced and FSDP) and seamless-m4t-large-v2 (encoder and
decoder).  Train issues one reduce-scatter per held leaf and layer, the
serving steps none; FLOPs per device equal those of the same step with
FSDP off; nothing unmatched.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp_dryrun import COMMON  # noqa: E402
from torch_gloo import run_fake  # noqa: E402

FAMILIES = COMMON + """
cfg = get_config(ARCH).reduced()
if ARCH == "qwen2-moe-a2.7b":
    cfg = dataclasses.replace(cfg, num_experts=14)
if ARCH == "zamba2-7b":
    cfg = dataclasses.replace(cfg, num_layers=5)
out = {"held": held(cfg)}
for kind in ("train", "prefill", "decode"):
    r = trace(cfg, kind)
    train_mod.FSDP_PARAM_THRESHOLD = 2_000_000_000
    off = trace(cfg, kind)
    train_mod.FSDP_PARAM_THRESHOLD = 0
    out[kind] = dict(counts=counts(r), unmatched=r["unmatched_collectives"],
                     flops=r["flops"], off_flops=off["flops"])
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "seamless-m4t-large-v2",
                                  "zamba2-7b"])
def test_fsdp_families_reduce_scatter_each_layer_at_unchanged_flops(arch):
    proc = run_fake(f"ARCH = {arch!r}\n" + FAMILIES)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    _, slices, _ = out["held"]
    assert slices > 0, out["held"]
    for kind in ("train", "prefill", "decode"):
        r = out[kind]
        assert r["unmatched"] == [], (kind, r)
        assert r["flops"] == r["off_flops"] > 0, (kind, r)
        assert r["counts"]["reduce-scatter"] == (
            slices if kind == "train" else 0), (kind, r)
