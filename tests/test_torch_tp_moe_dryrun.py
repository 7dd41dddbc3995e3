"""The MoE family's split step counted against the reference's
partitioning, and its layout at the published widths, on the CPU.

  * the train step of reduced qwen2-moe-a2.7b (shared MLP) and reduced
    arctic-480b (dense residual), batch 2 × 64 tokens (a whole group of
    32 on each data rank), traced by the dry run's counters on a fake
    4-rank world as (2 data, 2 model), against the reference's step
    jitted on a (2 data, 2 model) mesh of host devices (a jax subprocess
    of 8 forced host devices; its layers unrolled, since XLA counts a
    scan body once), as ``tests/test_torch_tp_dryrun.py`` does for the
    dense family: the port's FLOPs per device equal XLA's partitioned
    ``dot`` FLOPs (2 × the output's elements × the contracted size of
    every ``dot`` of the partitioned HLO) at the ratio found on one
    device, once the router's matmuls are set aside (the port keeps
    them whole on every "model" rank, XLA splits their contraction);
    the one-device ratio is pinned (1.0204 / 1.0268: torch's checkpoint
    recomputes more of the MoE einsums than XLA's rematerialization;
    with no remat the counts are equal);
  * ``tp_layout``, ``leaf_roles`` and ``gathered_leaves`` of both
    configs at their published widths on the production mesh's 16
    "model" ranks: experts, shared and dense MLPs split; arctic's
    attention (56 q heads) gathered, qwen2-moe's (16 / 16) split.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_dryrun import JAX_PARTITIONED  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

# the reference's step, by (remat policy, mesh shape): cost_analysis's
# FLOPs and the partitioned HLO's dot FLOPs (the dense test's helpers)
JAX_STEPS = JAX_PARTITIONED[:JAX_PARTITIONED.index("cfg = ")] + r"""
out = {}
for remat, shape in (("nothing", (1, 1)), ("nothing", (2, 2)),
                     ("none", (1, 1))):
    cfg = dataclasses.replace(get_config(sys.argv[1]).reduced(),
                              unroll_layers=True, remat_policy=remat)
    mesh = Mesh(np.array(jax.devices()[:math.prod(shape)]).reshape(shape),
                ("data", "model"))
    args = abstract_train_args(cfg, ShapeSpec("t", "train", 64, 2), mesh,
                               ("data",))
    compiled = jax.jit(make_train_step(cfg)).lower(*args).compile()
    out[f"{remat}/{shape[0]}x{shape[1]}"] = dot_flops(compiled.as_text())
print(json.dumps(out))
"""

PORT_STEPS = """
import dataclasses, json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import (abstract_train_args, make_mesh_from_devices,
                                make_train_step)
from repro_torch.launch.hloanalysis import StepCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
out = {}
for remat, shape in (("nothing", (1, 1)), ("nothing", (2, 2)),
                     ("none", (1, 1))):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat_policy=remat)
    mesh = None if shape == (1, 1) else make_mesh_from_devices(
        range(4), shape, ("data", "model"), device_type="cpu")
    with FakeTensorMode():
        args = abstract_train_args(cfg, ShapeSpec("t", "train", 64, 2), mesh,
                                   ("data",), device="cpu")
        with StepCounter() as counter:
            make_train_step(cfg)(*args)
    assert counter.unmatched == [], counter.unmatched
    out[f"{remat}/{shape[0]}x{shape[1]}"] = counter.cost_analysis()["flops"]
print(json.dumps(out))
"""

# port / XLA dot FLOPs of the reduced step on one device under remat
# "nothing" (measured on the CPU with torch 2.13 and jax 0.9): torch's
# checkpoint recomputes more of the MoE block's einsums in the backward
# than XLA's rematerialization (with no remat the two counts are equal)
ONE_DEVICE_RATIO = {"arctic-480b": 1.0204, "qwen2-moe-a2.7b": 1.0268}
RATIO_BAND = 1e-3


@pytest.mark.parametrize("arch", sorted(ONE_DEVICE_RATIO))
def test_split_moe_step_flops_against_the_partitioned_reference(arch):
    """XLA splits every dot of the step 4 ways on the (2, 2) mesh, the
    router's ``x @ router`` too (its contraction over "model", then a
    sum of the logits).  The split step splits every matmul 4 ways but
    the router's, which it keeps whole on every "model" rank (every rank
    routes alike), so its four matmuls per layer (forward, recompute,
    two backward) split over "data" only.  Less that, the port's FLOPs
    per device are XLA's partitioned dot FLOPs at the one-device ratio,
    exactly."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import padded_experts
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_STEPS, arch],
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    port_proc = run_fake(f"ARCH = {arch!r}\n" + PORT_STEPS)
    assert port_proc.returncode == 0, port_proc.stderr[-4000:]
    port = json.loads(port_proc.stdout.strip().splitlines()[-1])
    print(f"{arch}: port {port}, XLA dots {ref}")
    assert port["none/1x1"] == ref["none/1x1"], (port, ref)
    one = port["nothing/1x1"] / ref["nothing/1x1"]
    assert abs(one - ONE_DEVICE_RATIO[arch]) <= RATIO_BAND, (one, port, ref)
    assert ref["nothing/2x2"] * 4 == ref["nothing/1x1"], ref
    cfg = get_config(arch).reduced()
    router = (cfg.num_layers * 4 * 2 * 2 * 64 * cfg.d_model
              * padded_experts(cfg.num_experts))
    mesh = port["nothing/2x2"]
    assert mesh == port["nothing/1x1"] / 4 + router / 4, (mesh, router)
    assert (mesh - router / 4) / ref["nothing/2x2"] == one, (port, ref)


def test_moe_layout_on_sixteen_ranks():
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo
    from repro_torch.models.parallel import (gathered_leaves, leaf_roles,
                                             tp_layout)
    arctic, qwen = get_config("arctic-480b"), get_config("qwen2-moe-a2.7b")
    assert tp_layout(arctic, 16) == dict(
        attn="gathered", mlp=False, embed=True, head="vocab", experts=True,
        shared=False, dense=True)
    assert tp_layout(qwen, 16) == dict(
        attn="split", mlp=False, embed=True, head="vocab", experts=True,
        shared=True, dense=False)
    for cfg, mlp in ((arctic, "dense"), (qwen, "shared")):
        defs = ModelZoo(cfg).param_defs()
        roles = leaf_roles(cfg, defs, 16, 3)["layers"]["moe"]
        assert roles["router"] == ("gathered",)
        for w in ("w1", "w3", "w2"):
            assert roles[w] == ("split", -3), (w, roles)
            # the stacked (L, E, ., .) leaf: experts on dim -3, by 16
            assert defs["layers"]["moe"][w].shape[-3] % 16 == 0
        assert roles[f"{mlp}_w1"] == roles[f"{mlp}_w3"] == ("split", -1)
        assert roles[f"{mlp}_w2"] == ("split", -2)
        named = gathered_leaves(cfg, defs, 16)
        if cfg is arctic:
            assert {g["leaf"] for g in named} == {
                "layers/attn/" + w for w in ("wq", "wk", "wv", "wo")}, named
            assert all(g["reason"] == "56 q heads on 16 ranks"
                       for g in named), named
        else:
            assert named == [], named
    # widths "model" does not divide stay whole, and are named
    import dataclasses
    odd = dataclasses.replace(qwen, d_ff=1402, num_experts=60)
    assert tp_layout(odd, 16)["shared"] is False
    assert tp_layout(odd, 48)["experts"] is False   # 64 padded experts
    named = {g["leaf"]: g["reason"] for g in
             gathered_leaves(odd, ModelZoo(odd).param_defs(), 48)}
    assert named["layers/moe/w1"] == "64 padded experts on 48 ranks"
    assert named["layers/moe/shared_w2"] == "shared MLP width 5608 on 48 ranks"
