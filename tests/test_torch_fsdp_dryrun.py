"""The dry run (``launch.dryrun``) of steps whose FSDP leaves stay sharded
(``launch.train._layer_gather``, ``models.fsdp``), on fake worlds, with
FSDP forced on reduced configs (``FSDP_PARAM_THRESHOLD = 0``, as a test
sets it):

  * the schedule, exactly, on a fake (4 data, 2 model) world for reduced
    llama3-8b (3 layers; H = 7 stacked leaves held as shards: the
    attention's four and the MLP's three): train — all-gathers 2 (the
    embedding along d, the head's compute view over "data") + 2·3·H
    (each layer's slice in the forward and again in its checkpoint's
    recompute), reduce-scatters 3·H (each layer's gradient), all-reduces
    over "data" for the other leaves and the loss, the norm's one over
    "data", and the split's over "model" as before (five per layer, six
    per loss chunk, the norm's); prefill and decode — the split step's
    collectives, the head's view, and 3·H all-gathers; under the
    ``zero3`` profile (the leaves over ("data", "model") on their "fsdp"
    dimension, the batch over both) two all-gathers per leaf and layer
    slice and two reduce-scatters per layer gradient; nothing unmatched;
  * FLOPs per device equal to those of the same step with every leaf
    gathered whole before the first layer, as the parent gathered them,
    and (``tp``) with FSDP off (the other families:
    ``tests/test_torch_fsdp_dryrun_families.py``);
  * memory: reduced llama3-8b at 2 and 6 layers — the traced
    temporaries of train, prefill and decode grow by less than one
    layer's gathered views per layer (at most two layers' views live at
    once), where the whole-view step's grow by at least one layer's
    views per layer (two in train: the views and their gradients);
  * the L1/L2 composition (``_compose``) equals a direct full-depth
    trace for FSDP configs (dense, encoder-decoder) on a fake
    (2 pod, 2 data, 2 model) world.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import COMPOSITION  # noqa: E402
from torch_gloo import run_fake  # noqa: E402

FORCE = """
import repro_torch.launch.train as train_mod
train_mod.FSDP_PARAM_THRESHOLD = 0
"""

COMMON = FORCE + """
import dataclasses, json
from repro_torch._tree import tree_flatten_with_path
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, make_mesh_from_devices
from repro_torch.models import ModelZoo
from repro_torch.models.fsdp import held_view_bytes

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh_from_devices(range(8), (4, 2), ("data", "model"),
                              device_type="cpu")
layer_gather = train_mod._layer_gather


def trace(cfg, kind, whole=False):
    # whole: every leaf gathered before the first layer (no leaf held)
    if whole:
        train_mod._layer_gather = lambda c, m, p, r, a: None
    try:
        return dryrun._trace(cfg, ShapeSpec(kind, kind, 64, 8), mesh)
    finally:
        train_mod._layer_gather = layer_gather


def held(cfg):
    # (leaves, layer slices of each, bytes of one layer's compute views)
    b = held_view_bytes(cfg, 2)
    return b["leaves"], b["slices"], b["unit_bytes"]


def counts(r):
    return {k: r["collectives"][k]["count"]
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all")}
"""

SCHEDULE = COMMON + """
out = {}
for profile in ("tp", "zero3"):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              sharding_profile=profile)
    for kind in ("train", "prefill", "decode"):
        r = trace(cfg, kind)
        out[f"{profile}/{kind}"] = dict(
            counts=counts(r), unmatched=r["unmatched_collectives"],
            flops=r["flops"], whole_flops=trace(cfg, kind, True)["flops"])
        if profile == "tp":
            train_mod.FSDP_PARAM_THRESHOLD = 2_000_000_000
            out[f"{profile}/{kind}"]["off_flops"] = trace(cfg, kind)["flops"]
            train_mod.FSDP_PARAM_THRESHOLD = 0
out["held"] = held(get_config("llama3-8b").reduced())
out["leaves"] = len(tree_flatten_with_path(
    ModelZoo(get_config("llama3-8b").reduced()).param_defs()))
print(json.dumps(out))
"""


def test_fsdp_schedule_is_one_gather_per_leaf_and_layer():
    proc = run_fake(SCHEDULE)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    h, slices, _ = out["held"]
    layers, leaves, chunks = 3, out["leaves"], 2
    assert (h, slices) == (7, 7 * layers), out["held"]
    model = 5 * layers + 6 * chunks + 1
    want = {
        "tp/train": {"all-gather": 2 + 2 * slices,
                     "reduce-scatter": slices,
                     "all-reduce": (leaves - h + 1) + 1 + model,
                     "all-to-all": 0},
        "tp/prefill": {"all-gather": 3 + slices, "reduce-scatter": 0,
                       "all-reduce": 2 * layers, "all-to-all": 1},
        "tp/decode": {"all-gather": 3 * layers + 3 + slices,
                      "reduce-scatter": 0, "all-reduce": 5 * layers,
                      "all-to-all": 0},
        # zero3: no split over "model"; the head gathered over both axes
        # (two all-gathers), each layer slice over "model" then "data";
        # gradients all-reduced over both batch axes but the held ones'
        # (reduce-scattered over both), the norm's over each
        "zero3/train": {"all-gather": 2 + 2 * 2 * slices,
                        "reduce-scatter": 2 * slices,
                        "all-reduce": 2 * (leaves - h + 1) + 2,
                        "all-to-all": 0},
        "zero3/prefill": {"all-gather": 2 + 2 * slices,
                          "reduce-scatter": 0, "all-reduce": 0,
                          "all-to-all": 0},
        "zero3/decode": {"all-gather": 2 + 2 * slices,
                         "reduce-scatter": 0, "all-reduce": 0,
                         "all-to-all": 0},
    }
    for cell, w in want.items():
        r = out[cell]
        assert r["unmatched"] == [], (cell, r)
        assert r["counts"] == w, (cell, r["counts"], w)
        assert r["flops"] == r["whole_flops"] > 0, (cell, r)
        assert r.get("off_flops", r["flops"]) == r["flops"], (cell, r)


MEMORY = COMMON + """
out = {"view": held(get_config("llama3-8b").reduced())[2]}
for layers in (2, 6):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              num_layers=layers)
    for kind in ("train", "prefill", "decode"):
        for whole in (False, True):
            r = trace(cfg, kind, whole)
            out[f"{layers}/{kind}/{whole}"] = r["memory"]["temp_size_in_bytes"]
print(json.dumps(out))
"""


def test_fsdp_temporaries_hold_at_most_two_layers_views():
    proc = run_fake(MEMORY)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    view = out["view"]
    assert view == 73_728, view   # (64·64·2 + 64·32·2 + 3·64·128) / 2 · 4 B
    for kind in ("train", "prefill", "decode"):
        grow = (out[f"6/{kind}/False"] - out[f"2/{kind}/False"]) / 4
        whole = (out[f"6/{kind}/True"] - out[f"2/{kind}/True"]) / 4
        assert grow < view, (kind, grow, view)
        assert whole >= (2 if kind == "train" else 1) * view, (kind, whole)


@pytest.mark.parametrize("arch", ["llama3-8b", "seamless-m4t-large-v2"])
def test_fsdp_layer_composition_equals_the_full_trace(arch):
    proc = run_fake(f"ARCH = {arch!r}\nPROFILE = 'tp'\n" + FORCE
                    + COMPOSITION)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert out["units"] == 3 and out["tail"] == 0.0
    assert all(v > 0 for v in out["direct"])
    assert out["composed"] == out["direct"]
