"""The serving steps with FSDP leaves held sharded through them
(``launch.train._layer_gather``, ``models.fsdp``), on a gloo CPU world
(``tests/torch_gloo.py``) of 4 ranks as (2 data, 2 model).

Reduced llama3-8b (dense), zamba2-7b (hybrid: 2 groups of 2 Mamba2
layers and a tail of 1) and seamless-m4t-large-v2 (encoder-decoder),
each with FSDP forced (``FSDP_PARAM_THRESHOLD = 0`` in every rank, as a
test sets it): ``make_prefill_step`` then three chained
``make_decode_step`` calls (``widen_mesh_caches`` between them, the
greedy tokens of the whole-view chain fed to both) equal the
whole-view oracle bit for bit — the same steps with every leaf gathered
whole before the first layer, as the parent's steps gathered them
(``_layer_gather`` made to hold no leaf) — in their logits and every
cache leaf, placed alike.  Each call gathers each layer's slice once
(``GATHER_COUNT``).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_fsdp_train import CONFIGS  # noqa: E402
from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE = CONFIGS + """
import json
from repro_torch._tree import tree_flatten_with_path
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_mesh_from_devices, make_prefill_step,
                                widen_mesh_caches)
from repro_torch.models.fsdp import GATHER_COUNT

cfg = config(ARCH)
mesh = make_mesh_from_devices(range(WORLD), (2, 2), ("data", "model"),
                              device_type="cpu")
params, _ = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
batch = batch_of(cfg, 4, 4, PROMPT)
serve = {k: v for k, v in batch.items() if k != "labels"}
if "src_embeds" in serve:
    serve["src_embeds"] = batch_of(cfg, 5, 4, SOURCE)["src_embeds"]
layer_gather = train_mod._layer_gather


def whole_view(fn):
    # the steps below that run so plan their first call without a held
    # leaf, and keep that plan
    train_mod._layer_gather = lambda cfg, mesh, params, roles, axes: None
    try:
        return fn()
    finally:
        train_mod._layer_gather = layer_gather


def differ(tag, got, want):
    (gl, gc), (wl, wc) = got, want
    out = [] if same(gl.full_tensor(), wl.full_tensor()) else [f"{tag}/logits"]
    for (path, a), (_, b) in zip(tree_flatten_with_path(gc),
                                 tree_flatten_with_path(wc)):
        if not (same(a.full_tensor(), b.full_tensor())
                and a.placements == b.placements):
            out.append(tag + "/" + "/".join(path))
    return out


prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
prefill_w, decode_w = make_prefill_step(cfg), make_decode_step(cfg)
gathers = []
with torch.no_grad():
    GATHER_COUNT["layers"] = 0
    got = prefill(params, serve)
    gathers.append(GATHER_COUNT["layers"])
    want = whole_view(lambda: prefill_w(params, serve))
    diff = differ("prefill", got, want)
    for n in range(3):
        tok = {"tokens": want[0].full_tensor().argmax(-1).to(torch.int32)}
        GATHER_COUNT["layers"] = 0
        got = decode(params, widen_mesh_caches(cfg, got[1]), tok)
        gathers.append(GATHER_COUNT["layers"])
        want = whole_view(lambda: decode_w(params, widen_mesh_caches(
            cfg, want[1]), tok))
        diff += differ(f"decode{n}", got, want)
with open(WORKDIR + f"/serve{RANK}.json", "w") as f:
    json.dump(dict(differ=diff, gathers=gathers), f)
"""

# per family: (prompt, source) lengths and the layer slices a call
# gathers
FAMILIES = {"llama3-8b": (15, None, 3), "zamba2-7b": (20, None, 5),
            "seamless-m4t-large-v2": (19, 24, 4)}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_fsdp_serving_steps_match_the_whole_view_oracle(tmp_path, arch):
    prompt, source, layers = FAMILIES[arch]
    res = run_ranks(f"ARCH = {arch!r}\nPROMPT = {prompt}\n"
                    f"SOURCE = {source}\n" + SERVE, 4, tmp_path)
    assert_ranks_ok(res)
    for rank in range(4):
        r = json.loads((tmp_path / f"serve{rank}.json").read_text())
        assert r["differ"] == [], (rank, r["differ"])
        # prefill's forward and each decode step: each layer once (the
        # encoder-decoder's decode runs its decoder layers only)
        decode = 2 if arch == "seamless-m4t-large-v2" else layers
        assert r["gathers"] == [layers] + [decode] * 3, (rank, r)
