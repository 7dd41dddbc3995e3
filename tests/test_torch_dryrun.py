"""The port's dry run (``launch.dryrun``) on fake worlds, against the JAX
package where the reference has a counterpart, on the CPU.

  * a mirror of ``tests/test_multidevice.py::test_mini_dryrun_8dev``:
    internlm2-1.8b at ``.reduced()`` on a fake (2, 2, 2) world, train
    (64 tokens × 8): FLOPs counted, collectives seen, and exactly the
    split step's schedule — all-reduces = (gradient leaves + 1) × the two
    data axes, + the norm's over "model", + the layers' and the
    vocabulary-parallel loss's (forward, recompute, backward), one
    all-gather (the embedding along d; no split leaf is gathered); a
    prefill cell (two all-reduces per layer; the embedding and the logits
    gathered; one all-to-all that hands each rank its slice of the K/V
    caches' sequence with every kv head) and a decode cell (the split
    decode on caches split on the sequence over "model": per layer q, k
    and v gathered along the heads and five all-reduces — the combine's
    three, ``wo``'s and the MLP's — and the embedding and the logits
    gathered; no parameter and no cache gathered); nothing unmatched;
  * the L1/L2 composition (``_compose``) equals a direct full-depth
    trace exactly for reduced dense (split over "model" and not), moe,
    ssm and encdec configs;
  * ``run_cell`` and the CLI write the reference's JSON layout, which
    ``roofline.main`` turns into its tables; ``--list`` prints the
    40-cell matrix (8 long_500k cells skipped);
  * the worker processes' fork server ends with the process that
    started it.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import run_fake  # noqa: E402

MINI_DRYRUN = """
import json
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, make_mesh_from_devices
from repro_torch.launch.train import _profile, use_fsdp
from repro_torch.models import ModelZoo
from repro_torch.models.layers import (fit_spec_to_shape, resolve_spec,
                                       spec_placements)

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh_from_devices(range(8), (2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
cfg = get_config("internlm2-1.8b").reduced()
zoo = ModelZoo(cfg)
dp, use_tp, fsdp_axes = _profile(cfg, ("pod", "data"))


def sharded_dims(defs):
    n = 0
    for d in tree_leaves(defs):
        spec = resolve_spec(d.spec, use_fsdp=use_fsdp(cfg), dp_axes=dp,
                            use_tp=use_tp, fsdp_axes=fsdp_axes)
        pl = spec_placements(fit_spec_to_shape(d.shape, spec, mesh), mesh)
        n += sum(p.is_shard() for p in pl)
    return n


out = {"param_leaves": len(tree_leaves(zoo.param_defs())),
       "param_sharded_dims": sharded_dims(zoo.param_defs()),
       "layers": cfg.num_layers, "loss_chunks": 64 // cfg.loss_chunk}
for kind in ("train", "prefill", "decode"):
    shape = ShapeSpec(kind, kind, 64, 8)
    out[kind] = dryrun._trace(cfg, shape, mesh)
    if kind == "decode":
        model = mesh.mesh_dim_names.index("model")
        n = 0
        for d in tree_leaves(zoo.cache_defs(shape)):
            spec = resolve_spec(d.spec, use_fsdp=False, dp_axes=dp,
                                use_tp=use_tp)
            pl = spec_placements(fit_spec_to_shape(d.shape, spec, mesh), mesh)
            n += pl[model].is_shard()
        out["cache_leaves_on_model"] = n
print(json.dumps(out))
"""


def test_mini_dryrun_on_a_fake_8_rank_world():
    proc = run_fake(MINI_DRYRUN)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    leaves, gathers = out["param_leaves"], out["param_sharded_dims"]
    assert 0 < gathers <= leaves
    n_layers, chunks = out["layers"], out["loss_chunks"]
    tr = out["train"]
    assert tr["flops"] > 0 and tr["bytes"] > 0
    assert tr["collectives"]["total"]["count"] > 0, \
        "expected collectives on a 3-axis mesh"
    # Over "model": per layer, forward 2 (attention, MLP); the recompute
    # under the layer's checkpoint 1 (it stops once the tensors backward
    # needs exist, before the MLP's all-reduce); backward 2 (the inputs'
    # gradients).  Per loss chunk, forward 3 (max, sum of exponentials,
    # gold logit), recompute 2 (it stops before the gold's), backward 1
    # (the hidden states' gradient).  And the norm's one.
    model = 5 * n_layers + 6 * chunks + 1
    assert tr["collectives"]["all-reduce"]["count"] == \
        (leaves + 1) * 2 + model
    assert tr["collectives"]["all-gather"]["count"] == 1
    pf = out["prefill"]
    assert pf["collectives"]["all-reduce"]["count"] == 2 * n_layers
    assert pf["collectives"]["all-gather"]["count"] == 2
    assert pf["collectives"]["all-to-all"]["count"] == 1
    dc = out["decode"]
    assert out["cache_leaves_on_model"] > 0
    assert dc["collectives"]["all-reduce"]["count"] == 5 * n_layers
    assert dc["collectives"]["all-gather"]["count"] == 3 * n_layers + 2
    for kind in ("train", "prefill", "decode"):
        r = out[kind]
        assert r["unmatched_collectives"] == [], kind
        for k in ("reduce-scatter", "all-to-all", "collective-permute"):
            if (kind, k) != ("prefill", "all-to-all"):
                assert r["collectives"][k]["count"] == 0, (kind, k)
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0, kind
        assert mem["temp_size_in_bytes"] > 0, kind
        assert not r["exceeds_device_memory"]


COMPOSITION = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, make_mesh_from_devices

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh_from_devices(range(8), (2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
cfg = dataclasses.replace(get_config(ARCH).reduced(),
                          sharding_profile=PROFILE)
if cfg.family == "encdec":
    cfg = dataclasses.replace(cfg, encoder_layers=3, decoder_layers=3)
shape = ShapeSpec("train", "train", 64, 8)
cfg1, cfg2, _, _ = dryrun._layer_variants(cfg)
roof = dryrun._compose(cfg, dryrun._trace(cfg1, shape, mesh),
                       dryrun._trace(cfg2, shape, mesh))
full = dryrun._trace(dataclasses.replace(cfg, unroll_layers=True), shape,
                     mesh)
print(json.dumps(dict(units=roof["units"], tail=roof["tail_units"],
                      composed=[roof["flops_per_device"],
                                roof["bytes_per_device"],
                                roof["wire_bytes_per_device"]],
                      direct=[full["flops"], full["bytes"],
                              full["collectives"]["total"]["wire_bytes"]])))
"""


@pytest.mark.parametrize("arch,profile", [
    ("internlm2-1.8b", "dp"), ("qwen2-moe-a2.7b", "dp"),
    ("mamba2-370m", "dp"), ("seamless-m4t-large-v2", "dp"),
    ("internlm2-1.8b", "tp"), ("seamless-m4t-large-v2", "tp")])
def test_layer_composition_equals_the_full_trace(arch, profile):
    """With replicated weights (the ``dp`` profile) every count is linear
    in depth and the composition is exact.  With the compute split over
    "model" (``tp``) too: each rank computes with its shard of every
    split leaf, so no stacked leaf is gathered (where the gathered step's
    ``funcol`` gather of a one-layer stack was a view, not a copy, and
    its per-op bytes were not linear in depth)."""
    proc = run_fake(f"ARCH = {arch!r}\nPROFILE = {profile!r}\n"
                    + COMPOSITION)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert out["units"] == 3 and out["tail"] == 0.0
    assert all(v > 0 for v in out["direct"])
    (cf, cb, cw), (df, db, dw) = out["composed"], out["direct"]
    assert (cf, cb, cw) == (df, db, dw)


RUN_CELL = """
import json, pathlib
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun, roofline

# every cell at .reduced() width and shape: the full matrix is the CLI's
dryrun.get_config = lambda a: get_config(a).reduced()
dryrun.SHAPES = {k: v.reduced() for k, v in SHAPES.items()}
dryrun.open_fake_world(512)
out = pathlib.Path(OUT)
r1 = dryrun.run_cell("smollm-135m", "train_4k", str(out))
r2 = dryrun.run_cell("mamba2-370m", "long_500k", str(out), do_multi=False,
                     variant="kv8")
r3 = dryrun.run_cell("llama3-8b", "long_500k", str(out))
r4 = dryrun.run_cell("smollm-135m", "train_4k", str(out),
                     update_roofline=True)
roofline.main(["--dir", str(out)])
print("RESULTS " + json.dumps([r1, r2, r3, r4]))
"""


def test_run_cell_writes_the_reference_layout(tmp_path):
    proc = run_fake(f"OUT = {str(tmp_path)!r}\n" + RUN_CELL)
    assert proc.returncode == 0, proc.stderr[-4000:]
    text = proc.stdout
    r1, r2, r3, r4 = json.loads(text.split("RESULTS ", 1)[1])
    for r in (r1, r2, r4):
        assert r["ok"] and "error" not in r, r.get("traceback")
    assert sorted(r1) == sorted(
        ["arch", "shape", "variant", "skip_reason", "model_flops_global",
         "ok", "device_type", "params", "active_params", "single_pod",
         "multi_pod", "roofline", "tensor_parallel"])
    # reduced smollm-135m's 4 q heads on 16 ranks: its attention stays
    # gathered, and the dry run names those leaves
    tp = r1["tensor_parallel"]
    assert tp["model"] == 16 and tp["layout"]["attn"] == "gathered", tp
    assert {g["leaf"] for g in tp["gathered_leaves"]} == {
        "layers/attn/" + w for w in ("wq", "wk", "wv", "wo")}, tp
    assert sorted(r1["roofline"]) == sorted(
        ["l1", "l2", "units", "tail_units", "flops_per_device",
         "bytes_per_device", "wire_bytes_per_device", "terms", "dominant"])
    assert sorted(r1["roofline"]["terms"]) == ["collective_s", "compute_s",
                                               "memory_s"]
    for part in (r1["single_pod"], r1["multi_pod"], r1["roofline"]["l1"]):
        assert sorted(part["memory"]) == sorted(
            ["argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "alias_size_in_bytes",
             "generated_code_size_in_bytes"])
        assert part["memory"]["alias_size_in_bytes"] == 0
        assert sorted(part["collectives"]) == sorted(
            ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "total"])
    # the multi-pod mesh splits the batch over ('pod', 'data'): one more
    # all-reduce per gradient leaf and the loss; those over "model" stay
    leaves = 11   # smollm-135m's, its embedding tied
    assert r1["multi_pod"]["collectives"]["all-reduce"]["count"] == \
        r1["single_pod"]["collectives"]["all-reduce"]["count"] + leaves + 1
    assert "multi_pod" not in r2 and r2["variant"] == "kv8"
    assert r3["skip_reason"] and r3["ok"] and "single_pod" not in r3
    assert r4["roofline"]["terms"] == r1["roofline"]["terms"]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["llama3-8b__long_500k__baseline.json",
                     "mamba2-370m__long_500k__kv8.json",
                     "smollm-135m__train_4k__baseline.json"]
    for title in ("### §Dry-run", "### §Roofline", "### §Perf variants"):
        assert title in text
    assert "| smollm-135m × train_4k | ✓ (" in text
    assert "| llama3-8b × long_500k | SKIP | SKIP |" in text
    assert "mamba2-370m × long_500k × kv8" in text


def test_cli_lists_the_matrix():
    import subprocess
    import sys
    from torch_gloo import ROOT, _env
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = proc.stdout.strip().splitlines()
    assert len(rows) == 40
    assert sum(r.split()[2] == "run" for r in rows) == 32
    assert sum("SKIP: " in r for r in rows) == 8


JOBS = """
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

dryrun.get_config = lambda a: get_config(a).reduced()
dryrun.SHAPES = {k: v.reduced() for k, v in SHAPES.items()}
dryrun.open_fake_world(512)


def drop_times(d):
    if isinstance(d, dict):
        return {k: drop_times(v) for k, v in d.items() if k != "compile_s"}
    return d


dryrun.start_worker_server()
out = []
for cores in (2, 1):
    dryrun.os.cpu_count = lambda: cores
    out.append(drop_times(dryrun.run_cell("internlm2-1.8b", "decode_32k",
                                          OUT + f"/{cores}")))
print(json.dumps(out))
"""


def test_run_cell_in_processes_equals_one_process(tmp_path):
    """Where the host has a core for more than one, ``run_cell`` traces a
    cell's passes in worker processes (from a fork server started ahead),
    each on a fake world of its own: the same artifact as one process,
    but for the trace seconds."""
    proc = run_fake(f"OUT = {str(tmp_path)!r}\n" + JOBS, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    one, two = json.loads(proc.stdout.strip().splitlines()[-1])
    assert one["ok"] and "roofline" in one and "multi_pod" in one
    assert one == two


WORKER_SERVER = """
import json
from multiprocessing import forkserver, resource_tracker
from repro_torch.launch import dryrun

dryrun.start_worker_server()
print(json.dumps([forkserver._forkserver._forkserver_pid,
                  resource_tracker._resource_tracker._pid]))
"""


def test_worker_server_ends_with_its_process():
    """The fork server and the resource tracker that
    ``start_worker_server`` starts are stopped, and waited for, when the
    process that started them exits: none outlives it."""
    import os
    proc = run_fake(WORKER_SERVER)
    assert proc.returncode == 0, proc.stderr[-4000:]
    pids = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(pids) == 2 and all(isinstance(p, int) for p in pids), pids
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
