"""Package rules of the port: no JAX, no reference imports, no silent CPU.

``repro_torch`` imports torch and numpy only — never jax and nothing of
``repro`` — and every entry point runs on the CUDA card unless the caller
passes ``device="cpu"``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.scenarios as ts  # noqa: E402
from repro_torch import ft, serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.M)


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.convert, repro_torch.core, "
        "repro_torch.kernels, repro_torch.telemetry, repro_torch.scenarios\n"
        "from repro_torch.kernels import build, ops, ref, bittide_step, "
        "bittide_sparse\n"
        "from repro_torch.telemetry import compile_stats, watermarks, trace\n"
        "from repro_torch.core import envelopes, reframing, ddc, latency, "
        "schedule, frame_level, network\n"
        "from repro_torch.scenarios import events, compiler, runner, chaos\n"
        "import repro_torch.serve, repro_torch.ft, repro_torch.configs, "
        "repro_torch.models\n"
        "from repro_torch.serve import arrival, costmodel, pacing, engine\n"
        "from repro_torch.ft import straggler\n"
        "from repro_torch.models import model_zoo, layers, attention, "
        "mamba2, moe, transformer, losses\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
        "repro_torch.launch, repro_torch._tree\n"
        "from repro_torch.optim import adamw\n"
        "from repro_torch.data import pipeline\n"
        "from repro_torch.checkpoint import manager\n"
        "from repro_torch.launch import train, mesh, memmodel, "
        "hloanalysis, dryrun, roofline\n"
        "from repro_torch.launch import abstract_train_args, "
        "abstract_serve_args\n"
        "from repro_torch.models.layers import abstract, fake_dtensor\n"
        "from repro_torch.launch import (make_production_mesh, "
        "make_mesh_from_devices, dp_axes_of)\n"
        "from repro_torch.ft import elastic, HealthTracker, plan_mesh, "
        "remesh\n"
        "import repro_torch.sched\n"
        "from repro_torch.sched import pipeline, PipelinePlan, plan, "
        "pipeline_apply\n"
        "from repro_torch.optim.compression import compress, decompress, "
        "init_error_state, ef_roundtrip, compressed_psum\n"
        "from repro_torch.telemetry import engine_cache_sizes\n"
        "from repro_torch.models.layers import resolve_spec, "
        "fit_spec_to_shape, pspec_tree, spec_placements\n"
        "import repro_torch._compat\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') and "
        "sys.modules[m] is not None for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    assert path.exists()
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_card_side_bars_equal_the_harness_bars():
    """chip_smoke.py (and the card tests, which take its bars) run where
    jax is absent, so it restates the harness's bars; they must agree."""
    import engine_harness
    text = (ROOT / "chip_smoke.py").read_text()
    for name in ("FREQ_ATOL_PPM", "BETA_ATOL_FRAMES"):
        value = re.search(rf"^{name} = (\S+)$", text, re.M).group(1)
        assert float(value) == getattr(engine_harness, name), name


def test_card_side_linkdrop_bar_equals_the_reference_test():
    """chip_smoke.py's LinkDrop-campaign bar is tests/test_chaos.py's."""
    text = (ROOT / "chip_smoke.py").read_text()
    value = re.search(r"^LINKDROP_ATOL_PPM = (\S+)$", text, re.M).group(1)
    ref = (ROOT / "tests" / "test_chaos.py").read_text()
    body = ref[ref.index("def test_linkdrop_campaign_runs_on_sparse"):]
    body = body[:body.index("\ndef ")]
    assert float(value) == float(re.search(r"atol=([0-9.e-]+)\)",
                                           body).group(1))


def test_card_side_model_bars_equal_the_cpu_tests():
    """Phase 12's bars (chip_smoke.py) are the CPU model tests': the
    logit bar, the greedy margin, the f8 cache's bar and the witness
    ratio of the parting at depth; the card tests run every
    architecture."""
    import test_torch_models_serving as serving
    import test_torch_models_zoo as zoo
    from repro_torch.configs import ARCH_NAMES
    text = (ROOT / "chip_smoke.py").read_text()
    value = lambda name: float(re.search(rf"^{name} = (\S+)$", text,
                                         re.M).group(1))
    assert value("LOGIT_TOL") == zoo.LOGIT_TOL
    assert value("GREEDY_MARGIN") == serving.MARGIN
    assert value("F8_REL") == zoo.F8_REL == 0.02
    assert value("WITNESS_RATIO") == serving.WITNESS_RATIO
    gpu = (ROOT / "tests" / "test_torch_gpu.py").read_text()
    block = gpu[gpu.index("MODEL_ARCHS = ["):]
    block = block[:block.index("]") + 1]
    assert sorted(re.findall(r'"([^"]+)"', block)) == ARCH_NAMES


def test_card_side_train_bars_equal_the_cpu_tests():
    """Phase 13's bars (chip_smoke.py, taken by the card tests) are the
    CPU training tests': the loss bar, the gradient bar and AdamW's f32
    ulps; the card tests hold every architecture."""
    import test_torch_train_modules as modules
    import test_torch_train_zoo as zoo
    text = (ROOT / "chip_smoke.py").read_text()
    value = lambda name: float(re.search(rf"^{name} = (\S+)$", text,
                                         re.M).group(1))
    assert value("TRAIN_LOSS_REL") == zoo.LOSS_REL == modules.LOSS_REL
    assert value("TRAIN_GRAD_RTOL") == zoo.GRAD_RTOL == modules.GRAD_RTOL
    assert value("TRAIN_GRAD_ATOL") == zoo.GRAD_ATOL == modules.GRAD_ATOL
    assert value("ADAMW_F32_ULPS") == modules.F32_ULP_BAR
    gpu = (ROOT / "tests" / "test_torch_gpu.py").read_text()
    assert "def test_train_step_card_matches_cpu(cuda, name)" in gpu
    assert "chip_smoke.TRAIN_LOSS_REL" in gpu


def test_chip_smoke_alone_exits_without_a_result(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script finds no port beside it: it exits 3 and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout == ""
    assert "no port beside the script" in proc.stderr


def test_card_tests_take_the_card_side_bars():
    """tests/test_torch_gpu.py runs where jax is absent: it takes its bars
    from chip_smoke.py (held to the harness above) and restates none."""
    text = (ROOT / "tests" / "test_torch_gpu.py").read_text()
    for name in ("FREQ_ATOL_PPM", "BETA_ATOL_FRAMES"):
        assert re.search(rf"^{name} = chip_smoke\.{name}$", text, re.M), name
    assert not re.search(r"^[A-Z_]*ATOL[A-Z_]* = [0-9]", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+engine_harness", text, re.M)


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = tc.fully_connected(4)
    links = tc.make_links(topo)
    calls = [
        lambda: tc.simulate(topo, links, tc.ControllerConfig(), np.zeros(4),
                            tc.SimConfig(steps=10, record_every=10)),
        lambda: tc.simulate_ensemble(topo, links, tc.ControllerConfig(),
                                     np.zeros((2, 4)),
                                     tc.SimConfig(steps=10, record_every=10)),
        lambda: tk.simulate_ensemble_dense(topo, links, np.zeros((2, 4)), 10,
                                           2e-9, record_every=10),
        lambda: tk.simulate_fused(topo, links, np.zeros(4), 10, 2e-9),
        lambda: tk.simulate_dense(topo, links, np.zeros(4), 10, 2e-9),
        lambda: tk.densify(topo, links),
        lambda: tk.simulate_fused(topo, links, np.zeros(4), 10, 2e-9,
                                  device="cuda"),
        lambda: tk.simulate_ensemble_dense(
            topo, links, np.zeros((1, 4)), 10, 2e-9, record_every=10,
            options=tk.EngineOptions(engine="tiled")),
        lambda: ts.run_scenario(topo, links, tc.ControllerConfig(),
                                np.zeros(4), ts.Scenario(events=()),
                                tc.SimConfig(steps=10, record_every=10)),
        lambda: ts.run_scenario(topo, links, tc.ControllerConfig(),
                                np.zeros(4), ts.Scenario(events=()),
                                tc.SimConfig(steps=10, record_every=10),
                                options=tk.EngineOptions(engine="fused")),
        lambda: tk.simulate_ensemble_dense(
            topo, links, np.zeros((1, 4)), 10, 2e-9, record_every=10,
            options=tk.EngineOptions(engine="sparse")),
        lambda: ts.run_scenario(topo, links, tc.ControllerConfig(),
                                np.zeros(4), ts.Scenario(events=()),
                                tc.SimConfig(steps=10, record_every=10),
                                options=tk.EngineOptions(engine="sparse")),
        lambda: ts.ChaosCampaign(
            topo=topo, ctrl=tc.ControllerConfig(),
            samplers=(ts.FreqStepSampler(t=0.005),), num_draws=2,
            cfg=tc.SimConfig(steps=10, record_every=10),
            engine="sparse").run(),
        lambda: tk.simulate_ensemble_dense(
            topo, links, np.zeros((1, 4)), 10, 2e-9, record_every=10,
            options=tk.EngineOptions(engine="per-step")),
        lambda: tk.simulate_dense_perstep(topo, links, np.zeros(4), 10,
                                          2e-9),
        lambda: tk.ops.bittide_step(np.zeros(4), np.zeros(4), np.zeros(4),
                                    np.zeros((1, 4, 4)), np.zeros((1, 4, 4)),
                                    np.zeros(1), 2e-9, 0.0, 1.0),
        lambda: ts.run_scenario(topo, links, tc.ControllerConfig(),
                                np.zeros(4), ts.Scenario(events=()),
                                tc.SimConfig(steps=10, record_every=10),
                                options=tk.EngineOptions(engine="per-step")),
        lambda: tc.BittideNetwork.build(topo),
        lambda: tc.BittideNetwork(topo, links, np.zeros(4)).run_scenario(
            ts.Scenario(events=()), cfg=tc.SimConfig(steps=10,
                                                      record_every=10)),
        lambda: serve.pace_workers(topo, np.zeros(4), ts.Scenario(events=()),
                                   duration_s=1.0),
        lambda: serve.pace_workers(topo, np.zeros(4), ts.Scenario(events=()),
                                   duration_s=1.0, engine="fused"),
        lambda: ft.simulate_stragglers(topo, np.zeros(4), duration_s=1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_model_entry_points_without_device_raise_when_no_card(monkeypatch):
    """The model stack's builders run on the card unless given
    ``device="cpu"``; ``prefill`` / ``decode`` follow the tensors they are
    handed, so CPU tensors run on the CPU with no card."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo, materialize, widen_caches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    zoo = ModelZoo(cfg)
    tree = {"embed": np.zeros((4, 2), np.float32),
            "layers": {"w": np.ones((2, 3), np.float32)}}
    calls = [
        lambda: materialize(zoo.param_defs(), torch.Generator(),
                            torch.float32),
        lambda: materialize(zoo.param_defs(), torch.Generator(),
                            torch.float32, device="cuda"),
        lambda: convert.model_params(tree),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params = materialize(zoo.param_defs(), torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with torch.inference_mode():
        logits, caches = zoo.prefill(params, {"tokens": toks})
        logits2, _ = zoo.decode(params, widen_caches(caches),
                                {"tokens": toks[:, :1]})
    assert logits.device.type == logits2.device.type == "cpu"
    assert convert.model_params(tree, device="cpu")["layers"]["w"].shape \
        == (2, 3)


def test_train_entry_points_without_device_raise_when_no_card(
        monkeypatch, tmp_path):
    """The training path's builders run on the card unless given
    ``device="cpu"``: ``init_train_state``, ``SyntheticPipeline.batch`` and
    ``restore`` raise with no card; the train step follows the tensors
    it is handed."""
    from repro_torch.checkpoint import CheckpointManager, restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import init_train_state, make_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 2))
    save(str(tmp_path), 1, {"w": torch.ones(2)})
    calls = [
        lambda: init_train_state(cfg, None, torch.Generator()),
        lambda: data.batch(0),
        lambda: data.batch(0, device="cuda"),
        lambda: restore(str(tmp_path), 1, {"w": torch.ones(2)}),
        lambda: CheckpointManager(str(tmp_path)).restore_latest(
            {"w": torch.ones(2)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(TypeError, match="DeviceMesh"):
        init_train_state(cfg, object(), torch.Generator(), device="cpu")
    params, opt_state = init_train_state(
        cfg, None, torch.Generator().manual_seed(0), device="cpu")
    _, _, metrics = make_train_step(cfg)(params, opt_state,
                                         data.batch(0, device="cpu"), 0)
    assert metrics["loss"].device.type == "cpu" and metrics["step"] == 1
    assert restore(str(tmp_path), 1, {"w": torch.ones(2)},
                   device="cpu")["w"].device.type == "cpu"


def test_abstract_args_take_the_card_and_need_fake_mode(monkeypatch):
    """The dry run's abstract arguments are fake tensors: built outside a
    ``FakeTensorMode`` they raise; with no mesh and no ``device`` they
    are on the card, and raise with no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import abstract_serve_args, abstract_train_args
    from repro_torch.models import ModelZoo
    from repro_torch.models.layers import abstract
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    shape = ShapeSpec("t", "train", 64, 2)
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        abstract(ModelZoo(cfg).param_defs(), torch.float32, device="cpu")
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="CUDA"):
            abstract_train_args(cfg, shape, None, ("data",))
        with pytest.raises(RuntimeError, match="CUDA"):
            abstract_serve_args(cfg, ShapeSpec("d", "decode", 64, 2), None,
                                ("data",))
        params, opt, batch, step = abstract_train_args(
            cfg, shape, None, ("data",), device="cpu")
    assert params["embed"].device.type == "cpu"
    assert batch["tokens"].dtype == torch.int32


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrapper takes the plain version only for CPU tensors: a tensor
    on any other device launches the kernel or raises."""
    called = []
    monkeypatch.setattr(
        "repro_torch.kernels.bittide_step.bittide_fused_torch",
        lambda *a, **k: called.append(1))
    x = torch.zeros(1, 2, device="meta")
    a = torch.zeros(1, 2, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.bittide_fused(x, x, x, a, torch.zeros(2, device="meta"), x,
                         torch.zeros(1, 1, device="meta"),
                         torch.zeros(1, device="meta"),
                         torch.zeros(1, device="meta"), 1.0, num_records=1,
                         record_every=1)
    assert not called


@pytest.mark.parametrize("kernel", ["fused", "tiled"])
def test_cuda_tensor_never_takes_the_plain_version_any_kernel(monkeypatch,
                                                              kernel):
    """Both wrappers, guard variant included: a tensor on a device other
    than the CPU never reaches the plain version."""
    called = []
    for name in ("bittide_fused_torch", "bittide_tiled_torch"):
        monkeypatch.setattr(f"repro_torch.kernels.bittide_step.{name}",
                            lambda *a, **k: called.append(1))
    x = torch.zeros(1, 2, device="meta")
    g = torch.zeros(1, device="meta")
    wrapper = tk.bittide_fused if kernel == "fused" else tk.bittide_tiled
    with pytest.raises(ValueError, match="cuda or cpu"):
        wrapper(x, x, x, torch.zeros(1, 2, 2, device="meta"),
                torch.zeros(2, device="meta"), x,
                torch.zeros(1, 1, device="meta"), g, g, 1.0, num_records=1,
                record_every=1, record_guard=True, guard_lo=g, guard_hi=g,
                guard_stop=0)
    assert not called


def test_sparse_wrapper_never_takes_the_plain_version(monkeypatch):
    """The sparse wrapper, guard variant included: a tensor on a device
    other than the CPU never reaches the plain version."""
    from repro_torch.kernels import bittide_sparse as sp
    called = []
    monkeypatch.setattr(sp, "bittide_sparse_torch",
                        lambda *a, **k: called.append(1))
    x = torch.zeros(1, 2, device="meta")
    g = torch.zeros(1, device="meta")
    tbl = torch.zeros(1, 1, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sp.bittide_sparse(x, x, x, torch.zeros(1, 2, dtype=torch.int32,
                                               device="meta"), tbl, tbl, x,
                          g, g, 1.0, num_records=1, record_every=1,
                          record_guard=True, guard_lo=g, guard_hi=g,
                          guard_stop=0)
    assert not called


def test_perstep_wrapper_never_takes_the_plain_version(monkeypatch):
    """The per-step wrapper, guard variant included: a tensor on a device
    other than the CPU never reaches the plain version."""
    from repro_torch.kernels import bittide_step as bs
    called = []
    monkeypatch.setattr(bs, "bittide_perstep_torch",
                        lambda *a, **k: called.append(1))
    x = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bs.bittide_perstep(x, x, x, torch.zeros(1, 2, 2, device="meta"), x,
                           x, torch.zeros(1, device="meta"), 1e-9, 0.0, 1.0,
                           num_records=1, record_every=1, record_guard=True,
                           guard_lo=-1.0, guard_hi=1.0, guard_stop=0)
    assert not called


def test_mesh_entry_points_without_device_type_raise_when_no_card(
        monkeypatch):
    """The mesh builders take the card unless given ``device_type="cpu"``:
    with no card they raise before touching ``torch.distributed``."""
    from repro_torch.ft import remesh
    from repro_torch.launch import make_mesh_from_devices, make_production_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: make_production_mesh(),
        lambda: make_production_mesh(multi_pod=True),
        lambda: make_mesh_from_devices([0], (1,), ("data",)),
        lambda: make_mesh_from_devices([0], (1, 1), ("data", "model"),
                                       device_type="cuda"),
        lambda: remesh([0, 1], model_size=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not torch.distributed.is_initialized()
