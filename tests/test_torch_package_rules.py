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

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.M)


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.convert, repro_torch.core, "
        "repro_torch.kernels, repro_torch.telemetry\n"
        "from repro_torch.kernels import build, ops, ref, bittide_step\n"
        "from repro_torch.telemetry import compile_stats, watermarks\n"
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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


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
