"""Card tests: the fused kernel against its plain version on an NVIDIA card.

Marked ``gpu``; run on the machine with the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
Whether a card is present is decided in the ``cuda`` fixture, never at
import, so every pytest-xdist worker collects the same tests.  Inputs and
bars come from ``chip_smoke.py`` (the card machine has no jax, so
``tests/engine_harness.py`` cannot be imported there;
``test_torch_package_rules`` checks that the bars agree): its
``PARITY_CASES`` — FC8 at B=64 and at 4·SMs·3 + 5 draws (three draws per
CTA, a partial last CTA), torus3d(6) at B=16 with two latency classes (A
read from L2) and with one (A in shared memory) — with per-draw kp / lat
/ lamsum / holdover mask, 400 periods recorded every 20.  The kernel
performs the plain version's float32 operations in the same order, so
the results are held to ``FREQ_ATOL_PPM`` / ``BETA_ATOL_FRAMES`` and
watermark indices exactly.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
from repro_torch.kernels.bittide_step import (bittide_fused,  # noqa: E402
                                              bittide_fused_torch,
                                              launch_plan)
from repro_torch.telemetry import Telemetry  # noqa: E402

pytestmark = pytest.mark.gpu

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FREQ_ATOL_PPM = chip_smoke.FREQ_ATOL_PPM
BETA_ATOL_FRAMES = chip_smoke.BETA_ATOL_FRAMES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the chip)")
    return torch.device("cuda")


# Per-draw kernel arguments: psi, nu, nu_u, lamsum, lat, kp, beta_off.
_PER_DRAW = (0, 1, 2, 5, 6, 7, 8)


@pytest.mark.parametrize("variant", [(False, False), (True, False),
                                     (False, True), (True, True)],
                         ids=["nu", "beta", "wm", "beta+wm"])
@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES,
                         ids=["fc8", "fc8_waves", "torus3d_6",
                              "torus3d_6_one_class"])
def test_kernel_matches_plain_version(cuda, case, variant):
    _, args, mask = chip_smoke.parity_inputs(case, cuda)
    kw = dict(num_records=20, record_every=20, ctrl_mask=mask,
              record_beta=variant[0], record_watermarks=variant[1])
    before = bittide_fused.launches
    got = bittide_fused(*args, **kw)
    torch.cuda.synchronize()
    assert bittide_fused.launches == before + 1
    want = bittide_fused_torch(*args, **kw)
    torch.testing.assert_close(got.freq * 1e6, want.freq * 1e6, rtol=0,
                               atol=FREQ_ATOL_PPM)
    torch.testing.assert_close(got.psi, want.psi, rtol=0,
                               atol=BETA_ATOL_FRAMES)
    if variant[0]:
        torch.testing.assert_close(got.beta, want.beta, rtol=0,
                                   atol=BETA_ATOL_FRAMES)
    if variant[1]:
        assert torch.equal(got.watermarks[1], want.watermarks[1])
        torch.testing.assert_close(got.watermarks[0], want.watermarks[0],
                                   rtol=0, atol=BETA_ATOL_FRAMES)


def test_draw_result_independent_of_batch(cuda):
    """Draw b's bits do not depend on B or on the CTA that ran it: draws
    5-8 (spread over two CTAs of three draws) and the two live draws of
    the partial last CTA equal the same draws run alone, one per CTA."""
    _, args, mask = chip_smoke.parity_inputs(("fully_connected_8", "waves",
                                              2), cuda)
    b = args[0].shape[0]
    plan = launch_plan(b, 8, 2, cuda)
    assert plan["draws_per_cta"] > 1 and b % plan["draws_per_cta"], plan
    idx = torch.tensor([5, 6, 7, 8, b - 2, b - 1], device=cuda)
    assert launch_plan(len(idx), 8, 2, cuda)["draws_per_cta"] == 1
    kw = dict(num_records=5, record_every=20, record_beta=True,
              record_watermarks=True)
    full = bittide_fused(*args, ctrl_mask=mask, **kw)
    sub = [x[idx].contiguous() if k in _PER_DRAW else x
           for k, x in enumerate(args)]
    part = bittide_fused(*sub, ctrl_mask=mask[idx].contiguous(), **kw)
    assert torch.equal(full.freq[:, idx], part.freq)
    assert torch.equal(full.beta[:, idx], part.beta)
    assert torch.equal(full.psi[idx], part.psi)
    for got, want in zip(full.watermarks, part.watermarks):
        assert torch.equal(got[idx], want)


def test_main_path_runs_on_the_card(cuda):
    topo = tc.fully_connected(8)
    ppm = np.random.default_rng(0).uniform(-8, 8, (32, 8))
    before = bittide_fused.launches
    res = tk.simulate_ensemble_dense(topo, tc.make_links(topo), ppm, 400,
                                     2e-8, dt=5e-5, record_every=20,
                                     telemetry=Telemetry(beta=True))
    assert bittide_fused.launches == before + 1
    assert res.engine == "fused" and np.isfinite(res[0]).all()
