"""The diverged-draw cases of the card's kernel checks, on the CPU.

``chip_smoke.STREAM_NONFINITE_CASES`` hold the tiled, sparse and per-step
kernels to their plain versions on a diverged draw, watermarks included
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 2).  A kernel that
folds the watermarks with fmaxf / fminf drops a NaN operand, where the
plain version's torch.maximum / minimum keep it; those checks catch that
only where a NaN arrives after record 0 at a place whose running value
was not NaN.  Here, with the plain versions on the CPU: the "diverging"
seed (draw 3's gain at ``DIVERGING_KP``) makes such records in every
case, so a NaN-dropping fold would give other watermarks; and the "inf"
seed leaves NaN in the seeded draw's β maximum and ν extremes.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CPU = torch.device("cpu")


def _plain_run(kernel, case, seed):
    """The plain version's records and watermarks on the seeded inputs of
    ``chip_smoke.stream_nonfinite_rows``."""
    _, args, kw, _, _, plain, _ = chip_smoke.stream_nonfinite_inputs(
        kernel, case, seed, CPU)
    return plain(*args, **kw, record_beta=True, record_watermarks=True)


@pytest.mark.parametrize("kernel,case", chip_smoke.STREAM_NONFINITE_CASES,
                         ids=list(chip_smoke.STREAM_NONFINITE_IDS))
def test_diverging_draw_tells_a_nan_dropping_fold_apart(kernel, case):
    out = _plain_run(kernel, case, "diverging")
    fin = torch.isfinite(out.freq)
    d = chip_smoke.NONFINITE_SEED[0]
    draw = fin if fin.dim() == 2 else fin[:, d]
    # Finite at record 0, non-finite by the last record.
    assert bool(draw[0].all()) and not bool(draw[-1].all())
    assert chip_smoke.nan_fold_differs(out)


@pytest.mark.parametrize("kernel,case", chip_smoke.STREAM_NONFINITE_CASES,
                         ids=list(chip_smoke.STREAM_NONFINITE_IDS))
def test_inf_seed_leaves_nan_in_the_watermarks(kernel, case):
    out = _plain_run(kernel, case, "inf")
    bmax, _, lo, hi = out.watermarks
    d = chip_smoke.NONFINITE_SEED[0]
    pick = (lambda x: x) if bmax.dim() == 1 else (lambda x: x[d])
    for x in (bmax, lo, hi):
        assert bool(torch.isnan(pick(x)).any())
    if bmax.dim() == 2:
        rest = torch.arange(bmax.shape[0]) != d
        for x in (bmax, lo, hi):
            assert bool(torch.isfinite(x[rest]).all())
