"""The tiled and per-step kernels' launch plans, and the build's cache key.

CPU only: the plans are what the wrappers allocate and launch by, and
``build.library_path`` names the library a source is built into.  On the
card ``chip_smoke.py`` holds the plans to what the built libraries report
(``bittide_step.device_plan``).
"""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bittide_step import (  # noqa: E402
    PERSTEP_TILE_J, RING_STAGES, TILE_I, TILE_J, TILED_GROUP_MAX,
    perstep_launch_plan, tiled_launch_plan)

NODES = (1, 31, 32, 33, 216, 343, 10_648)
SMEM_OPTIN_BYTES = 232_448   # shared memory one H100 CTA may opt in to


@pytest.mark.parametrize("c", range(1, 9))
def test_launch_plans_cover_the_network_and_fit_shared_memory(c):
    """Every C ≤ 8, group ≤ 8 (and batches of several groups): the grid
    covers N rows and B draws with no CTA wholly past them, the ring fits
    the H100's opt-in shared memory, and the x scratch holds two slots of
    every (group draw, class, node)."""
    for n in NODES:
        for b in list(range(1, TILED_GROUP_MAX + 1)) + [9, 17, 64]:
            plan = tiled_launch_plan(b, n, c)
            rows, groups = plan["grid"]
            g = plan["draws_per_cta"]
            assert g == min(b, TILED_GROUP_MAX)
            assert rows * TILE_I >= n > (rows - 1) * TILE_I
            assert (groups * TILED_GROUP_MAX >= b
                    > (groups - 1) * TILED_GROUP_MAX)
            assert plan["threads"] == 32 * (TILE_I // 32 * -(-g // 4) + 1)
            assert plan["threads"] <= 1024
            assert plan["smem_bytes"] <= SMEM_OPTIN_BYTES
            assert plan["x_floats"] >= 2 * groups * c * n * TILED_GROUP_MAX
            assert plan["stages"] == RING_STAGES >= 4
            assert plan["panels"] * TILE_J >= n
        plan = perstep_launch_plan(n, c)
        assert plan["grid"][0] * TILE_I >= n > (plan["grid"][0] - 1) * TILE_I
        assert plan["smem_bytes"] <= SMEM_OPTIN_BYTES
        assert plan["x_floats"] >= 2 * c * n
        assert plan["stages"] == RING_STAGES
        assert plan["panels"] * PERSTEP_TILE_J >= n


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_library_path_changes_with_any_source_of_the_library(
        tmp_path, monkeypatch, edit):
    """An edited header (or a new one) in csrc/, like an edited source,
    names another library, so a stale build is never loaded; restoring the
    bytes names the first library again."""
    (tmp_path / "k.cu").write_text('#include "ring.cuh"\n')
    (tmp_path / "ring.cuh").write_text("constexpr int kStages = 4;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    target = {"header": tmp_path / "ring.cuh",
              "new_header": tmp_path / "more.cuh",
              "source": tmp_path / "k.cu"}[edit]
    before = target.read_bytes() if target.exists() else None
    target.write_text("constexpr int kStages = 6;\n")
    assert build.library_path("k") != first
    if before is None:
        target.unlink()
    else:
        target.write_bytes(before)
    assert build.library_path("k") == first
