"""The kernels' launch plans, and the build's cache key.

CPU only: the plans are what the wrappers allocate and launch by, and
``build.library_path`` names the library a source is built into.  On the
card ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the plans to
what the built libraries report (``bittide_step.device_plan``,
``fused_device_plan``, ``sparse_device_plan``).
"""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bittide_step import (  # noqa: E402
    FUSED_REG_TERMS, FUSED_WARPS_PER_CTA, PERSTEP_TILE_J, RING_STAGES,
    SPARSE_DIRECT_STATE_BYTES, SPARSE_GROUP_MAX, TILE_I, TILE_J,
    TILED_GROUP_MAX, draws_per_cta, fused_plan, perstep_launch_plan,
    sparse_launch_plan, tiled_launch_plan)

NODES = (1, 31, 32, 33, 216, 343, 10_648)
SMEM_OPTIN_BYTES = 232_448   # shared memory one H100 CTA may opt in to
H100_SMS = 132


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


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_draw"])
@pytest.mark.parametrize("b", [1, 8, 9, 235, 1024])
@pytest.mark.parametrize("n", [1, 33, 512, 9_261, 1_000_000])
def test_sparse_launch_plan_covers_the_network(n, b, shared):
    """For K in (1, 6, 13): the grid covers N nodes and B draws with no CTA
    wholly past them, a CTA has at most 1024 threads (one per node), a
    thread at most SPARSE_GROUP_MAX draws; per-draw tables run direct, and
    shared ones run grouped exactly when the (B, N) ψ + ν exceed
    SPARSE_DIRECT_STATE_BYTES."""
    for k in (1, 6, 13):
        plan = sparse_launch_plan(b, n, k, shared)
        tile, g = plan["nodes_per_cta"], plan["draws_per_thread"]
        tiles, groups = plan["grid"]
        assert tiles * tile >= n > (tiles - 1) * tile
        assert groups * g >= b > (groups - 1) * g
        assert plan["threads"] == tile <= 1024 and tile % 32 == 0
        assert plan["slots"] == k
        assert plan["grouped"] == (shared
                                   and 8 * b * n > SPARSE_DIRECT_STATE_BYTES)
        if plan["grouped"]:
            assert 1 <= g <= min(b, SPARSE_GROUP_MAX)
            assert groups == -(-b // SPARSE_GROUP_MAX)
        else:
            assert (g, groups) == (1, b)


@pytest.mark.parametrize("b,n,shared,want", [
    # torus3d(100) x 8, phase 8: every thread runs all eight draws.
    (8, 1_000_000, True, dict(grouped=True, draws_per_thread=8,
                              grid=(3_907, 1))),
    # torus3d(21) x 235 (the grouped parity case): 30 groups, the last of 3.
    (235, 9_261, True, dict(grouped=True, draws_per_thread=8,
                            grid=(37, 30))),
    # torus3d(22) x 8 (phase 8b, 0.65 MiB) and the chaos campaigns'
    # torus3d(8) x 1,024 (4 MiB; per-draw tables in the LinkDrop one).
    (8, 10_648, True, dict(grouped=False, grid=(42, 8))),
    (1024, 512, True, dict(grouped=False, grid=(2, 1024))),
    (1024, 512, False, dict(grouped=False, grid=(2, 1024))),
    # Exactly 8 MiB of ψ + ν stays direct; one node more is grouped.
    (8, 131_072, True, dict(grouped=False, grid=(512, 8))),
    (8, 131_073, True, dict(grouped=True, grid=(513, 1)))])
def test_sparse_launch_plan_at_the_main_paths_shapes(b, n, shared, want):
    plan = sparse_launch_plan(b, n, 6, shared)
    assert {key: plan[key] for key in want} == want, plan


def _fused_row_terms(n, c, kind):
    """The longest row's listed terms of a C-class stack on N nodes: a
    degree-6 graph (one class, or its edges split over the classes), or
    a fully connected one."""
    return {"deg6": min(6, max(n - 1, 0)), "fc": c * (n - 1) if c == 1
            else n - 1, "empty": 0}[kind]


@pytest.mark.parametrize("c", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 8, 12, 32, 33, 64, 216, 256, 512, 1024])
def test_fused_plan_paths_and_shared_memory(n, c):
    """The warp path exactly for N <= 32 (32 // N draws in a warp's lanes,
    at most FUSED_WARPS_PER_CTA warps per CTA), the block path's
    draws_per_cta otherwise; row lists exactly where the longest row holds
    at most FUSED_REG_TERMS terms and at most half of C·N, in registers,
    else the dense loop, with the stack in shared memory when it fits and
    the row is too long for registers; the grid
    covers B draws with no CTA wholly past them; at most 1024 threads and
    the H100's 232,448 bytes of shared memory per CTA.  Degree-6, fully
    connected and edgeless stacks, with the guard and without."""
    for kind, guard, b in itertools.product(("deg6", "fc", "empty"),
                                            (False, True),
                                            (1, 9, 64, 256, 4096)):
        terms = _fused_row_terms(n, c, kind)
        plan = fused_plan(b, n, c, terms, H100_SMS, SMEM_OPTIN_BYTES,
                          guard=guard)
        g = plan["draws_per_cta"]
        assert plan["ctas"] * g >= b > (plan["ctas"] - 1) * g
        assert plan["threads"] <= 1024
        assert plan["smem_bytes"] <= SMEM_OPTIN_BYTES
        if n <= 32:
            assert plan["path"] == "warp"
            assert plan["draws_per_warp"] == 32 // n
            warps = plan["threads"] // 32
            assert plan["threads"] == 32 * warps
            assert 1 <= warps <= FUSED_WARPS_PER_CTA
            assert g == warps * (32 // n)
        else:
            assert plan["path"] == "block" and plan["draws_per_warp"] == 0
            assert g == draws_per_cta(b, n, H100_SMS)
            assert plan["threads"] == g * n
        state = 4 * (2 * g * c * n + 2 * g * n + g * c
                     + (g if guard and n > 32 else 0))
        lists = terms <= FUSED_REG_TERMS and 2 * terms <= c * n
        assert plan["aggregation"] == ("lists" if lists else "dense")
        assert plan["registers"] == (lists or c * n <= FUSED_REG_TERMS)
        if lists:
            assert plan["list_slots"] == max(1, terms)
            assert not plan["a_in_smem"] and plan["smem_bytes"] == state
        else:
            assert plan["list_slots"] == 0
            a_bytes = 4 * c * n * n
            assert plan["a_in_smem"] == (not plan["registers"] and state
                                         + a_bytes <= SMEM_OPTIN_BYTES)
            assert plan["smem_bytes"] == state + (
                a_bytes if plan["a_in_smem"] else 0)


@pytest.mark.parametrize("b,n,c,terms,want", [
    # Phase 3, FC8 x 4096: 4 draws per warp, 4 warps per CTA, the dense
    # loop (7 of 8 terms) with its 8 terms in registers.
    (4096, 8, 1, 7, dict(path="warp", aggregation="dense", registers=True,
                         draws_per_cta=16, ctas=256, threads=128,
                         a_in_smem=False)),
    # FC8 with the spool (two classes): 7 of 16 terms, row lists.
    (64, 8, 2, 7, dict(path="warp", aggregation="lists", registers=True,
                       draws_per_cta=4, ctas=16, threads=32, list_slots=7)),
    # Phase 4, torus3d(6) x 256: row lists, 3,460 bytes per CTA.
    (256, 216, 1, 6, dict(path="block", aggregation="lists",
                          registers=True, draws_per_cta=1, ctas=256,
                          threads=216, list_slots=6, smem_bytes=3_460)),
    # fully_connected(16) with two classes: rows of 15 terms, too long for
    # registers, so the warp path's dense loop, A in shared memory.
    (64, 16, 2, 15, dict(path="warp", aggregation="dense", registers=False,
                         a_in_smem=True, list_slots=0)),
    # A degree-12 graph of 216 nodes: the block path's dense loop.
    (256, 216, 1, 12, dict(path="block", aggregation="dense",
                           registers=False, a_in_smem=True, list_slots=0)),
    # Phase 7's guarded torus forced fused, torus3d(8) x 1.
    (1, 512, 1, 6, dict(path="block", aggregation="lists", threads=512)),
    # fully_connected(64): the dense loop, A in shared memory.
    (16, 64, 1, 63, dict(path="block", aggregation="dense",
                         registers=False, a_in_smem=True, threads=64))])
def test_fused_plan_at_the_main_paths_shapes(b, n, c, terms, want):
    plan = fused_plan(b, n, c, terms, H100_SMS, SMEM_OPTIN_BYTES)
    assert {key: plan[key] for key in want} == want, plan


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
