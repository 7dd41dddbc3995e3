"""The port's examples 1–5 against the reference's examples (CPU).

``examples/torch_{quickstart,cable_swap,auto_reframe,ensemble_sweep,
scale_torus}.py`` run with ``--device cpu`` (their kernels' plain
versions) beside the reference's ``examples/*.py``, which run untouched:
as scripts (``runpy``) where their ``main`` takes no argument.  Each
port example prints a device line and then the reference's lines in the
reference's order; lines that name the reference's compiler say what the
port does instead (``tests/torch_examples.py``).

Tolerances: integers (RTTs, logical latencies, engine calls, splices,
pointer shifts, node and edge counts) exactly; every other printed
number within one unit of the reference's last printed digit; ν records
that both packages return (``sync_torus``, proportional control at kp =
2e-8 over 6,000 periods) at ``FREQ_ATOL_PPM`` or the float32 floor of
``ROADMAP.md`` §3 at that gain (``chip_smoke.float32_floor_ppm``:
XLA's fused multiply-adds hold ψ apart by ulps, and ν follows through
kp), whichever is larger, as ``tests/test_torch_network.py`` holds the
cable swap.  Wall
times are never compared.  Where the reference's ``main`` is too slow
on the CPU (``scale_torus``: k = 22 and a 10⁶-node run), the test calls
its named functions in both packages at small k.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from engine_harness import FREQ_ATOL_PPM, assert_freq_parity  # noqa: E402
from torch_examples import (assert_printed, assert_same_lines,  # noqa: E402
                            one_torch_thread,
                            chip_smoke, load, numbers, run_port, run_script)

WALL = (r"[\d.]+ s wall", r"wall=\s*[\d.]+s")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_quickstart_matches_the_reference():
    got, lines = run_port("quickstart", [])
    ref = run_script("quickstart", [])
    assert_same_lines(lines, ref)
    assert got["converged"] and ref[1].startswith("converged: True")
    ms = numbers(ref[1])
    assert_printed(got["convergence_time_s"] * 1e3, ms[0], "convergence")
    assert_printed(got["freq_spread_ppm"], ms[1], "spread")
    np.testing.assert_allclose(got["ppm_u"], np.asarray(
        numbers(ref[0]), float), rtol=0, atol=0.005 + 1e-9)
    rows = {int(m.group(1)): [int(x) for x in m.group(2).split(",")]
            for m in (re.match(r"\s+node (\d+): \[(.*)\]", ln) for ln in ref)
            if m}
    assert got["rtt_table"] == rows and len(rows) == 8
    lam = int(re.search(r"0->1 = (\d+) localticks", "\n".join(ref)).group(1))
    assert got["latency_0_1"] == lam


@pytest.fixture(scope="module")
def cable_swap_reference():
    """The reference's cable swap at its smoke length, by engine (run
    once per engine)."""
    cache = {}

    def run(engine):
        if engine not in cache:
            cache[engine] = run_script(
                "cable_swap", ["--smoke", "--no-plot", "--engine", engine])
        return cache[engine]
    return run


@pytest.mark.parametrize("engine", ["auto", "segment-sum", "fused", "tiled",
                                    "per-step"])
def test_cable_swap_matches_the_reference(engine, cable_swap_reference):
    """Each ``--engine`` of the port against the reference's run on the
    same lane (``auto`` and ``segment-sum``), or, for the dense lanes the
    reference runs only in interpret mode (``fused``, ``tiled``,
    ``per-step``), against its ``auto`` run: the fused lane on FC8, whose
    printed numbers every dense lane must give."""
    got, lines = run_port("cable_swap", ["--smoke", "--no-plot",
                                         "--engine", engine])
    ref = cable_swap_reference(engine if engine in ("auto", "segment-sum")
                               else "auto")
    assert_same_lines(lines, ref, reworded={0})
    m = re.match(r"engine: (\S+) \((\d+) kernel launches, chunk=(\d+)", ref[0])
    want_engine = engine if engine not in ("auto",) else m.group(1)
    assert got["engine"] == want_engine
    assert lines[0].startswith(f"engine: {want_engine} (")
    assert got["num_launches"] == int(m.group(2))
    assert got["chunk_records"] == int(m.group(3))
    # the counters' growth: segment-sum runs, and no kernel on the CPU
    assert got["launches"] == ({"segment-sum": got["num_launches"]}
                               if engine == "segment-sum" else {})
    before, after = (int(x) for x in numbers(ref[2]))
    assert (got["rtt_before"], got["rtt_after"]) == (before, after)
    assert got["rtt_shift"] == int(numbers(ref[3])[0]) == after - before
    assert got["other_shift"] == int(numbers(ref[4])[0]) == 0
    assert abs(got["rtt_shift"] - 1231) <= 3
    band = numbers(ref[5])
    assert_printed(got["band_before"], band[0], "band before")
    assert_printed(got["band_after"], band[1], "band after")


def test_auto_reframe_matches_the_reference():
    got, lines = run_port("auto_reframe", ["--smoke", "--no-plot"])
    ref = run_script("auto_reframe", ["--smoke", "--no-plot"])
    assert_same_lines(lines, ref, reworded={0})
    m = re.match(r"engine: (\S+) \((\d+) launches, (\d+) reframe splices",
                 ref[0])
    assert got["engine"] == m.group(1) == "fused"
    assert got["num_launches"] == int(m.group(2))
    assert got["reframes"] == int(m.group(3)) > 0
    assert got["builds"] == 0       # no kernel is built on the CPU
    assert_printed(got["worst_plain"], numbers(ref[1])[0], "no reframing")
    assert_printed(got["worst_reframed"], numbers(ref[2])[0], "reframing")
    assert got["worst_plain"] > 16 > got["worst_reframed"]
    assert got["max_shift"] == int(numbers(ref[3])[0])
    assert got["rtt_residual"] == int(numbers(ref[3])[1]) == 0
    assert got["rtt_shift"] == int(numbers(ref[4])[0])


def test_ensemble_sweep_matches_the_reference():
    got, lines = run_port("ensemble_sweep", ["--draws", "4"])
    ref = run_script("ensemble_sweep", ["--draws", "4"])
    assert_same_lines(lines, ref, reworded={1, 2, 4, 6, 11})
    for i, name in ((1, "fully_connected_8"), (2, "cube")):
        assert lines[i].split(":")[0] == ref[i].split(":")[0]
        row, want = got["distribution"][name], numbers(ref[i])
        assert_printed(row["p50"] * 1e3, want[0], f"{name} p50")
        assert_printed(row["p95"] * 1e3, want[1], f"{name} p95")
        assert_printed(row["worst_band"], want[2], f"{name} band")
        assert "segment-sum runs: 1," in lines[i]
    dense, want = got["dense"], numbers(ref[4])
    assert dense["engine"] == "fused" and lines[4].startswith("fused kernel")
    assert_printed(dense["band_min"], want[-2], "dense band min")
    assert_printed(dense["band_max"], want[-1], "dense band max")
    assert "segment-sum runs: 1," in lines[11]
    # the named function of both packages (cube, 4 draws), spreads at the
    # float32 floor of kp = 2e-8
    import repro.core as rc
    import repro_torch.core as tc
    port = load("torch_ensemble_sweep")
    want, want_spread, _ = load("ensemble_sweep").convergence_distribution(
        rc.cube(), 4)
    conv, spread, _ = port.convergence_distribution(tc.cube(), 4,
                                                    device="cpu")
    ens, _ = port.ensemble_run(tc.cube(), 4, device="cpu")
    np.testing.assert_array_equal(ens.final_spread_ppm, spread)
    floor = chip_smoke().float32_floor_ppm(2e-8, 3,
                                           float(np.abs(ens.psi).max()))
    np.testing.assert_array_equal(conv, np.asarray(want))
    np.testing.assert_allclose(spread, np.asarray(want_spread), rtol=0,
                               atol=2 * max(FREQ_ATOL_PPM, floor))


def test_scale_torus_sync_matches_the_reference():
    """``sync_torus`` in both packages at k = 6 and 10 (the reference's
    ``main`` runs k = 22 and 10⁶ nodes), and the port's ``main`` at
    ``--k 6 --no-watermarks``, whose rows are those runs."""
    ref_mod = load("scale_torus")
    got, lines = run_port("scale_torus", ["--k", "6", "--no-watermarks"])
    assert [r["k"] for r in got["tori"]] == [6, 10, 14, 6]
    assert len(lines) == 6 and lines[4] == ""
    for row in got["tori"][:2]:
        topo, want, _ = ref_mod.sync_torus(row["k"])
        floor = chip_smoke().float32_floor_ppm(2e-8, 6, row["psi_abs_max"])
        bar = max(FREQ_ATOL_PPM, floor)
        assert_freq_parity(row["freq_ppm"], np.asarray(want.freq_ppm),
                           atol=bar)
        assert (row["nodes"], row["edges"]) == (topo.num_nodes,
                                                topo.num_edges)
        assert row["conv_s"] == want.convergence_time(1.0)
        assert abs(row["band_ppm"] - float(np.ptp(want.freq_ppm[-1]))) \
            <= 2 * bar
        assert row["lambda2"] == 2 - 2 * np.cos(2 * np.pi / row["k"])


def test_scale_torus_watermark_health_matches_the_reference(capsys):
    """``watermark_health`` on the sparse lane in both packages at k = 5
    (125 nodes; the reference's Pallas kernel in interpret mode): the
    same header and health report."""
    ref_mod = load("scale_torus")
    ref_mod.watermark_health(k=5)
    ref = capsys.readouterr().out.splitlines()
    got = load("torch_scale_torus").watermark_health(k=5, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert got["engine"] == "sparse" and got["nodes"] == 125
    assert_same_lines(lines, ref, masks=WALL)
    assert got["report"].splitlines() == lines[2:]
