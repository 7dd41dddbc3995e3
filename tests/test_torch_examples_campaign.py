"""The port's examples 6–7 against the reference's examples (CPU).

``examples/torch_chaos_campaign.py`` and ``examples/torch_serve_bittide.py``
run with ``--device cpu`` at the reference's ``--smoke`` form beside the
reference's examples, which run untouched (``chaos_campaign.py`` as a
script, ``serve_bittide.main(argv)``, which returns its serve results).

Tolerances: verdicts, verdict counts, the shrunk draw, request and token
counts, engine calls, completed requests, generated tokens, ticks and
queue peaks exactly; every other printed number within one unit of the
reference's last printed digit (``tests/torch_examples.py``).  Wall
times are never compared.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_examples import (assert_printed, assert_same_lines,  # noqa: E402
                            one_torch_thread,
                            load, numbers, run_main, run_port, run_script)

from repro_torch.scenarios import (VERDICT_ENVELOPE,  # noqa: E402
                                   VERDICT_OVERFLOW, VERDICT_PASS,
                                   VERDICT_RESCUED)

ORDER = (VERDICT_PASS, VERDICT_RESCUED, VERDICT_ENVELOPE, VERDICT_OVERFLOW)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def test_chaos_campaign_matches_the_reference():
    got, lines = run_port("chaos_campaign", ["--smoke", "--no-plot"])
    ref = run_script("chaos_campaign", ["--smoke", "--no-plot"])
    assert_same_lines(lines, ref)
    head = re.match(r"chaos campaign 'smoke': (\d+) draws, engine=(\S+), "
                    r"(\d+) launches", ref[0])
    assert got["draws"] == int(head.group(1)) == 24
    assert got["engine"] == head.group(2) == "segment-sum"
    assert got["num_launches"] == int(head.group(3))
    counts = {m.group(1): int(m.group(2)) for m in (
        re.match(r"\s+(\S+)\s+(\d+)\s+\(", ln) for ln in ref[1:5]) if m}
    assert got["counts"] == counts and list(counts) == list(ORDER)
    assert sum(counts.values()) == 24
    assert (got["verdicts"] == VERDICT_OVERFLOW).sum() \
        == counts[VERDICT_OVERFLOW]
    worst = re.search(r"worst draw #(\d+): (\S+),", ref[5])
    assert got["shrunk_draw"] == int(worst.group(1))
    assert got["shrunk_expected"] == worst.group(2)
    assert_printed(100.0 * got["survival_rate"], numbers(ref[6])[0],
                   "survival")
    shrunk = re.match(r"shrunk repro \(draw #(\d+)\): expected (\S+), "
                      r"standalone run -> (\S+) \[OK\]", ref[7])
    assert (got["shrunk_draw"], got["shrunk_expected"],
            got["shrunk_verdict"]) == (int(shrunk.group(1)), shrunk.group(2),
                                       shrunk.group(3))


def test_serve_bittide_matches_the_reference():
    got, lines = run_port("serve_bittide", ["--smoke", "--no-plot"])
    want, ref = run_main(load("serve_bittide"), ["--smoke", "--no-plot"])
    assert_same_lines(lines, ref, reworded={0})
    pacing = re.match(r"\[pacing\] (\d+) workers, (\d+) event segments, "
                      r"(\d+) launches", ref[0])
    assert lines[0].startswith(f"[pacing] {pacing.group(1)} workers, "
                               f"{pacing.group(2)} event segments, ")
    assert got["segments"] == int(pacing.group(2))
    assert got["num_launches"] == int(pacing.group(3))
    assert got["segment_sum_runs"] == got["num_launches"]
    requests, tokens = (int(x) for x in numbers(ref[1])[:2])
    assert (got["requests"], got["tokens"]) == (requests, tokens)
    assert got["claim"]
    assert list(got["results"]) == list(want)
    for d, w in want.items():
        g = got["results"][d]
        assert (g.num_requests, g.completed, g.num_ticks, g.queue_peak) == \
            (w.num_requests, w.completed, w.num_ticks, w.queue_peak), d
        np.testing.assert_array_equal(g.generated_tokens, w.generated_tokens)
        assert g.summary() == w.summary(), d
