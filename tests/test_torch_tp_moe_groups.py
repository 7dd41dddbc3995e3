"""The MoE block's token groups on a batch split over data ranks, on a
gloo CPU world of 2 ranks as (2 data, 1 model) (``tests/torch_gloo.py``).

The reference groups the tokens of the **global** batch
(``repro.models.moe.moe_apply``: ``gs = min(moe_group_size, b·s)``,
capacity ``ceil(cf·gs·k/E)``, slots by the (token, choice) cumsum over
the group), traced at global shapes and partitioned by GSPMD: the plain
call on the whole batch is what it computes.  The port's mesh steps run
the model on each data rank's slice of the batch, so a group that spans
data ranks takes its size and capacity from the global token count and
offsets each rank's slot positions by the counts per expert of the
ranks before it (``models.moe``, ``models.parallel.BatchSplit``).

  * reduced qwen2-moe-a2.7b (group size 32) on a prompt batch of 4 × 8
    = 32 tokens, one group over both data ranks, and a decode step of 4
    tokens (one group of 4): ``make_prefill_step`` and
    ``make_decode_step`` on the mesh equal ``ModelZoo.prefill`` /
    ``.decode`` on the whole batch within the serving bar (``PERF.md``
    §2: logits and caches within 2e-2), where the rank-local groups of
    16 and 2 tokens (capacity 3 and 1 against the global 5 and 1, slots
    counted from 0 on every rank) part from it;
  * a train step whose group would span the data ranks raises a
    ``ValueError`` that names the cut, rather than computing the
    load-balance term on each rank's tokens.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

SERVE_TOL = 2e-2          # tests/test_torch_models_zoo.py's LOGIT_TOL

GROUPS = """
import json
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch import (init_train_state, make_decode_step,
                                make_mesh_from_devices, make_prefill_step,
                                make_train_step, widen_mesh_caches)
from repro_torch.models import ModelZoo, widen_caches

cfg = get_config("qwen2-moe-a2.7b").reduced()
assert cfg.moe_group_size == 32
mesh = make_mesh_from_devices(range(WORLD), (2, 1), ("data", "model"),
                              device_type="cpu")
p_m, o_m = init_train_state(cfg, mesh, torch.Generator().manual_seed(0))
p, _ = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                        device="cpu")
# the MoE MLPs' weights scaled up from init's std 0.02, at which the
# block's output is lost beside the residual stream at the serving bar
for tree in (p_m, p):
    for name, w in tree["layers"]["moe"].items():
        if name != "router":
            w.mul_(4.0)
zoo = ModelZoo(cfg)
rng = np.random.default_rng(11)
toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 8)),
                    dtype=torch.int32)


def excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (TOL + TOL * want.abs())).max())


with torch.no_grad():
    want_l, want_c = zoo.prefill(p, {"tokens": toks})
    got_l, got_c = make_prefill_step(cfg)(p_m, {"tokens": toks})
    out = dict(prefill_logits=excess(got_l.full_tensor(), want_l),
               prefill_cache=excess(got_c["kv"].full_tensor(),
                                    want_c["kv"]))
    tok = want_l.argmax(-1).to(torch.int32)
    want_l, want_c = zoo.decode(p, widen_caches(want_c), {"tokens": tok})
    got_l, got_c = make_decode_step(cfg)(
        p_m, widen_mesh_caches(cfg, got_c), {"tokens": tok})
    out.update(decode_logits=excess(got_l.full_tensor(), want_l),
               decode_cache=excess(got_c["kv"].full_tensor(), want_c["kv"]))
batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
try:
    make_train_step(cfg)(p_m, o_m, batch, 0)
    out["train"] = None
except ValueError as e:
    out["train"] = str(e)
if RANK == 0:
    with open(WORKDIR + "/groups.json", "w") as f:
        json.dump(out, f)
"""


def test_a_group_spanning_data_ranks_is_the_global_group(tmp_path):
    res = run_ranks(f"TOL = {SERVE_TOL}\n" + GROUPS, 2, tmp_path)
    assert_ranks_ok(res)
    r = json.loads((tmp_path / "groups.json").read_text())
    for key in ("prefill_logits", "prefill_cache", "decode_logits",
                "decode_cache"):
        assert r[key] <= 0.0, (key, r)
    assert r["train"] is not None and "spans 2 data ranks" in r["train"], r
