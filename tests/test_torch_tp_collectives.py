"""The collectives of ``models.parallel`` with their gradients, and the
vocabulary-parallel loss, on gloo CPU worlds (``tests/torch_gloo.py``).

  * each collective pair (identity forward / all-reduce backward with
    all-reduce forward / identity backward; the all-gather along a
    dimension; the vocabulary-parallel logsumexp; the gold logit from the
    rank that owns it) under ``torch.autograd.gradcheck`` in float64 on 2
    ranks.  The checked functions take inputs that are the same on every
    rank and return outputs that are the same on every rank — what the
    split layers hand each other — with rank-dependent weights inside,
    so that the numerical Jacobian, perturbing the same element on every
    rank at once, is the Jacobian of the whole computation;
  * ``chunked_xent`` on a head split on the vocabulary (4 ranks, the pad
    classes past ``valid_vocab`` on the last rank) and on a tied head
    split on d (2 ranks), under its per-chunk checkpoint, against the
    plain ``chunked_xent`` on the whole head: the loss within float32
    rounding, the gradients of the hidden states and of each rank's
    shard of the head within rtol / atol 1e-5.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

GRADCHECK = """
import json
from torch.autograd import gradcheck
from repro_torch.models.parallel import (TensorParallel, copy_to_model,
                                         gather_from_model,
                                         reduce_from_model, vocab_gold,
                                         vocab_logsumexp)
tp = TensorParallel(dist.group.WORLD, WORLD, RANK, attn="split", mlp=True,
                    embed=True, head="vocab")
gen = torch.Generator().manual_seed(0)
x = torch.randn(3, 4, dtype=torch.float64, generator=gen,
                requires_grad=True)
w = torch.randn(WORLD, 4, 6, dtype=torch.float64, generator=gen)[RANK]
logits = torch.randn(2, 3, 8 * WORLD, dtype=torch.float64, generator=gen,
                     requires_grad=True)
labels = torch.randint(0, 8 * WORLD, (2, 3), generator=gen)
n = logits.shape[-1] // WORLD


def pair(x):
    # f then g: x @ (sum over ranks of w)
    return reduce_from_model(copy_to_model(x, tp) @ w, tp)


def gather(x):
    # each rank scales its columns of x, the columns gathered back
    mine = copy_to_model(x, tp).narrow(-1, RANK * 2, 2) * (RANK + 2.0)
    return gather_from_model(mine, -1, tp)


def lse(z):
    return vocab_logsumexp(copy_to_model(z, tp).narrow(-1, RANK * n, n), tp)


def gold(z):
    return vocab_gold(copy_to_model(z, tp).narrow(-1, RANK * n, n), labels,
                      RANK * n, tp)


out = {}
for name, fn, arg in (("pair", pair, x), ("gather", gather, x),
                      ("lse", lse, logits), ("gold", gold, logits)):
    out[name] = bool(gradcheck(fn, (arg,), eps=1e-6, atol=1e-7, rtol=1e-5))
with torch.no_grad():
    whole_w = [torch.zeros_like(w) for _ in range(WORLD)]
    dist.all_gather(whole_w, w)
    out["pair_value"] = bool(torch.allclose(pair(x), x @ sum(whole_w)))
    scale = torch.arange(WORLD, dtype=torch.float64).repeat_interleave(2) + 2
    out["gather_value"] = bool(torch.allclose(gather(x), x * scale))
    out["lse_value"] = bool(torch.allclose(lse(logits),
                                           torch.logsumexp(logits, -1)))
    out["gold_value"] = bool(torch.equal(
        gold(logits), torch.gather(logits, -1, labels[..., None])[..., 0]))
if RANK == 0:
    with open(WORKDIR + "/gradcheck.json", "w") as f:
        json.dump(out, f)
"""


def test_collective_pairs_pass_gradcheck_on_two_ranks(tmp_path):
    res = run_ranks(GRADCHECK, 2, tmp_path)
    assert_ranks_ok(res)
    out = json.loads((tmp_path / "gradcheck.json").read_text())
    assert out == {k: True for k in out} and len(out) == 8, out


LOSS = """
import json
from repro_torch.models.losses import chunked_xent
from repro_torch.models.parallel import TensorParallel
tp = TensorParallel(dist.group.WORLD, WORLD, RANK, attn="split", mlp=True,
                    embed=True, head=HEAD)
gen = torch.Generator().manual_seed(1)
B, S, D, V, VALID, CHUNK = 2, 64, 32, 256, 250, 16
hidden = torch.randn(B, S, D, generator=gen)
head = torch.randn(D, V, generator=gen) * 0.3
labels = torch.randint(0, VALID, (B, S), generator=gen)


def run(h, w, tp_):
    h = h.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    loss = chunked_xent(h, w, labels, CHUNK, valid_vocab=VALID, tp=tp_)
    gh, gw = torch.autograd.grad(loss, (h, w))
    return loss, gh, gw


want, want_gh, want_gw = run(hidden, head, None)
if HEAD == "vocab":
    n = V // WORLD
    got, gh, gw = run(hidden, head[:, RANK * n:(RANK + 1) * n], tp)
    want_gw = want_gw[:, RANK * n:(RANK + 1) * n]
else:
    n = D // WORLD
    got, gh, gw = run(hidden, head[RANK * n:(RANK + 1) * n], tp)
    want_gw = want_gw[RANK * n:(RANK + 1) * n]
close = lambda a, b: bool(torch.allclose(a.float(), b.float(), rtol=1e-5,
                                         atol=1e-5))
out = dict(loss_diff=abs(float(got) - float(want)), loss=float(want),
           hidden_grad=close(gh, want_gh), head_grad=close(gw, want_gw))
with open(WORKDIR + f"/loss{RANK}.json", "w") as f:
    json.dump(out, f)
"""


@pytest.mark.parametrize("head,world", [("vocab", 4), ("rows", 2)])
def test_vocab_parallel_loss_matches_chunked_xent(tmp_path, head, world):
    res = run_ranks(f"HEAD = {head!r}\n" + LOSS, world, tmp_path)
    assert_ranks_ok(res)
    for r in range(world):
        out = json.loads((tmp_path / f"loss{r}.json").read_text())
        # the same f32 loss up to the order of its sums
        assert out["loss_diff"] <= 4 * 2.0 ** -23 * out["loss"], out
        assert out["hidden_grad"] and out["head_grad"], (r, out)
