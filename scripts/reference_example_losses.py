#!/usr/bin/env python3
"""The JAX reference's losses on examples/train_bittide_cluster.py's
training loop at full width, fed the port's synthetic batches.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_example_losses.py \\
        [--arch smollm-135m] [--steps 41] [--batch 8] [--seq 256]

The example's step as it stands (``repro.models.materialize`` from
``PRNGKey(0)``, AdamW(lr 3e-3, weight decay 0.01), ``adamw_update``
without ``lr_scale``: a constant learning rate, no warm-up), jitted on
the CPU, on the batches of the port's
``SyntheticPipeline(DataConfig(V, seq, batch, seed=0))`` carried across
as numpy: the stream the port's ``chip_smoke.py`` phase 13 trains on.
Prints one JSON line: the loss and gradient norm of every step.  The
JAX package and the port are both imported; jax runs on the CPU (about
10 s per step for smollm-135m at 8 x 256 on 8 cores, a few GB of
memory).
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import ModelZoo
from repro.models.layers import materialize
from repro.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.data import DataConfig, SyntheticPipeline


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=41)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    zoo = ModelZoo(cfg)
    params = materialize(zoo.param_defs(), jax.random.PRNGKey(0),
                         jnp.float32)
    opt = AdamWConfig(lr=3e-3, weight_decay=0.01)
    opt_state = adamw_init(params, opt)
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, args.seq,
                                        args.batch, seed=0))

    @jax.jit
    def step_fn(params, opt_state, batch):
        loss, grads = jax.value_and_grad(zoo.train_loss)(params, batch)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt)
        return params, opt_state, loss, gnorm

    losses, norms = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: jnp.asarray(v.numpy()) for k, v in
                 data.batch(step, device="cpu").items()}
        params, opt_state, loss, gnorm = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        norms.append(float(gnorm))
    print(json.dumps(dict(
        arch=args.arch, batch=args.batch, seq=args.seq, steps=args.steps,
        lr=opt.lr, weight_decay=opt.weight_decay, schedule="constant",
        backend=jax.default_backend(), losses=losses, grad_norms=norms,
        wall_s=time.perf_counter() - t0)))


if __name__ == "__main__":
    main()
