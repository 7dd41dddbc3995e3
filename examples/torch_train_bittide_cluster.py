"""End-to-end program on the PyTorch port: train an LM on a simulated
bittide cluster (``examples/train_bittide_cluster.py`` on
``repro_torch``).

Pipeline: bittide sync (phase 1) -> AOT communication schedule from the
logical synchrony network -> data-parallel training with checkpoints +
restart + straggler pacing telemetry.  Defaults train a ~135M-param
smollm-135m for a few hundred steps on the CUDA card; `--tiny` runs a
seconds-scale config.  The weights are float32 from a ``torch.Generator``
seeded 0 and the batches come from the port's synthetic stream (the
reference's law, not its bits).

    PYTHONPATH=src python examples/torch_train_bittide_cluster.py --tiny
    PYTHONPATH=src python examples/torch_train_bittide_cluster.py \
        --arch smollm-135m --steps 300        # the full ~100M-model run
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import device_name, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import (ControllerConfig, SimConfig, mesh2d)
from repro_torch.core.network import BittideNetwork, OscillatorSpec
from repro_torch.core.schedule import (ring_allreduce_schedule,
                                       verify_bounded)
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.ft import simulate_stragglers
from repro_torch.launch import value_and_grad
from repro_torch.models import ModelZoo, materialize
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def init_params(zoo, device):
    """The example's weights: float32, from a CPU generator seeded 0."""
    return materialize(zoo.param_defs(), torch.Generator().manual_seed(0),
                       torch.float32, device=device)


def make_pipeline(cfg, seq: int, batch: int):
    """The example's batches: the synthetic stream, seed 0."""
    return SyntheticPipeline(DataConfig(cfg.vocab_size, seq, batch, seed=0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (seconds on CPU)")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_example")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")

    # ---- phase 1: bring the cluster into logical synchrony --------------
    topo = mesh2d(4, 4)  # 16 "nodes" on a pod-like 2-D torus fabric
    net = BittideNetwork.build(topo, cable_m=2.0,
                               osc=OscillatorSpec(initial_ppm=8.0, seed=0),
                               device=dev)
    sync = net.sync(ctrl=ControllerConfig(kind="discrete", kp=4e-8, fs=1e-7,
                                          pulses_per_update=50),
                    cfg=SimConfig(dt=5e-5, steps=24_000, record_every=40,
                                  quantize_beta=True))
    assert sync.converged, "bittide sync failed"
    print(f"[bittide] synced 16 nodes in {sync.convergence_time_s*1e3:.0f} ms "
          f"(spread {sync.freq_spread_ppm:.3f} ppm)")

    # AOT-schedule the gradient all-reduce ring on the synchronized fabric.
    ring_order = [0, 1, 2, 3, 7, 6, 5, 4, 8, 9, 10, 11, 15, 14, 13, 12]
    sched = ring_allreduce_schedule(sync.lsn, ring_order, chunk_frames=256,
                                    combine_ticks=32)
    assert verify_bounded(sched, sync.lsn, depth_frames=4096)
    print(f"[bittide] AOT ring all-reduce: {len(sched.events)} transfers, "
          f"makespan {sched.makespan_ticks} localticks, zero handshakes")

    # Straggler pacing: bound queues under ±2% node-speed spread.
    rep = simulate_stragglers(topo, np.random.default_rng(1).uniform(
        -20_000, 20_000, topo.num_nodes), duration_s=1000.0, device=dev)
    print(f"[bittide] straggler pacing: queue peak {rep.controlled_queue_peak:.1f} "
          f"steps (uncontrolled {rep.uncontrolled_queue_peak:.0f}), "
          f"throughput x{rep.throughput_ratio:.4f}")
    out = dict(converged=sync.converged,
               convergence_time_s=sync.convergence_time_s,
               freq_spread_ppm=sync.freq_spread_ppm,
               sync_freq_ppm=sync.sim.freq_ppm, sync_times=sync.sim.times,
               ring_transfers=len(sched.events),
               ring_makespan_ticks=sched.makespan_ticks,
               straggler_queue_peak=rep.controlled_queue_peak,
               straggler_uncontrolled_peak=rep.uncontrolled_queue_peak,
               straggler_throughput_ratio=rep.throughput_ratio)

    # ---- phase 2: train the model on the synchronized cluster -----------
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.reduced()
        args.steps = min(args.steps, 60)
    zoo = ModelZoo(cfg)
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    params = init_params(zoo, dev)
    opt = AdamWConfig(lr=3e-3, weight_decay=0.01)
    opt_state = adamw_init(params, opt)
    data = make_pipeline(cfg, args.seq, args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    if args.resume:
        got = mgr.restore_latest({"params": params, "opt": opt_state},
                                 device=dev)
        if got[0] is not None:
            start = got[0]
            params, opt_state = got[1]["params"], got[1]["opt"]
            print(f"[train] resumed from step {start}")

    loss_and_grads = value_and_grad(zoo.train_loss)

    def step_fn(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt)
        return params, opt_state, loss, gnorm

    t0 = time.time()
    first_loss = None
    losses, norms = {}, {}
    for step in range(start, args.steps):
        params, opt_state, loss, gnorm = step_fn(params, opt_state,
                                                 data.batch(step, device=dev))
        losses[step] = float(loss)
        if first_loss is None:
            first_loss = losses[step]
        if step % 20 == 0 or step == args.steps - 1:
            norms[step] = float(gnorm)
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"[train] step {step:4d} loss {float(loss):7.4f} "
                  f"gnorm {float(gnorm):8.3f} tok/s {tok_s:9.0f}")
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     blocking=False)
    mgr.save(args.steps, {"params": params, "opt": opt_state})
    print(f"[train] done: loss {first_loss:.4f} -> {float(loss):.4f} "
          f"(ln V = {np.log(cfg.vocab_size):.3f}); checkpoint at "
          f"{args.ckpt_dir}/step_{args.steps:09d}")
    out.update(arch=cfg.name, params=cfg.param_count(), start=start,
               steps=args.steps, losses=losses, grad_norms=norms,
               first_loss=first_loss, last_loss=float(loss),
               ln_vocab=float(np.log(cfg.vocab_size)),
               checkpoint=f"{args.ckpt_dir}/step_{args.steps:09d}")
    return out


if __name__ == "__main__":
    main()
