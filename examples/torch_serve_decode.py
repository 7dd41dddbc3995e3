"""Serving on the PyTorch port: batched prefill + autoregressive decode
with KV caches (``examples/serve_decode.py`` on ``repro_torch``).

Runs a reduced config on the CUDA card (``--device cpu`` on the CPU);
the same eager ``ModelZoo.prefill`` / ``decode`` pair is what the
decode_32k / long_500k dry-run cells trace at production scale.  The
weights are float32 from a ``torch.Generator`` seeded 0 (the reference
seeds ``PRNGKey(0)``: the same law, not the same bits).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch mamba2-370m

`--smoke` shrinks batch/prompt/new-tokens to a seconds-scale config.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import device_name, resolve_device
from repro_torch.configs import get_config
from repro_torch.models import ModelZoo, materialize, widen_caches


def init_params(zoo, device):
    """The example's weights: float32, from a CPU generator seeded 0."""
    return materialize(zoo.param_defs(), torch.Generator().manual_seed(0),
                       torch.float32, device=device)


def greedy(logits):
    """The last position's argmax as a (batch, 1) int32 token column."""
    return logits[:, -1, :].argmax(dim=-1)[:, None].to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny batch/prompt/decode for CI")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch, args.prompt_len, args.new_tokens = 2, 8, 4
    dev = resolve_device(args.device)
    print(f"device: {device_name(dev)}")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    cfg = get_config(args.arch).reduced()
    zoo = ModelZoo(cfg)
    params = init_params(zoo, dev)
    rng = np.random.default_rng(0)

    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(0, 1, (args.batch, cfg.num_patch_tokens, cfg.d_model)),
            device=dev).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.as_tensor(
            rng.normal(0, 1, (args.batch, args.prompt_len, cfg.d_model)),
            device=dev).to(torch.bfloat16)

    with torch.inference_mode():
        t0 = time.time()
        logits, caches = zoo.prefill(params, batch)
        sync()
        prefill_ms = (time.time() - t0) * 1e3
        print(f"[prefill] {args.batch} x {args.prompt_len} tokens in "
              f"{prefill_ms:.0f} ms (eager, first call)")

        tok = greedy(logits)
        generated = [tok]
        t0 = time.time()
        for i in range(args.new_tokens - 1):
            # grow each attention cache by one slot per generated token
            caches = widen_caches(caches)
            logits, caches = zoo.decode(params, caches, {"tokens": tok})
            tok = greedy(logits)
            generated.append(tok)
        sync()
        dt = time.time() - t0
    out = torch.cat(generated, dim=1).cpu().numpy()
    print(f"[decode] {args.new_tokens} tokens x {args.batch} seqs in "
          f"{dt*1e3:.0f} ms ({args.new_tokens*args.batch/max(dt,1e-9):.0f} tok/s)")
    print("[decode] sample:", out[0][:16], "...")
    return out


if __name__ == "__main__":
    main()
