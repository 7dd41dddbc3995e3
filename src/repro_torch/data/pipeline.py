"""Deterministic, stateless synthetic LM data (port of
``repro.data.pipeline``).

A batch is a pure function of (seed, step): resume-after-restart needs
no data state beyond the step counter.  The stream is a noisy affine
Markov chain over the vocabulary, so models can learn it:

    t_{i+1} = (a * t_i + b) mod V     with prob (1 - noise)
              uniform(V)              otherwise

The draws come from a CPU ``torch.Generator`` seeded from (seed, step),
so the card and the CPU get the same tokens; they are not
``jax.random``'s threefry bits, so the reference's batches are carried
across as numpy arrays where two packages must see the same data.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["DataConfig", "SyntheticPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.2
    mult: int = 17
    offset: int = 31


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        # one generator per (seed, step); the CPU generator keeps 32 bits
        # of its seed, so the pair is hashed into them
        gen = torch.Generator().manual_seed(int(np.random.SeedSequence(
            (c.seed, int(step))).generate_state(1)[0]))
        b, s = c.global_batch, c.seq_len
        tok = torch.randint(0, c.vocab_size, (b,), generator=gen)
        take_rand = torch.rand((s, b), generator=gen) < c.noise
        rand = torch.randint(0, c.vocab_size, (s, b), generator=gen)
        seq = [tok]
        for i in range(s):
            tok = torch.where(take_rand[i], rand[i],
                              (tok * c.mult + c.offset) % c.vocab_size)
            seq.append(tok)
        seq = torch.stack(seq, dim=1).to(torch.int32)    # (B, S+1)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` (int32 ``tokens`` / ``labels``, (B, S)) on
        ``device``; None means the CUDA card (raises without one)."""
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in self._make_batch(step).items()}

    def batch_numpy(self, step: int) -> Dict[str, np.ndarray]:
        return {k: v.numpy() for k, v in self._make_batch(step).items()}
