"""Domain Difference Counters (paper §4.2), bit-faithful, on tensors.

Port of ``repro.core.ddc``.  The hardware counts frames-in (clk_rx
domain) and frames-out (clk_tx domain) with wrapping counters, crosses
domains via Gray code, extends to 64 bits, subtracts, and truncates the
difference to a signed 32-bit occupancy with 0 = half-full.

The 64-bit counters are (hi, lo) pairs of 32-bit words, as in the
reference.  torch's ``uint32`` supports few operations, so each word is
an int64 tensor holding the uint32 value: every result is masked with
``0xFFFFFFFF``, which gives the uint32 wraparound, carries and borrows
bit for bit.  The truncated 32-bit difference is exact as long as the
true difference stays within ±2^31 (±24 h of 98 ppm drift at 125 MHz).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "U64",
    "u64", "u64_add", "u64_sub", "u64_inc", "u64_to_int",
    "gray_encode", "gray_decode",
    "occupancy_s32", "Ddc", "ddc_init", "ddc_step",
]

U64 = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo) uint32 words in int64
_MASK = 0xFFFFFFFF


def _word(x, like: torch.Tensor = None) -> torch.Tensor:
    """A uint32 word (or array of words) as an int64 tensor."""
    if isinstance(x, torch.Tensor):
        t = x.to(torch.int64)
    else:
        t = torch.as_tensor(np.asarray(x).astype(np.int64))
    if like is not None:
        t = t.to(like.device)
    return t & _MASK


def u64(value: int, *, device=None) -> U64:
    """A 64-bit counter value as its (hi, lo) words on ``device`` (None
    means the CUDA card)."""
    dev = resolve_device(device)
    value &= (1 << 64) - 1
    word = lambda w: torch.tensor(w, dtype=torch.int64, device=dev)
    return word(value >> 32), word(value & _MASK)


def u64_add(a: U64, b: U64) -> U64:
    lo = (a[1] + b[1]) & _MASK
    carry = (lo < a[1]).to(torch.int64)
    return (a[0] + b[0] + carry) & _MASK, lo


def u64_inc(a: U64, n) -> U64:
    """a + n for small non-negative uint32 n (vectorized ok)."""
    n = _word(n, a[1])
    lo = (a[1] + n) & _MASK
    carry = (lo < a[1]).to(torch.int64)
    return (a[0] + carry) & _MASK, lo


def u64_sub(a: U64, b: U64) -> U64:
    lo = (a[1] - b[1]) & _MASK
    borrow = (a[1] < b[1]).to(torch.int64)
    return (a[0] - b[0] - borrow) & _MASK, lo


def u64_to_int(a: U64) -> int:
    """Host-side readback (for tests)."""
    return (int(a[0]) << 32) | int(a[1])


def gray_encode(x) -> torch.Tensor:
    """Binary-reflected Gray code of a uint32 word (per-word, as in the
    hardware where each counter word crosses the domain independently)."""
    x = _word(x)
    return x ^ (x >> 1)


def gray_decode(g) -> torch.Tensor:
    x = _word(g)
    for shift in (1, 2, 4, 8, 16):
        x = x ^ (x >> shift)
    return x


def occupancy_s32(rx: U64, tx: U64) -> torch.Tensor:
    """Signed-32 occupancy = trunc32(rx − tx), 0 == half-full.

    Matches the hardware: 64-bit subtract, truncate to the low 32 bits,
    reinterpret as signed.  Exact while |rx − tx| < 2^31.
    """
    lo = u64_sub(rx, tx)[1]
    return torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)


# -- A functional model of the DDC block (Fig 5): two wrapping counters     --
# -- updated at their own rates, occupancy sampled in the controller domain.--

def ddc_init(num: int, *, device=None):
    """Zeroed counters for ``num`` links on ``device`` (None means the
    CUDA card)."""
    z = torch.zeros((num,), dtype=torch.int64, device=resolve_device(device))
    return {"rx_hi": z, "rx_lo": z, "tx_hi": z, "tx_lo": z}


def ddc_step(state, rx_frames, tx_frames):
    """Advance rx/tx counters by per-link frame counts; return occupancy.

    rx_frames/tx_frames: (num,) uint32 frames observed this sample period.
    The Gray encode/decode round-trip is applied to the synchronized words to
    model the CDC path (it is the identity on values; its correctness under
    single-bit increments is what the hardware relies on and what the
    property tests check).
    """
    rx = (state["rx_hi"], state["rx_lo"])
    tx = (state["tx_hi"], state["tx_lo"])
    rx = u64_inc(rx, rx_frames)
    tx = u64_inc(tx, tx_frames)
    # CDC: counters cross into the control domain via gray code.
    rx_sync = (gray_decode(gray_encode(rx[0])), gray_decode(gray_encode(rx[1])))
    tx_sync = (gray_decode(gray_encode(tx[0])), gray_decode(gray_encode(tx[1])))
    occ = occupancy_s32(rx_sync, tx_sync)
    new = {"rx_hi": rx[0], "rx_lo": rx[1], "tx_hi": tx[0], "tx_lo": tx[1]}
    return new, occ


class Ddc:
    """Convenience object wrapper used by examples."""

    def __init__(self, num: int, *, device=None):
        self.state = ddc_init(num, device=device)

    def step(self, rx_frames, tx_frames):
        self.state, occ = ddc_step(self.state, rx_frames, tx_frames)
        return occ
