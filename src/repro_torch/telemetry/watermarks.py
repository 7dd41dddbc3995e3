"""O(N) excursion watermarks: run health without an (R, B, N) record.

The paper's hardware instrumentation exists to show *bounded buffer
excursions* and tight frequency alignment — questions whose answers are
peaks and spreads, not trajectories.  At the sparse lane's 10⁵–10⁶-node
scale a full (R, B, N) β record is exactly what dies first, so the
engines carry these running aggregates in registers instead, updated at
every record point and emitted once at the end:

    beta_abs_max[b, i]   max over records of |β_i|      [frames]
    peak_record[b, i]    record index where that max was attained
    nu_min/max[b, i]     min / max over records of ν_i  [stored in ppm]

:class:`Watermarks` is the host-side container.  It is pure numpy (no
torch imports — the kernels hand over plain arrays), composes across the
scenario runner's chunk-replay loop via :meth:`merge` (record indices
re-based per chunk), and reduces a full β/ν record to the identical
aggregates via :meth:`from_record` — the parity contract the test
matrix pins at 1e-6.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Watermarks"]


@dataclasses.dataclass(frozen=True)
class Watermarks:
    """Per-node excursion watermarks of one run (or a merged chunk chain).

    Arrays share a trailing node axis and any leading draw axes —
    ``(N,)`` single-draw or ``(B, N)`` batched, matching the run's
    ``freq_ppm`` record minus its time axis.

    beta_abs_max: max over record points of \\|per-node net occupancy\\|,
      frames.
    peak_record: record index (0-based, int) at which ``beta_abs_max``
      was attained — ties keep the FIRST attaining record, matching
      ``np.argmax`` on the full record.
    nu_min_ppm / nu_max_ppm: per-node recorded frequency extremes, ppm.
    num_records: record points folded into these aggregates.
    """

    beta_abs_max: np.ndarray
    peak_record: np.ndarray
    nu_min_ppm: np.ndarray
    nu_max_ppm: np.ndarray
    num_records: int

    def __post_init__(self):
        for name in ("beta_abs_max", "nu_min_ppm", "nu_max_ppm"):
            object.__setattr__(self, name,
                               np.asarray(getattr(self, name), np.float64))
        object.__setattr__(self, "peak_record",
                           np.asarray(self.peak_record, np.int64))
        object.__setattr__(self, "num_records", int(self.num_records))

    # ------------------------------------------------------------ builders

    @classmethod
    def from_record(cls, beta: np.ndarray, freq_ppm: np.ndarray,
                    num_records: Optional[int] = None) -> "Watermarks":
        """Reduce a full record to watermarks (the parity reference).

        Args:
          beta: (..., R, N) per-node net occupancy record, frames.
          freq_ppm: (..., R, N) frequency record, ppm.
        """
        beta = np.asarray(beta, np.float64)
        freq = np.asarray(freq_ppm, np.float64)
        if beta.shape != freq.shape:
            raise ValueError(f"beta {beta.shape} and freq_ppm {freq.shape} "
                             "must share one record grid")
        babs = np.abs(beta)
        return cls(beta_abs_max=babs.max(axis=-2),
                   peak_record=babs.argmax(axis=-2),
                   nu_min_ppm=freq.min(axis=-2),
                   nu_max_ppm=freq.max(axis=-2),
                   num_records=(beta.shape[-2] if num_records is None
                                else num_records))

    @classmethod
    def stack(cls, wms: "list[Watermarks]") -> "Watermarks":
        """Stack per-draw watermarks into one batched (B, ...) container.

        All inputs must share a record count (they come from the same
        run's per-draw engine launches).
        """
        counts = {w.num_records for w in wms}
        if len(counts) != 1:
            raise ValueError(f"cannot stack watermarks with differing "
                             f"record counts {sorted(counts)}")
        return cls(
            beta_abs_max=np.stack([w.beta_abs_max for w in wms]),
            peak_record=np.stack([w.peak_record for w in wms]),
            nu_min_ppm=np.stack([w.nu_min_ppm for w in wms]),
            nu_max_ppm=np.stack([w.nu_max_ppm for w in wms]),
            num_records=counts.pop())

    # ----------------------------------------------------------- composing

    def merge(self, other: "Watermarks") -> "Watermarks":
        """Fold a LATER chunk's watermarks into this one.

        ``other``'s record indices are re-based by this chunk chain's
        ``num_records``; a strictly larger \\|β\\| moves the peak (ties keep
        the earlier record — the first-occurrence convention).
        """
        later = other.beta_abs_max > self.beta_abs_max
        return Watermarks(
            beta_abs_max=np.maximum(self.beta_abs_max, other.beta_abs_max),
            peak_record=np.where(later,
                                 other.peak_record + self.num_records,
                                 self.peak_record),
            nu_min_ppm=np.minimum(self.nu_min_ppm, other.nu_min_ppm),
            nu_max_ppm=np.maximum(self.nu_max_ppm, other.nu_max_ppm),
            num_records=self.num_records + other.num_records)

    def __getitem__(self, idx) -> "Watermarks":
        """Slice the leading (draw) axes; the record count is shared."""
        return Watermarks(
            beta_abs_max=self.beta_abs_max[idx],
            peak_record=self.peak_record[idx],
            nu_min_ppm=self.nu_min_ppm[idx],
            nu_max_ppm=self.nu_max_ppm[idx],
            num_records=self.num_records)

    # ------------------------------------------------------------- queries

    @property
    def peak_beta(self) -> np.ndarray:
        """Max \\|β\\| over nodes (scalar per draw), frames."""
        return self.beta_abs_max.max(axis=-1)

    @property
    def peak_node(self) -> np.ndarray:
        """Node index attaining :attr:`peak_beta`, per draw."""
        return self.beta_abs_max.argmax(axis=-1)

    @property
    def peak_time_record(self) -> np.ndarray:
        """Record index at which the run-wide peak \\|β\\| occurred."""
        return np.take_along_axis(
            self.peak_record,
            np.expand_dims(self.peak_node, -1), axis=-1).squeeze(-1)

    @property
    def nu_spread_ppm(self) -> np.ndarray:
        """Ensemble frequency spread max_i ν_max − min_i ν_min, ppm."""
        return (self.nu_max_ppm.max(axis=-1)
                - self.nu_min_ppm.min(axis=-1))

    def health_report(self, depth: Optional[int] = None,
                      guard_margin: Optional[float] = None) -> str:
        """Human-readable excursion summary for one draw (or draw 0).

        Args:
          depth: elastic-buffer depth in frames; the physical wall the
            peak is judged against is ``depth/2``.
          guard_margin: the auto-reframe guard band in frames; reported
            as headroom against ``depth/2 − margin`` when both are given.
        """
        wm = self if self.beta_abs_max.ndim == 1 else self[0]
        peak = float(wm.peak_beta)
        lines = [
            f"peak |beta|   {peak:.3f} frames at node {int(wm.peak_node)}, "
            f"record {int(wm.peak_time_record)}/{wm.num_records}",
            f"nu spread     {float(wm.nu_spread_ppm):.6f} ppm "
            f"[{float(wm.nu_min_ppm.min()):+.4f}, "
            f"{float(wm.nu_max_ppm.max()):+.4f}]",
        ]
        if depth is not None:
            wall = depth / 2.0
            verdict = "OK" if peak <= wall else "OVERFLOW"
            lines.append(f"buffer wall   depth/2 = {wall:.1f} frames -> "
                         f"{verdict} (headroom {wall - peak:+.3f})")
            if guard_margin is not None:
                trip = wall - guard_margin
                armed = "TRIPPED" if peak > trip else "clear"
                lines.append(f"reframe guard trip at {trip:.3f} frames "
                             f"(margin {guard_margin:.3f}) -> {armed}")
        return "\n".join(lines)
