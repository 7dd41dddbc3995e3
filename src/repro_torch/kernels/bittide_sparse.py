"""The sparse ELL bittide engine on Hopper: tables, wrapper, plain version.

Port of ``repro/kernels/bittide_sparse.py``.  Every dense lane pays
O(N²) per control period through the (C, N, N) stack, but all paper
topologies except the 8-node fully connected graph have bounded degree.
This lane writes one period as K slot gathers over a slot-major ELL
table:

    nbr  (K, N) int32    nbr[k, i]  = source node of node i's k-th in-edge
    latf (R, K, N) f32   per-slot physical latency in frames
    w    (R, K, N) f32   per-slot edge weight (0 = padding / dropped link)

    err_i = Σ_k w[k,i]·(ψ[nbr[k,i]] − ν[nbr[k,i]]·latf[k,i])
            − (ψ_i + β_off)·deg_i + lamsum_i,      deg_i = Σ_k w[k,i]

followed by the dense lanes' cancellation-free controller update.  R is
1 for tables shared by every draw and B for per-draw tables: per-draw
weights carry a chaos campaign's per-draw LinkDrop victims, per-draw
latencies fully heterogeneous cable draws.  Padding slots point at their
own node with weight 0, so they gather a valid address and add exactly
nothing.

``bittide_sparse`` (``csrc/bittide_sparse.cu``) replaces
``repro/kernels/bittide_sparse.py::_sparse_kernel``: one launch per
period from a C launch loop, the state in a ping-pong pair in device
memory.  Its plan (:func:`repro_torch.kernels.bittide_step.
sparse_launch_plan`) is grouped for shared tables and a (B, N) ψ + ν
beyond 8 MiB — the thread of node i loads each slot once for a group of
up to 8 draws and sums k = 0..K−1 in order for each — and direct, one
thread per (draw, node) pair, otherwise.
``bittide_sparse_torch`` is its plain PyTorch version: the same float32
operations in the same order, each its own torch op, so the two agree bit
for bit.  The wrapper runs the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.

The measure pass (``record_beta`` / ``record_watermarks`` /
``record_guard``) centres ψ by its row mean first.  At 10⁶ nodes a mean
summed j = 0..N−1 in order is one serial chain per draw, so this lane
takes it in a fixed two-level order: contiguous chunks of
``MEAN_CHUNK`` nodes, each summed in order, then the chunk sums in order.
Below ``MEAN_CHUNK`` nodes that is the dense lanes' order.  The guard
freezes the whole batch from the record after the earliest trip, and no
record after ``guard_stop`` runs; records after the freeze are NaN.

Runtime data never selects a build: the tables, K, N, B, the gains, the
mask, ``lamsum``, Δ, the guard band and the stop cap are kernel
arguments, and shared tables pass a row stride of 0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.topology import Topology

from .api import EngineOutputs
from .bittide_step import (VARIANTS_USED, _device_kind, _library, _outputs,
                           _ptr, sparse_launch_plan)

__all__ = ["ellify", "max_in_degree", "bittide_sparse",
           "bittide_sparse_torch", "MEAN_CHUNK"]

# Nodes per first-level chunk of the measure pass's row mean.
MEAN_CHUNK = 1024


def max_in_degree(topo: Topology) -> int:
    """Slot count K the ELL tables of ``topo`` need (≥ 1)."""
    if topo.num_edges == 0:
        return 1
    return max(1, int(topo.in_degree.max()))


def ellify(topo: Topology, lat_frames, edge_w=None,
           max_deg: Optional[int] = None):
    """Edge list → slot-major ELL tables for the sparse engine (numpy).

    Args:
      topo: the directed multigraph (parallel edges land in distinct
        slots, each with its own latency, as in the segment-sum lane).
      lat_frames: per-edge physical latency in frames — (E,) shared or
        (B, E) per-draw.
      edge_w: per-edge weights — None (all 1), (E,) shared or (B, E)
        per-draw.  Weight 0 removes the edge from the aggregation; its
        slot stays, so dropping and restoring links keeps the shapes.
      max_deg: slot count K (defaults to the max in-degree; larger values
        add always-padded slots).

    Returns:
      (nbr (K, N) int32, latf (R_l, K, N) float32, w (R_w, K, N)
      float32), R = 1 for shared inputs or B for per-draw ones.  Nothing
      is padded on the node axis (the reference pads N to 128).
    """
    n = topo.num_nodes
    e = topo.num_edges
    lat2 = np.atleast_2d(np.asarray(lat_frames, np.float64))
    if lat2.shape[-1] != e:
        raise ValueError(f"lat_frames must be (E,)=({e},) or (B, {e}), "
                         f"got {np.shape(lat_frames)}")
    if edge_w is None:
        w2 = np.ones((1, e), np.float64)
    else:
        w2 = np.atleast_2d(np.asarray(edge_w, np.float64))
        if w2.shape[-1] != e:
            raise ValueError(f"edge_w must be (E,)=({e},) or (B, {e}), "
                             f"got {np.shape(edge_w)}")

    dst = np.asarray(topo.dst, np.int64)
    src = np.asarray(topo.src, np.int64)
    counts = np.bincount(dst, minlength=n) if e else np.zeros(n, np.int64)
    k_need = max(1, int(counts.max())) if e else 1
    k = k_need if max_deg is None else int(max_deg)
    if k < k_need:
        raise ValueError(f"max_deg={k} < the topology's max in-degree "
                         f"{k_need}")

    # Each node's in-edges take slots 0..deg-1 in edge order: a stable
    # argsort groups edges by destination, and an edge's slot is its rank
    # within the group.
    slot = np.zeros(e, np.int64)
    if e:
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        perm = np.argsort(dst, kind="stable")
        slot[perm] = np.arange(e) - np.repeat(starts, counts)

    nbr = np.broadcast_to(np.arange(n, dtype=np.int32), (k, n)).copy()
    latf = np.zeros((lat2.shape[0], k, n), np.float32)
    wt = np.zeros((w2.shape[0], k, n), np.float32)
    if e:
        nbr[slot, dst] = src.astype(np.int32)
        latf[:, slot, dst] = lat2
        wt[:, slot, dst] = w2
    return nbr, latf, wt


def _check(psi, nu, nu_u, nbr, latf, w, lamsum, kp, beta_off, ctrl_mask,
           num_records: int, record_every: int, guard):
    b, n = psi.shape
    k = nbr.shape[0] if nbr.dim() == 2 else -1
    if tuple(nbr.shape) != (k, n) or k < 1:
        raise ValueError(f"nbr must be (K, {n}), got {tuple(nbr.shape)}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"nbr must be int32, got {nbr.dtype}")
    shapes = {"psi": (psi, (b, n)), "nu": (nu, (b, n)),
              "nu_u": (nu_u, (b, n)), "lamsum": (lamsum, (b, n)),
              "kp": (kp, (b,)), "beta_off": (beta_off, (b,))}
    for name, tbl in (("latf", latf), ("w", w)):
        rows = tbl.shape[0] if tbl.dim() == 3 else -1
        if tbl.dim() != 3 or tuple(tbl.shape[1:]) != (k, n) \
                or rows not in (1, b):
            raise ValueError(f"{name} must be (1, {k}, {n}) or ({b}, {k}, "
                             f"{n}), got {tuple(tbl.shape)}")
        shapes[name] = (tbl, tuple(tbl.shape))
    if ctrl_mask is not None:
        rows = ctrl_mask.shape[0] if ctrl_mask.dim() == 2 else -1
        shapes["ctrl_mask"] = (ctrl_mask, (rows if rows in (1, b) else 1, n))
    if guard is not None:
        lo, hi, stop = guard
        if lo is None or hi is None or stop is None:
            raise ValueError("record_guard=True requires guard_lo, guard_hi "
                             "and guard_stop")
        shapes["guard_lo"] = (lo, (b,))
        shapes["guard_hi"] = (hi, (b,))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in dict(shapes, nbr=(nbr, None)).items():
        t = t[0]
        if t.device != psi.device:
            raise ValueError(f"{name} is on {t.device}, psi on {psi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if num_records < 1 or record_every < 1:
        raise ValueError("num_records and record_every must be >= 1")


def bittide_sparse(psi, nu, nu_u, nbr, latf, w, lamsum, kp, beta_off,
                   dt_frames: float, *, num_records: int, record_every: int,
                   ctrl_mask: Optional[torch.Tensor] = None,
                   record_beta: bool = False,
                   record_watermarks: bool = False,
                   record_guard: bool = False,
                   guard_lo: Optional[torch.Tensor] = None,
                   guard_hi: Optional[torch.Tensor] = None,
                   guard_stop: Optional[int] = None) -> EngineOutputs:
    """Advance ``num_records * record_every`` periods on the ELL tables.

    Args:
      psi, nu, nu_u: (B, N) float32 state of B independent draws.
      nbr: (K, N) int32 slot-major neighbour table (:func:`ellify`).
      latf, w: (1, K, N) shared or (B, K, N) per-draw slot latencies
        (frames) and weights.
      lamsum: (B, N) per-node λeff fold Σ_{e→i} w_e·λeff_e.
      kp, beta_off: (B,) per-draw controller gains.
      dt_frames: frames per control period.
      ctrl_mask: None (all on), (1, N) shared or (B, N) per-draw
        controller enables; nodes at ≤ 0.5 hold their ν.
      record_beta / record_watermarks / record_guard: the variants, as on
        the dense lanes (:func:`repro_torch.kernels.bittide_fused`).
      guard_lo, guard_hi: (B,) guard band in frames per unit degree, and
        guard_stop: the last record to run (an int) — with record_guard.

    Returns :class:`EngineOutputs` in the dense lanes' layout: psi, nu
    (B, N); freq (R, B, N); beta (R, B, N) or None; watermarks
    (beta_abs_max, peak_record i32, nu_min, nu_max), each (B, N), or None;
    guard_state (B, 1) int32 or None.

    On the card one C call launches the kernel once per period and three
    times per measure pass (two for the row mean, one for the centred
    aggregation), all on the current stream with no sync; ``launches``
    counts the calls that launched.
    """
    guard = (guard_lo, guard_hi, guard_stop) if record_guard else None
    _check(psi, nu, nu_u, nbr, latf, w, lamsum, kp, beta_off, ctrl_mask,
           num_records, record_every, guard)
    VARIANTS_USED.add(("sparse", bool(record_beta), bool(record_watermarks),
                       bool(record_guard)))
    kw = dict(num_records=num_records, record_every=record_every,
              ctrl_mask=ctrl_mask, record_beta=record_beta,
              record_watermarks=record_watermarks, record_guard=record_guard,
              guard_lo=guard_lo, guard_hi=guard_hi, guard_stop=guard_stop)
    if _device_kind(psi, "bittide_sparse") == "cpu":
        return bittide_sparse_torch(psi, nu, nu_u, nbr, latf, w, lamsum, kp,
                                    beta_off, dt_frames, **kw)
    b, n = psi.shape
    k = nbr.shape[0]
    dev = psi.device
    mask = (torch.ones((1, n), dtype=torch.float32, device=dev)
            if ctrl_mask is None else ctrl_mask)
    psi_buf = torch.empty((2, b, n), dtype=torch.float32, device=dev)
    nu_buf = torch.empty_like(psi_buf)
    psi_buf[0].copy_(psi)
    nu_buf[0].copy_(nu)
    freq, beta, wm = _outputs(b, n, num_records, dev, record_beta,
                              record_watermarks, record_guard)
    trip = trip_min = None
    if record_guard:
        trip = torch.full((b,), num_records, dtype=torch.int32, device=dev)
        trip_min = torch.full((1,), num_records, dtype=torch.int32,
                              device=dev)
    chunks = -(-n // MEAN_CHUNK)
    partial = torch.empty((b, chunks), dtype=torch.float32, device=dev)
    mean = torch.empty(b, dtype=torch.float32, device=dev)
    last = (min(num_records - 1, int(guard_stop)) if record_guard
            else num_records - 1)
    kn = k * n
    plan = sparse_launch_plan(b, n, k, latf.shape[0] == w.shape[0] == 1)
    rc = _library("bittide_sparse").bittide_sparse_launch(
        _ptr(nbr), _ptr(latf), 0 if latf.shape[0] == 1 else kn, _ptr(w),
        0 if w.shape[0] == 1 else kn, _ptr(nu_u), _ptr(kp), _ptr(beta_off),
        _ptr(mask), mask.shape[0], _ptr(lamsum), float(dt_frames), b, n, k,
        num_records, record_every, last, int(plan["grouped"]),
        plan["nodes_per_cta"], plan["draws_per_thread"], _ptr(psi_buf),
        _ptr(nu_buf), _ptr(freq), _ptr(beta),
        *(_ptr(x) for x in (wm if wm else (None,) * 4)), _ptr(guard_lo),
        _ptr(guard_hi), _ptr(trip), _ptr(trip_min), _ptr(partial),
        _ptr(mean), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bittide_sparse launch failed with CUDA error "
                           f"{rc} (B={b}, N={n}, K={k}, plan {plan})")
    bittide_sparse.launches += 1
    slot = (max(last + 1, 0) * record_every) % 2
    return EngineOutputs(psi=psi_buf[slot], nu=nu_buf[slot], freq=freq,
                         beta=beta, watermarks=wm,
                         guard_state=None if trip is None else trip[:, None])


bittide_sparse.launches = 0


def _row_mean(psi: torch.Tensor, n_t: torch.Tensor) -> torch.Tensor:
    """Per-draw mean of ψ in the kernel's two-level order: chunks of
    MEAN_CHUNK nodes, each summed in order, then the chunk sums in order
    (zeros pad the last chunk: adding 0.0 leaves a sum as it is)."""
    b, n = psi.shape
    chunks = -(-n // MEAN_CHUNK)
    width = min(n, MEAN_CHUNK)
    pad = torch.zeros((b, chunks * width), dtype=psi.dtype,
                      device=psi.device)
    pad[:, :n] = psi
    view = pad.view(b, chunks, width)
    part = torch.zeros((b, chunks), dtype=psi.dtype, device=psi.device)
    for j in range(width):
        part = part + view[:, :, j]
    total = torch.zeros(b, dtype=psi.dtype, device=psi.device)
    for c in range(chunks):
        total = total + part[:, c]
    return total / n_t


def bittide_sparse_torch(psi, nu, nu_u, nbr, latf, w, lamsum, kp, beta_off,
                         dt_frames: float, *, num_records: int,
                         record_every: int,
                         ctrl_mask: Optional[torch.Tensor] = None,
                         record_beta: bool = False,
                         record_watermarks: bool = False,
                         record_guard: bool = False,
                         guard_lo: Optional[torch.Tensor] = None,
                         guard_hi: Optional[torch.Tensor] = None,
                         guard_stop: Optional[int] = None) -> EngineOutputs:
    """The plain PyTorch version of :func:`bittide_sparse` (same contract).

    It performs the kernel's float32 operations in the kernel's order —
    each product and sum its own rounded torch op, slots k = 0..K−1 in
    order, gathers by indexing (no scatter) — and freezes the batch
    directly: record t runs while min(trip) ≥ t and t ≤ guard_stop.
    """
    b, n = psi.shape
    k = nbr.shape[0]
    dev = psi.device
    mask = (torch.ones((1, n), dtype=torch.float32, device=dev)
            if ctrl_mask is None else ctrl_mask)
    enabled = mask > 0.5
    kp_col, boff_col = kp[:, None], beta_off[:, None]
    idx = [nbr[s].long() for s in range(k)]
    lats = [latf[:, s] for s in range(k)]
    ws = [w[:, s] for s in range(k)]
    deg = torch.zeros_like(ws[0])
    for ws_k in ws:
        deg = deg + ws_k
    # A tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, the kernel by the true quotient.
    n_t = torch.tensor(float(n), dtype=torch.float32, device=dev)

    def aggregate(p, v):
        acc = torch.zeros_like(p)
        for s in range(k):
            acc = acc + ws[s] * (p[:, idx[s]] - v[:, idx[s]] * lats[s])
        return acc

    measure = record_beta or record_watermarks or record_guard
    nan = float("nan")
    freq = torch.full((num_records, b, n), nan, device=dev)
    beta = (torch.full((num_records, b, n), nan, device=dev)
            if record_beta else None)
    trip = torch.full((b,), num_records, dtype=torch.int32, device=dev)
    wm = None
    for t in range(num_records):
        if record_guard and (int(trip.min()) < t or t > guard_stop):
            break
        for _ in range(record_every):
            err = aggregate(psi, nu) - (psi + boff_col) * deg + lamsum
            c_rel = kp_col * err
            nu_next = nu_u + c_rel + nu_u * c_rel
            nu = torch.where(enabled, nu_next, nu)
            psi = psi + nu * dt_frames
        freq[t] = nu
        if not measure:
            continue
        psi_c = psi - _row_mean(psi, n_t)[:, None]
        bnode = aggregate(psi_c, nu) - psi_c * deg + lamsum
        if record_beta:
            beta[t] = bnode
        if record_watermarks:
            babs = bnode.abs()
            if wm is None:
                wm = (babs, torch.zeros_like(babs, dtype=torch.int32), nu, nu)
            else:
                bmax, widx, lo, hi = wm
                wm = (torch.maximum(bmax, babs),
                      torch.where(babs > bmax, torch.full_like(widx, t), widx),
                      torch.minimum(lo, nu), torch.maximum(hi, nu))
        if record_guard:
            viol = ((bnode > guard_hi[:, None] * deg)
                    | (bnode < guard_lo[:, None] * deg)).any(dim=1)
            trip = torch.where(viol, torch.full_like(trip, t), trip)
    return EngineOutputs(psi=psi, nu=nu, freq=freq, beta=beta,
                         watermarks=wm,
                         guard_state=trip[:, None] if record_guard else None)
