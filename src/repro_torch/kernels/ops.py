"""Runners of the dense lanes + topology densification.

Port of the dense part of ``repro.kernels.ops``.  ``densify`` converts an
edge-list topology into the latency-class dense form; the entry points
are:

``simulate_ensemble_dense``
    B independent oscillator draws advance together through one call of
    a dense kernel: the fused kernel
    (:func:`repro_torch.kernels.bittide_step.bittide_fused`) in its
    regime, the tiled kernel (``bittide_tiled``) beyond it.  ``kp`` /
    ``beta_off`` accept per-draw arrays; like the class latencies,
    ``lamsum`` and the controller mask they are kernel arguments, so a
    gain sweep builds nothing new.

``simulate_fused``
    One draw on the same lane.

``simulate_dense``
    Per-period telemetry (``record_every=1``), one draw.

``simulate_dense_perstep``
    The per-step lane (:func:`repro_torch.kernels.bittide_step.
    bittide_perstep`, one launch per period) recording every period —
    the benchmark baseline the fused engine removes the per-period
    round trip from.

``bittide_step``
    One control period of one draw (the reference's per-step API).

All return a :class:`DenseResult` — the ``(freq_ppm, psi)`` pair with
``.engine`` / ``.tile_j`` metadata, ``.nu`` (the exact final frequencies
for ``init=`` chaining), ``.beta`` (per-node net occupancy records in
frames) and ``.watermarks`` — as host numpy arrays.

Lanes: ``EngineOptions(engine="fused")``, ``"tiled"``, ``"sparse"``,
``"per-step"``, or ``"auto"`` (the H100 regime table, ``select_engine``:
fused up to 256 nodes, tiled above while the dense stack fits the card,
sparse beyond for a bounded-degree graph, per-step past that, with the
reference's warning), and ``use_ref=True`` for the plain dense oracle.
The sparse lane (:func:`repro_torch.kernels.bittide_sparse.bittide_sparse`)
runs on the ELL slot tables of :func:`~repro_torch.kernels.bittide_sparse.
ellify` — no stack is built — and is the only kernel lane that takes
per-draw (B, E) ``edge_w`` and fully heterogeneous per-draw latencies.
The per-step lane launches its draws one after another from a host loop
(a per-draw ``lamsum`` row stands in for the reference's per-draw λeff
stack).  No lane falls back to another.

The kernels map (draw, node) pairs to threads and mask their ragged
edges themselves, so nothing is padded: the reference's 128-node tiles
and 8-row batch quantum have no counterpart here.  The kernels read the
stack source-major (``a_t[c, j, i] = A[c, i, j]``); ``densify``, the
runners and the oracle all use that one layout (``_scatter``), and the
kernel lanes never build the dense λeff tensor (they fold λeff into
``lamsum``).
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.frame_model import LinkParams, OMEGA_NOM, broadcast_gain
from repro_torch.core.topology import Topology
from repro_torch.telemetry.api import Telemetry, resolve_telemetry
from repro_torch.telemetry.watermarks import Watermarks

from .api import EngineOptions, EngineOutputs, resolve_options
from .bittide_sparse import bittide_sparse, ellify, max_in_degree
from .bittide_step import (TILE_J, bittide_fused, bittide_perstep,
                           bittide_tiled, select_engine, sparse_tile)
from .ref import bittide_dense_multistep_ref, bittide_dense_step_ref

__all__ = ["bittide_step", "densify", "latency_classes", "simulate_dense",
           "simulate_dense_perstep", "simulate_fused",
           "simulate_ensemble_dense", "DenseResult"]

# Beyond this many exact latency classes, densify falls back to quantized
# merging (the dense stack is (C, N, N) — C must stay small).
MAX_EXACT_CLASSES = 8


class DenseResult(tuple):
    """``(freq_ppm, psi)`` pair with engine-dispatch metadata attached.

    ``.engine`` names the lane (``"fused"`` | ``"tiled"`` | ``"sparse"`` |
    ``"per-step"`` | ``"ref"``), ``.tile_j`` the adjacency panel width in
    nodes (N on the fused lane, which keeps the whole stack; the tiled
    kernel's panel width, at most ``TILE_J``, on the tiled lane; the
    sparse kernel's nodes per CTA on the sparse lane; 0 on the per-step
    lane).  ``.nu`` carries the exact final relative frequencies
    for ``init=`` chaining (``freq_ppm[..., -1, :]`` is ν·1e6 rounded
    through float32 and does not round-trip).  ``.beta`` is the per-node
    net occupancy record in frames, (B, R, N) / (R, N), or None;
    ``.watermarks`` a :class:`~repro_torch.telemetry.Watermarks` or None.
    """

    engine: str
    tile_j: int
    nu: Optional[np.ndarray]
    beta: Optional[np.ndarray]
    watermarks: Optional[Watermarks]

    def __new__(cls, freq_ppm, psi, engine: str, tile_j: int, nu=None,
                beta=None, watermarks=None):
        self = tuple.__new__(cls, (freq_ppm, psi))
        self.engine = engine
        self.tile_j = int(tile_j)
        self.nu = nu
        self.beta = beta
        self.watermarks = watermarks
        return self

    @property
    def beta_final(self) -> Optional[np.ndarray]:
        """Exact per-node net occupancy at the last record (frames)."""
        return None if self.beta is None else self.beta[..., -1, :]


def latency_classes(lat_frames: np.ndarray,
                    quantum_frames: Optional[float] = None,
                    lat_classes: Optional[np.ndarray] = None,
                    warn: bool = True):
    """Group per-edge latencies (frames) into dense kernel classes.

    Returns (classes (C,) float32, inv (E,) int64 edge→class map).  With
    ``lat_classes`` given, edges are assigned to the nearest provided class
    value, which must match to <= 1e-6 frames (relative to the value).
    """
    lat_frames = np.asarray(lat_frames, np.float64)
    if lat_classes is not None:
        classes = np.asarray(lat_classes, np.float64).reshape(-1)
        inv = np.abs(lat_frames[:, None] - classes[None, :]).argmin(axis=1)
        # Relative tolerance: class vectors round-trip through float32
        # (the kernels' latency dtype), which costs ~1e-7 relative.
        err = np.abs(lat_frames - classes[inv])
        tol = 1e-6 + 1e-6 * np.abs(classes[inv])
        if np.any(err > tol):
            worst = int(err.argmax())
            raise ValueError(
                f"edge latency {lat_frames[worst]:.6f} frames does "
                f"not match any provided latency class (off by "
                f"{err[worst]:.3g}); classes={classes}")
        return classes.astype(np.float32), inv.astype(np.int64)
    if quantum_frames is None:
        classes, inv = np.unique(lat_frames, return_inverse=True)
        if len(classes) <= MAX_EXACT_CLASSES:
            return classes.astype(np.float32), inv.astype(np.int64)
        # Heterogeneous latencies would make C explode; merge with a
        # quantum sized from the spread so C stays <= MAX_EXACT_CLASSES
        # (rint over a spread of S quanta lands in at most S+1 bins).
        spread = float(lat_frames.max() - lat_frames.min())
        quantum_frames = max(0.25, spread / (MAX_EXACT_CLASSES - 1))
        if warn:
            warnings.warn(
                f"densify: {len(classes)} exact latency classes > "
                f"{MAX_EXACT_CLASSES}; merging with quantum_frames="
                f"{quantum_frames:.3g} (pass quantum_frames explicitly to "
                "control this)", stacklevel=3)
    q = np.rint(lat_frames / quantum_frames).astype(np.int64)
    classes, inv = np.unique(q, return_inverse=True)
    return ((classes * quantum_frames).astype(np.float32),
            inv.astype(np.int64))


def _scatter(topo: Topology, inv: np.ndarray, c: int,
             values) -> np.ndarray:
    """(C, N, N) float32 per-class scatter of per-edge ``values`` in the
    kernels' source-major layout, entry [c, src, dst], with ``np.add.at``
    (duplicate edges accumulate, so multigraphs work)."""
    n = topo.num_nodes
    out = np.zeros((c, n, n), np.float32)
    np.add.at(out, (inv, np.asarray(topo.src, np.int64),
                    np.asarray(topo.dst, np.int64)), values)
    return out


def _edge_weights(topo: Topology, edge_w) -> np.ndarray:
    return (np.ones(topo.num_edges, np.float64) if edge_w is None
            else np.asarray(edge_w, np.float64))


def densify(topo: Topology, links: LinkParams, omega_nom: float = OMEGA_NOM,
            quantum_frames: Optional[float] = None,
            lat_classes: Optional[np.ndarray] = None,
            edge_w: Optional[np.ndarray] = None, *, device=None):
    """Edge list -> (a_t, lam_t, lat_classes, N).

    The stack and λeff are (C, N, N) float32 tensors on ``device`` (None
    means the CUDA card), built on the host with ``np.add.at`` (duplicate
    edges accumulate, so multigraphs work), in the kernels' source-major
    layout: ``a_t[c, j, i]`` is the weight of the edge j → i in class c,
    the transpose of the reference's ``A[c, i, j]``.  ``edge_w`` scales
    each edge's adjacency and λeff contribution (0 removes a dropped
    link).  ``lat_classes`` pins the class axis to a given latency vector.
    Nothing is padded; the fourth value is N, where the reference returns
    its padded N.
    """
    dev = resolve_device(device)
    lat_frames = np.asarray(links.latency_s, np.float64) * omega_nom
    if lat_frames.ndim != 1:
        raise ValueError(
            "densify takes a single link set; per-draw (B, E) links are "
            "handled by simulate_ensemble_dense")
    classes, inv = latency_classes(lat_frames, quantum_frames, lat_classes)
    c = len(classes)
    w = _edge_weights(topo, edge_w)
    a_t = _scatter(topo, inv, c, w)
    lam_t = _scatter(topo, inv, c, np.asarray(links.beta0, np.float64) * w)
    put = lambda x: torch.as_tensor(x, device=dev)
    return put(a_t), put(lam_t), put(classes), topo.num_nodes


def _fused_engine(psi, nu, nu_u, kp, beta_off, ctrl_mask, a_t, deg,
                  lamsum, lat, dt_frames: float, num_records: int,
                  record_every: int, engine: str, record_beta: bool,
                  record_watermarks: bool, record_guard: bool = False,
                  guard_lo=None, guard_hi=None, guard_stop=None,
                  lam_t=None, lists=None) -> EngineOutputs:
    """One run of a dense lane: ``engine`` is the chosen lane ("fused",
    "tiled", or "ref" for the dense oracle).

    psi, nu, nu_u: (B, N) state; kp, beta_off: (B,) gains; ctrl_mask:
    (1 | B, N); a_t: (C, N, N) stack in the kernels' layout with its
    degree fold deg (N,); lamsum: (B, N); lat: (B, C).  The oracle reads
    the dense λeff ``lam_t`` (same layout) instead of ``lamsum``.  With
    ``record_guard``, guard_lo / guard_hi (B,) and the int guard_stop feed
    the in-kernel guard (``EngineOutputs.guard_state``).  Watermarks are
    (beta_abs_max, peak_record, nu_min, nu_max).  ``lists``, the fused
    kernel's :func:`~repro_torch.kernels.bittide_step.row_lists` of
    ``a_t``, lets a caller that replays one stack build them once.
    """
    if engine == "ref":
        if record_guard:
            raise ValueError("record_guard is not supported on the "
                             "use_ref oracle lane")
        psi_f, nu_f, rec, brec = bittide_dense_multistep_ref(
            psi, nu, nu_u, a_t, lam_t, lat, kp, beta_off, dt_frames,
            num_records, record_every, ctrl_mask,
            record_beta=record_beta or record_watermarks)
        wm = None
        if record_watermarks:
            # The oracle reduces its full record (argmax keeps the first
            # maximal record, the in-kernel strict-> rule).
            babs = brec.abs()
            wm = (babs.max(dim=0).values,
                  babs.argmax(dim=0).to(torch.int32),
                  rec.min(dim=0).values, rec.max(dim=0).values)
            if not record_beta:
                brec = None
        return EngineOutputs(psi=psi_f, nu=nu_f, freq=rec, beta=brec,
                             watermarks=wm)
    kernel, extra = {"fused": (bittide_fused, dict(lists=lists)),
                     "tiled": (bittide_tiled, {})}[engine]
    return kernel(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off,
                  dt_frames, num_records=num_records,
                  record_every=record_every, ctrl_mask=ctrl_mask,
                  record_beta=record_beta,
                  record_watermarks=record_watermarks,
                  record_guard=record_guard, guard_lo=guard_lo,
                  guard_hi=guard_hi, guard_stop=guard_stop, **extra)


def _auto_is_sparse(topo: Topology, b: int,
                    class_count: Callable[[], Optional[int]]) -> bool:
    """Whether ``engine="auto"`` takes the sparse lane for B draws on
    ``topo``: the regime table (``select_engine``) probed with the degree
    bound.  ``class_count()`` gives the latency class count the dense
    lanes would use (None when the latencies form no classes); it is
    called only when the node count alone does not decide.  The tiled
    test is monotone in C, so a graph that is sparse at C = 1 is sparse
    at any C."""
    n, max_deg = topo.num_nodes, max_in_degree(topo)
    if select_engine(b, n, 1, max_deg=max_deg)[0] == "sparse":
        return True
    c = class_count()
    return c is not None and \
        select_engine(b, n, c, max_deg=max_deg)[0] == "sparse"


def _sparse_engine(psi, nu, nu_u, kp, beta_off, ctrl_mask, nbr, latf, w,
                   lamsum, dt_frames: float, num_records: int,
                   record_every: int, record_beta: bool,
                   record_watermarks: bool, record_guard: bool = False,
                   guard_lo=None, guard_hi=None,
                   guard_stop=None) -> EngineOutputs:
    """One run of the sparse lane (:func:`bittide_sparse`).

    psi, nu, nu_u: (B, N) state; kp, beta_off: (B,) gains; ctrl_mask:
    (1 | B, N); nbr: (K, N) int32 slot table; latf, w: (1 | B, K, N)
    slot latencies (frames) and weights — per-draw rows carry per-draw
    LinkDrop victims and heterogeneous cable draws; lamsum: (B, N).  The
    guard arguments as for :func:`_fused_engine`.
    """
    return bittide_sparse(psi, nu, nu_u, nbr, latf, w, lamsum, kp, beta_off,
                          dt_frames, num_records=num_records,
                          record_every=record_every, ctrl_mask=ctrl_mask,
                          record_beta=record_beta,
                          record_watermarks=record_watermarks,
                          record_guard=record_guard, guard_lo=guard_lo,
                          guard_hi=guard_hi, guard_stop=guard_stop)


def _perstep_engine(psi, nu, nu_u, ctrl_mask, a_t, deg, lamsum, lat,
                    kp: float, beta_off: float, dt_frames: float,
                    num_records: int, record_every: int,
                    record_beta: bool = False,
                    record_watermarks: bool = False,
                    record_guard: bool = False, guard_lo=None,
                    guard_hi=None, guard_stop=None) -> EngineOutputs:
    """One run of the per-step lane for ONE draw (:func:`bittide_perstep`),
    with the fused engines' record contract.

    psi, nu, nu_u, lamsum: (N,) state and λeff fold; ctrl_mask: (N,);
    a_t: (C, N, N) stack with its degree fold deg (N,); lat: (C,); kp,
    beta_off, the guard band edges guard_lo / guard_hi (frames per unit
    degree) and the stop cap guard_stop are host numbers, kernel
    arguments — none selects a build, so a gain sweep builds nothing new.
    ``guard_state`` is the 0-dim int32 trip record.
    """
    return bittide_perstep(psi, nu, nu_u, a_t, deg, lamsum, lat, kp,
                           beta_off, dt_frames, num_records=num_records,
                           record_every=record_every, ctrl_mask=ctrl_mask,
                           record_beta=record_beta,
                           record_watermarks=record_watermarks,
                           record_guard=record_guard, guard_lo=guard_lo,
                           guard_hi=guard_hi, guard_stop=guard_stop)


def _run_perstep(a_t, lamsum, latv, psi0, nu0, nu_u, mask, kp, beta_off,
                 dt_frames: float, num_records: int, record_every: int,
                 tel: Telemetry, put) -> DenseResult:
    """The per-step lane of :func:`simulate_ensemble_dense`: the draws run
    one after another, each with its own λeff fold row (per-draw β0 needs
    no per-draw stack) and its own mask row."""
    b = psi0.shape[0]
    deg = a_t.sum(dim=(0, 1))
    lamsum_d, lat_d, mask_d = put(lamsum), put(latv), put(mask)
    psi_d, nu_d, nu_u_d = put(psi0), put(nu0), put(nu_u)
    outs = [_perstep_engine(
        psi_d[bi], nu_d[bi], nu_u_d[bi], mask_d[bi % mask_d.shape[0]], a_t,
        deg, lamsum_d[bi], lat_d[bi], float(kp[bi]), float(beta_off[bi]),
        dt_frames, num_records, record_every, tel.beta, tel.watermarks)
        for bi in range(b)]
    stack = lambda xs: torch.stack(list(xs)).cpu().numpy()
    wm = (_host_watermarks(tuple(torch.stack([o.watermarks[k] for o in outs])
                                 for k in range(4)), num_records)
          if tel.watermarks else None)
    return DenseResult(
        stack(o.freq * 1e6 for o in outs), stack(o.psi for o in outs),
        "per-step", 0, nu=stack(o.nu for o in outs),
        beta=stack(o.beta for o in outs) if tel.beta else None,
        watermarks=wm)


def _resolve_init(init, b: int, n: int, nu_u: np.ndarray):
    """Seed (psi0, nu0) from ``init`` (a prior result or a (ψ, ν) pair)."""
    if init is None:
        return np.zeros_like(nu_u), nu_u.copy()
    init_psi = init[1] if isinstance(init, DenseResult) else init[0]
    init_nu = init.nu if isinstance(init, DenseResult) else init[1]
    if init_nu is None:
        raise ValueError("init DenseResult lacks .nu")
    init_psi = np.atleast_2d(init_psi)
    init_nu = np.atleast_2d(init_nu)
    for name, arr in (("psi", init_psi), ("nu", init_nu)):
        if arr.shape != (b, n):
            raise ValueError(
                f"init {name} must be (B, N) = ({b}, {n}), got "
                f"{arr.shape}")
    return init_psi.astype(np.float32), init_nu.astype(np.float32)


def _resolve_mask(ctrl_mask, b: int, n: int) -> np.ndarray:
    """The controller-enable mask — (N,) shared or (B, N) per-draw — as
    kernel rows (1 | B, N)."""
    if ctrl_mask is None:
        return np.ones((1, n), np.float32)
    mask = np.asarray(ctrl_mask, np.float32)
    if mask.ndim == 2:
        if mask.shape != (b, n):
            raise ValueError(f"per-draw ctrl_mask must be ({b}, {n}), got "
                             f"{mask.shape}")
        return mask
    return mask.reshape(1, n)


def _link_rows(links: LinkParams, b: int, num_edges: int):
    """Normalize LinkParams to per-draw (B, E) latency/beta0 rows.

    Returns (batched, lat_s (B, E) float64, beta0 (B, E) float64,
    beta0_batched).
    """
    lat = np.asarray(links.latency_s, np.float64)
    b0 = np.asarray(links.beta0, np.float64)
    batched = lat.ndim == 2 or b0.ndim == 2
    for name, arr in (("latency_s", lat), ("beta0", b0)):
        if arr.ndim == 2 and arr.shape != (b, num_edges):
            raise ValueError(
                f"per-draw links.{name} must be (B, E) = ({b}, "
                f"{num_edges}), got {arr.shape}")
        if arr.ndim == 1 and arr.shape != (num_edges,):
            raise ValueError(
                f"links.{name} must be ({num_edges},) or ({b}, "
                f"{num_edges}), got {arr.shape}")
    beta0_batched = b0.ndim == 2
    lat = np.broadcast_to(lat, (b, num_edges)) if lat.ndim == 1 else lat
    b0 = np.broadcast_to(b0, (b, num_edges)) if b0.ndim == 1 else b0
    return batched, lat, b0, beta0_batched


def _per_draw_class_values(lat_frames: np.ndarray, classes: np.ndarray,
                           inv: np.ndarray) -> np.ndarray:
    """(B, E) per-draw edge latencies -> (B, C) per-draw class values.

    All edges of one class must share one latency within each draw (the
    class structure is shared across draws); fully heterogeneous per-draw
    links belong on the segment-sum lane.
    """
    c = len(classes)
    rep = np.array([int(np.argmax(inv == ci)) for ci in range(c)])
    latv = lat_frames[:, rep]                                 # (B, C)
    dev = np.abs(lat_frames - latv[:, inv])
    err = (dev / (1.0 + np.abs(latv[:, inv]))).max(initial=0.0)
    if err > 1e-6:
        raise ValueError(
            "per-draw link latencies must share the class structure (one "
            "latency per class per draw; edges of a class may not differ "
            f"within a draw — max deviation {err:.3g} frames).  Use "
            "repro_torch.core.simulate_ensemble (segment-sum lane) for fully "
            "heterogeneous per-draw links.")
    return latv.astype(np.float32)


def _lamsum_host(topo: Topology, beta0: np.ndarray, edge_w,
                 b_rows: int) -> np.ndarray:
    """Per-node λeff fold Σ_{e→i} w_e·β0_e as (b_rows, N) rows."""
    contrib = np.broadcast_to(beta0 * _edge_weights(topo, edge_w),
                              (b_rows, topo.num_edges))
    out = np.zeros((b_rows, topo.num_nodes), np.float64)
    rows = np.broadcast_to(np.arange(b_rows)[:, None],
                           (b_rows, topo.num_edges))
    dst = np.broadcast_to(np.asarray(topo.dst, np.int64)[None, :],
                          (b_rows, topo.num_edges))
    np.add.at(out, (rows, dst), contrib)
    return out.astype(np.float32)


def _host_watermarks(wm_dev, num_records: int) -> Watermarks:
    """Device watermark tuple -> host :class:`Watermarks`, the ν extremes
    converted to ppm (``freq_ppm``'s units)."""
    bmax, idx, lo, hi = (x.cpu().numpy() for x in wm_dev)
    return Watermarks(beta_abs_max=bmax, peak_record=idx,
                      nu_min_ppm=lo * 1e6, nu_max_ppm=hi * 1e6,
                      num_records=num_records)


def _run_sparse(topo: Topology, links: LinkParams, beta0_be, beta0_batched,
                edge_w_np, ppm_u, kp, beta_off, dt: float, omega_nom: float,
                num_records: int, record_every: int, init, ctrl_mask,
                tel: Telemetry, dev) -> DenseResult:
    """The sparse ELL lane of :func:`simulate_ensemble_dense`.

    No densify and no latency classes: the slot tables carry every edge's
    own latency (frames), so fully heterogeneous per-draw links and
    per-draw edge weights are table rows here.
    """
    b, n = ppm_u.shape
    per_draw_w = edge_w_np is not None and edge_w_np.ndim == 2
    lat_s = np.asarray(links.latency_s, np.float64)
    nbr, latf, w = ellify(topo, lat_s * omega_nom, edge_w=edge_w_np)
    rows = b if (beta0_batched or per_draw_w) else 1
    lamsum = np.broadcast_to(
        _lamsum_host(topo, beta0_be if beta0_batched else beta0_be[0][None],
                     edge_w_np, rows), (b, n))
    nu_u = ppm_u * np.float32(1e-6)
    psi0, nu0 = _resolve_init(init, b, n, nu_u)
    put = lambda x: torch.as_tensor(np.array(x, np.float32, order="C"),
                                    device=dev)
    out = _sparse_engine(
        put(psi0), put(nu0), put(nu_u), put(kp), put(beta_off),
        put(_resolve_mask(ctrl_mask, b, n)), torch.as_tensor(nbr, device=dev),
        torch.as_tensor(latf, device=dev), torch.as_tensor(w, device=dev),
        put(lamsum), float(omega_nom * dt), int(num_records),
        int(record_every), tel.beta, tel.watermarks)
    host = lambda x: x.transpose(0, 1).contiguous().cpu().numpy()
    return DenseResult(
        host(out.freq * 1e6), out.psi.cpu().numpy(), "sparse",
        sparse_tile(n), nu=out.nu.cpu().numpy(),
        beta=host(out.beta) if tel.beta else None,
        watermarks=(_host_watermarks(out.watermarks, num_records)
                    if tel.watermarks else None))


def simulate_ensemble_dense(topo: Topology, links: LinkParams, ppm_u,
                            steps: int, kp, dt: float = 1e-3,
                            beta_off=0.0, record_every: int = 1,
                            omega_nom: float = OMEGA_NOM,
                            use_ref: bool = False, init=None,
                            ctrl_mask=None,
                            lat_classes: Optional[np.ndarray] = None,
                            edge_w: Optional[np.ndarray] = None,
                            options: Optional[EngineOptions] = None,
                            telemetry: Optional[Telemetry] = None, *,
                            device=None, engine: Optional[str] = None,
                            interpret: Optional[bool] = None,
                            record_beta: Optional[bool] = None,
                            record_watermarks: Optional[bool] = None
                            ) -> DenseResult:
    """Batched dense synchronization: B draws in one call of a dense kernel.

    Args:
      links: per-edge physical parameters; ``latency_s`` / ``beta0`` may
        carry a per-draw (B, E) axis that shares the latency-class
        structure (one value per class per draw).
      ppm_u: (B, N) unadjusted oscillator offsets in ppm.
      steps: control periods (floor-truncated to a multiple of
        ``record_every``).
      kp, beta_off: scalars or length-B arrays (one per draw).
      record_every: in-kernel telemetry decimation.
      use_ref: run the plain dense oracle instead of a kernel.
      init: optional ``(psi, nu)`` pair of (B, N) arrays or a prior
        DenseResult (segment chaining); default cold start (ψ = 0, ν = ν_u).
      ctrl_mask: optional (N,) shared or (B, N) per-draw controller-enable
        mask (0 = clock holdover).
      lat_classes: optional latency-class vector (frames) pinning the class
        axis.
      edge_w: optional (E,) edge weights (0 = dropped link), or (B, E)
        per-draw weights (chaos LinkDrop victims) on the sparse lane.
      options: :class:`EngineOptions`; ``engine`` is "auto" (the H100
        regime table, probed with the degree bound), "fused", "tiled",
        "sparse" (the ELL lane for bounded-degree networks; also the only
        kernel lane for per-draw (B, E) ``edge_w`` and fully heterogeneous
        per-draw latencies) or "per-step" (one draw per launch, one launch
        per period, the draws looped on the host).
      telemetry: :class:`Telemetry` — ``beta`` / ``watermarks``.
      device: where to run; None means the CUDA card (raises without one).
      engine, interpret, record_beta, record_watermarks: the reference's
        legacy spellings of ``options.engine`` / ``options.interpret`` /
        ``telemetry.beta`` / ``telemetry.watermarks``; a passed value wins
        over the typed field.  ``interpret=`` and the two ``record_*``
        kwargs warn once per process; ``engine=`` maps silently.

    Returns:
      DenseResult ``(freq_ppm (B, R, N), psi (B, N))`` with R = steps //
      record_every, ``.nu``, ``.beta`` ((B, R, N) frames or None) and
      ``.watermarks``.
    """
    opts = resolve_options(options, "simulate_ensemble_dense",
                           engine=engine, interpret=interpret)
    tel = resolve_telemetry(telemetry, "simulate_ensemble_dense",
                            beta=record_beta, watermarks=record_watermarks)
    if tel.trace or tel.guard:
        raise ValueError(
            "simulate_ensemble_dense: Telemetry.trace / Telemetry.guard "
            "need the scenario runner — use repro_torch.scenarios."
            "run_scenario, which owns the flight recorder and the "
            "reframing splice")
    if opts.interpret:
        raise ValueError("repro_torch has no kernel interpreter; pass "
                         "device='cpu' to run the plain PyTorch versions")
    if opts.chunk_records is not None:
        raise ValueError("simulate_ensemble_dense runs one launch per call; "
                         "chunk_records is a run_scenario option")
    engine = opts.engine
    if engine not in ("auto", "fused", "tiled", "sparse", "per-step"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    ppm_u = np.atleast_2d(np.asarray(ppm_u, np.float32))
    if ppm_u.shape[1] != topo.num_nodes:
        raise ValueError(
            f"ppm_u must be (B, {topo.num_nodes}), got {ppm_u.shape}")
    num_records = steps // record_every
    if num_records < 1:
        raise ValueError("steps must be >= record_every")
    b = ppm_u.shape[0]
    n = topo.num_nodes
    kp = broadcast_gain(kp, b, "kp")
    beta_off = broadcast_gain(beta_off, b, "beta_off")
    batched, lat_be, beta0_be, beta0_batched = _link_rows(
        links, b, topo.num_edges)

    # The sparse lane is decided before any stack is built: at its
    # 10⁵–10⁶-node scale a (C, N, N) stack must never exist, and per-draw
    # edge weights exist only as slot tables.
    edge_w_np = None if edge_w is None else np.asarray(edge_w, np.float64)
    per_draw_w = edge_w_np is not None and edge_w_np.ndim == 2
    if per_draw_w and edge_w_np.shape != (b, topo.num_edges):
        raise ValueError(
            f"per-draw edge_w must be (B, E) = ({b}, {topo.num_edges}), "
            f"got {edge_w_np.shape}")
    sparse = engine == "sparse"
    if engine == "auto" and not use_ref:
        # The class count the dense path would compute, at edge-list cost.
        sparse = _auto_is_sparse(topo, b, lambda: len(latency_classes(
            lat_be[0] * omega_nom, lat_classes=lat_classes, warn=False)[0]))
    if per_draw_w and not sparse:
        raise ValueError(
            "per-draw (B, E) edge_w needs the sparse or segment-sum "
            "engine (the dense (C, N, N) adjacency stacks are shared "
            "across draws)")
    if sparse:
        if use_ref:
            raise ValueError("use_ref does not support the sparse engine "
                             "(validate against segment-sum instead)")
        return _run_sparse(topo, links, beta0_be, beta0_batched, edge_w_np,
                           ppm_u, kp, beta_off, dt, omega_nom, num_records,
                           record_every, init, ctrl_mask, tel, dev)

    if beta0_batched and use_ref:
        raise ValueError("use_ref does not support per-draw beta0 (the "
                         "oracle's lam_eff tensor is shared across draws)")
    lat_frames_be = lat_be * omega_nom
    # Class structure from draw 0 (snapped to lat_classes when given), class
    # VALUES from each draw's rows.
    classes, inv = latency_classes(lat_frames_be[0], lat_classes=lat_classes)
    c = len(classes)
    if batched:
        latv = _per_draw_class_values(lat_frames_be,
                                      np.asarray(classes, np.float64), inv)
    else:
        latv = np.broadcast_to(classes[None, :], (b, c))

    if use_ref:
        chosen = "ref"
    else:
        chosen = select_engine(b, n, c)[0] if engine == "auto" else engine
        if chosen == "per-step" and engine == "auto":
            warnings.warn(
                f"no fused/tiled working set fits the card for B={b}, "
                f"N={n}, C={c}; falling back to the per-step kernel",
                stacklevel=2)
    w = _edge_weights(topo, edge_w)
    put = lambda x: torch.as_tensor(np.array(x, np.float32, order="C"),
                                    device=dev)
    # _scatter's arrays are fresh float32: copied to the device as they are.
    a_t = torch.as_tensor(_scatter(topo, inv, c, w), device=dev)
    lam_t = (torch.as_tensor(_scatter(topo, inv, c, beta0_be[0] * w),
                             device=dev) if use_ref else None)
    lamsum = np.broadcast_to(
        _lamsum_host(topo, beta0_be if beta0_batched else beta0_be[0][None],
                     edge_w, b if beta0_batched else 1), (b, n))
    nu_u = ppm_u * np.float32(1e-6)
    psi0, nu0 = _resolve_init(init, b, n, nu_u)
    if chosen == "per-step":
        return _run_perstep(a_t, lamsum, latv, psi0, nu0, nu_u,
                            _resolve_mask(ctrl_mask, b, n), kp, beta_off,
                            float(omega_nom * dt), num_records, record_every,
                            tel, put)

    out = _fused_engine(
        put(psi0), put(nu0), put(nu_u), put(kp), put(beta_off),
        put(_resolve_mask(ctrl_mask, b, n)), a_t, a_t.sum(dim=(0, 1)),
        put(lamsum), put(latv), float(omega_nom * dt), int(num_records),
        int(record_every), chosen, tel.beta, tel.watermarks, lam_t=lam_t)

    host = lambda x: x.transpose(0, 1).contiguous().cpu().numpy()
    return DenseResult(
        host(out.freq * 1e6), out.psi.cpu().numpy(), chosen,
        min(TILE_J, n) if chosen == "tiled" else n,
        nu=out.nu.cpu().numpy(), beta=host(out.beta) if tel.beta else None,
        watermarks=(_host_watermarks(out.watermarks, num_records)
                    if tel.watermarks else None))


def simulate_fused(topo: Topology, links: LinkParams, ppm_u, steps: int,
                   kp: float, dt: float = 1e-3, beta_off: float = 0.0,
                   record_every: int = 1, omega_nom: float = OMEGA_NOM,
                   use_ref: bool = False, init=None, ctrl_mask=None,
                   lat_classes=None, edge_w=None,
                   options: Optional[EngineOptions] = None,
                   telemetry: Optional[Telemetry] = None, *,
                   device=None, engine: Optional[str] = None,
                   interpret: Optional[bool] = None,
                   record_beta: Optional[bool] = None,
                   record_watermarks: Optional[bool] = None) -> DenseResult:
    """Single-draw fused run; returns (freq_ppm (R, N), psi (N,)).

    ``init`` takes (psi (N,), nu (N,)) or a prior single-draw DenseResult;
    everything else passes through to :func:`simulate_ensemble_dense`
    (``.beta`` is then (R, N), ``.watermarks`` per-node (N,) aggregates).
    The legacy ``engine=`` / ``interpret=`` / ``record_beta=`` /
    ``record_watermarks=`` kwargs are resolved here, so that a warning
    names this entry point.
    """
    options = resolve_options(options, "simulate_fused", engine=engine,
                              interpret=interpret)
    telemetry = resolve_telemetry(telemetry, "simulate_fused",
                                  beta=record_beta,
                                  watermarks=record_watermarks)
    if init is not None:
        if isinstance(init, DenseResult):
            init = (init[1], init.nu)
        init = (np.atleast_2d(init[0]), np.atleast_2d(init[1]))
    res = simulate_ensemble_dense(
        topo, links, np.atleast_2d(np.asarray(ppm_u, np.float32)), steps, kp,
        dt=dt, beta_off=beta_off, record_every=record_every,
        omega_nom=omega_nom, use_ref=use_ref, init=init,
        ctrl_mask=ctrl_mask, lat_classes=lat_classes, edge_w=edge_w,
        options=options, telemetry=telemetry, device=device)
    freq, psi = res
    return DenseResult(freq[0], psi[0], res.engine, res.tile_j,
                       nu=res.nu[0],
                       beta=None if res.beta is None else res.beta[0],
                       watermarks=None if res.watermarks is None
                       else res.watermarks[0])


def simulate_dense(topo: Topology, links: LinkParams, ppm_u, steps: int,
                   kp: float, dt: float = 1e-3, beta_off: float = 0.0,
                   omega_nom: float = OMEGA_NOM, use_ref: bool = False, *,
                   device=None) -> DenseResult:
    """Fused run with per-period telemetry; returns (freq_ppm (T, N),
    psi (N,)) with T == steps."""
    return simulate_fused(topo, links, ppm_u, steps, kp, dt=dt,
                          beta_off=beta_off, record_every=1,
                          omega_nom=omega_nom, use_ref=use_ref,
                          device=device)


def _gain_row(x, dev) -> torch.Tensor:
    """A gain as the oracle's (1,) per-draw float32 row."""
    return torch.tensor([float(x)], dtype=torch.float32, device=dev)


def bittide_step(psi, nu, nu_u, a_t, lam_t, lat, kp: float, beta_off: float,
                 dt_frames: float, *, ctrl_mask=None, use_ref: bool = False,
                 device=None):
    """One control period of one draw (the reference's per-step API).

    Args:
      psi, nu, nu_u: (N,) float32 state (ψ in frames, ν / ν_u relative
        frequency offsets).
      a_t, lam_t: (C, N, N) stack and λeff in the kernels' layout, as
        :func:`densify` returns them.
      lat: (C,) class latencies in frames.
      kp, beta_off, dt_frames: gains and frames per period (numbers; the
        kernel takes them as arguments, nothing is built per value).
      ctrl_mask: optional (N,) controller enables (≤ 0.5 = holdover).
      use_ref: run the plain dense oracle (``ref.bittide_dense_step_ref``).
      device: where to run; None means the CUDA card.

    The degree and λeff folds are taken from the stacks here, once per
    call; nothing is padded.  Returns (psi', nu'), (N,) tensors.
    """
    dev = resolve_device(device)
    put = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=dev).contiguous()
    psi, nu, nu_u, a_t, lam_t, lat = (put(x) for x in (psi, nu, nu_u, a_t,
                                                        lam_t, lat))
    mask = None if ctrl_mask is None else put(ctrl_mask)
    if use_ref:
        psi2, nu2, _ = bittide_dense_step_ref(
            psi[None], nu[None], nu_u[None], a_t, lam_t, lat,
            _gain_row(kp, dev), _gain_row(beta_off, dev), dt_frames,
            None if mask is None else mask[None])
        return psi2[0], nu2[0]
    out = _perstep_engine(psi, nu, nu_u, mask, a_t, a_t.sum(dim=(0, 1)),
                          lam_t.sum(dim=(0, 1)), lat, float(kp),
                          float(beta_off), float(dt_frames), 1, 1)
    return out.psi, out.nu


def simulate_dense_perstep(topo: Topology, links: LinkParams, ppm_u,
                           steps: int, kp: float, dt: float = 1e-3,
                           beta_off: float = 0.0,
                           omega_nom: float = OMEGA_NOM,
                           use_ref: bool = False, *,
                           device=None) -> DenseResult:
    """The per-step lane with per-period telemetry: one draw, one kernel
    launch per control period, every period recorded.  Kept as the
    benchmark baseline — it reads the whole (C, N, N) stack and round-trips
    the (N,) state through device memory every period, which is exactly
    what the fused engine saves.  Returns (freq_ppm (T, N), psi (N,)) with
    T == steps, ``.engine == "per-step"`` and ``.nu``; ``use_ref`` runs
    the plain dense oracle instead.
    """
    dev = resolve_device(device)
    a_t, lam_t, lat, n = densify(topo, links, omega_nom, device=dev)
    ppm = np.asarray(ppm_u, np.float32).reshape(n)
    nu_u = torch.as_tensor(ppm * np.float32(1e-6), device=dev)
    psi = torch.zeros_like(nu_u)
    dt_frames = float(omega_nom * dt)
    if use_ref:
        psi_f, nu_f, rec, _ = bittide_dense_multistep_ref(
            psi[None], nu_u[None], nu_u[None], a_t, lam_t, lat,
            _gain_row(kp, dev), _gain_row(beta_off, dev), dt_frames, steps,
            1)
        freq, psi_f, nu_f = rec[:, 0], psi_f[0], nu_f[0]
    else:
        lamsum = torch.as_tensor(_lamsum_host(
            topo, np.asarray(links.beta0, np.float64)[None], None, 1)[0],
            device=dev)
        out = _perstep_engine(psi, nu_u, nu_u, None, a_t,
                              a_t.sum(dim=(0, 1)), lamsum, lat, float(kp),
                              float(beta_off), dt_frames, steps, 1)
        freq, psi_f, nu_f = out.freq, out.psi, out.nu
    return DenseResult((freq * 1e6).cpu().numpy(), psi_f.cpu().numpy(),
                       "per-step", 0, nu=nu_f.cpu().numpy())
