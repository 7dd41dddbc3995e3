"""Runners of the dense fused lane + topology densification.

Port of the fused part of ``repro.kernels.ops``.  ``densify`` converts an
edge-list topology into the latency-class dense form the kernel consumes;
the entry points are:

``simulate_ensemble_dense``
    B independent oscillator draws advance together through ONE launch of
    the fused kernel (:func:`repro_torch.kernels.bittide_step.bittide_fused`).
    ``kp`` / ``beta_off`` accept per-draw arrays; like the class
    latencies, ``lamsum`` and the controller mask they are kernel
    arguments, so a gain sweep builds nothing new.

``simulate_fused``
    One draw on the same lane.

``simulate_dense``
    Per-period telemetry (``record_every=1``), one draw.

All return a :class:`DenseResult` — the ``(freq_ppm, psi)`` pair with
``.engine`` / ``.tile_j`` metadata, ``.nu`` (the exact final frequencies
for ``init=`` chaining), ``.beta`` (per-node net occupancy records in
frames) and ``.watermarks`` — as host numpy arrays.

Lanes: ``EngineOptions(engine="fused")`` or ``"auto"`` inside the H100
fused regime (``select_engine``), and ``use_ref=True`` for the plain dense
oracle.  The tiled, sparse and per-step lanes raise ``NotImplementedError``
naming their ROADMAP items; no lane falls back to another.

Padding: the H100 kernel maps (draw, node) pairs to threads, so it needs
neither the reference's 128-node tiles nor its 8-row batch quantum; the
port pads nothing by default (``NODE_TILE = BATCH_QUANTUM = 1``).  The
padding helpers keep their quantum, and padded nodes (degree 0) and draws
stay inert.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.frame_model import LinkParams, OMEGA_NOM, broadcast_gain
from repro_torch.core.topology import Topology
from repro_torch.telemetry.api import Telemetry
from repro_torch.telemetry.watermarks import Watermarks

from .api import EngineOptions, EngineOutputs
from .bittide_step import bittide_fused, select_engine
from .ref import bittide_dense_multistep_ref

__all__ = ["densify", "latency_classes", "simulate_dense", "simulate_fused",
           "simulate_ensemble_dense", "DenseResult", "NODE_TILE",
           "BATCH_QUANTUM"]

# Beyond this many exact latency classes, densify falls back to quantized
# merging (the dense stack is (C, N, N) — C must stay small).
MAX_EXACT_CLASSES = 8

NODE_TILE = 1       # node padding quantum of the port's dense stacks
BATCH_QUANTUM = 1   # draw padding quantum

# Lanes of the reference this port does not have yet, by ROADMAP item.
_UNPORTED = {"tiled": "ROADMAP queue item 3 (tiled lane)",
             "sparse": "ROADMAP queue item 5 (sparse lane)",
             "per-step": "ROADMAP queue item 9 (per-step lane)"}


class DenseResult(tuple):
    """``(freq_ppm, psi)`` pair with engine-dispatch metadata attached.

    ``.engine`` names the lane (``"fused"`` | ``"ref"``), ``.tile_j`` the
    adjacency panel width in nodes (== padded N: the fused lane keeps the
    whole stack).  ``.nu`` carries the exact final relative frequencies
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


def densify(topo: Topology, links: LinkParams, omega_nom: float = OMEGA_NOM,
            quantum_frames: Optional[float] = None, tile: int = NODE_TILE,
            lat_classes: Optional[np.ndarray] = None,
            edge_w: Optional[np.ndarray] = None, *, device=None):
    """Edge list -> (A, lam_eff, lat_classes, n_padded).

    A and λeff are (C, N_pad, N_pad) float32 tensors on ``device`` (None
    means the CUDA card), built on the host with ``np.add.at`` (duplicate
    edges accumulate, so multigraphs work); ``edge_w`` scales each edge's
    adjacency and λeff contribution (0 removes a dropped link).  N is
    padded up to a multiple of ``tile``.  ``lat_classes`` pins the class
    axis to a given latency vector.
    """
    dev = resolve_device(device)
    lat_frames = np.asarray(links.latency_s, np.float64) * omega_nom
    if lat_frames.ndim != 1:
        raise ValueError(
            "densify takes a single link set; per-draw (B, E) links are "
            "handled by simulate_ensemble_dense")
    classes, inv = latency_classes(lat_frames, quantum_frames, lat_classes)
    c = len(classes)
    n = topo.num_nodes
    n_pad = ((n + tile - 1) // tile) * tile
    a = np.zeros((c, n_pad, n_pad), np.float32)
    lam = np.zeros((c, n_pad, n_pad), np.float32)
    dst = np.asarray(topo.dst, np.int64)
    src = np.asarray(topo.src, np.int64)
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    np.add.at(a, (inv, dst, src), w)
    np.add.at(lam, (inv, dst, src), np.asarray(links.beta0, np.float64) * w)
    put = lambda x: torch.as_tensor(x, device=dev)
    return put(a), put(lam), put(classes), n_pad


def _fused_engine(psi, nu, nu_u, kp, beta_off, ctrl_mask, a, lam_eff,
                  lamsum, lat, dt_frames: float, num_records: int,
                  record_every: int, use_ref: bool, record_beta: bool,
                  record_watermarks: bool) -> EngineOutputs:
    """One run of the fused lane (or of the dense oracle with ``use_ref``).

    psi, nu, nu_u: (B_pad, N_pad) state; kp, beta_off: (B_pad,) gains;
    ctrl_mask: (1 | B_pad, N_pad); a, lam_eff: (C, N_pad, N_pad); lamsum:
    (B_pad, N_pad); lat: (B_pad, C).  Watermarks are (beta_abs_max,
    peak_record, nu_min, nu_max).
    """
    if use_ref:
        psi_f, nu_f, rec, brec = bittide_dense_multistep_ref(
            psi, nu, nu_u, a, lam_eff, lat, kp, beta_off, dt_frames,
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
    # Step-invariant per-node degree fold, hoisted out of the period loop.
    deg = a.sum(dim=(0, 2))
    return bittide_fused(psi, nu, nu_u, a, deg, lamsum, lat, kp, beta_off,
                         dt_frames, num_records=num_records,
                         record_every=record_every, ctrl_mask=ctrl_mask,
                         record_beta=record_beta,
                         record_watermarks=record_watermarks)


def _pad_batch(ppm_u: np.ndarray, n: int, n_pad: int,
               quantum: int = BATCH_QUANTUM) -> Tuple[np.ndarray, int]:
    """(B, n) ppm draws -> (B_pad, n_pad) ν_u with inert zero padding."""
    b = ppm_u.shape[0]
    b_pad = ((b + quantum - 1) // quantum) * quantum
    nu_u = np.zeros((b_pad, n_pad), np.float32)
    nu_u[:b, :n] = ppm_u * 1e-6
    return nu_u, b_pad


def _pad_gain(gain: np.ndarray, b_pad: int) -> np.ndarray:
    """(B,) per-draw gains -> (B_pad,) (padding rows are independent)."""
    out = np.zeros((b_pad,), np.float32)
    out[:gain.shape[0]] = gain
    return out


def _pad_state(state: np.ndarray, b_pad: int, n_pad: int) -> np.ndarray:
    """(B, N) chained state -> (B_pad, N_pad) with inert zero padding."""
    b, n = np.asarray(state).shape
    out = np.zeros((b_pad, n_pad), np.float32)
    out[:b, :n] = np.asarray(state, np.float32)
    return out


def _resolve_init(init, b: int, n: int, b_pad: int, n_pad: int,
                  nu_u: np.ndarray):
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
    return _pad_state(init_psi, b_pad, n_pad), _pad_state(init_nu, b_pad,
                                                          n_pad)


def _resolve_mask(ctrl_mask, b: int, n: int, b_pad: int, n_pad: int):
    """Pad the controller-enable mask — (N,) shared or (B, N) per-draw —
    to kernel layout (1 | B_pad, N_pad); padding stays enabled (inert)."""
    mask_np = (None if ctrl_mask is None
               else np.asarray(ctrl_mask, np.float32))
    if mask_np is not None and mask_np.ndim == 2:
        if mask_np.shape != (b, n):
            raise ValueError(f"per-draw ctrl_mask must be ({b}, {n}), got "
                             f"{mask_np.shape}")
        mask_pad = np.ones((b_pad, n_pad), np.float32)
        mask_pad[:b, :n] = mask_np
    else:
        mask_pad = np.ones((1, n_pad), np.float32)
        if mask_np is not None:
            mask_pad[0, :n] = mask_np
    return mask_pad


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


def _lamsum_host(topo: Topology, beta0: np.ndarray, edge_w, b_rows: int,
                 n_pad: int) -> np.ndarray:
    """Per-node λeff fold Σ_{e→i} w_e·β0_e as (b_rows, n_pad) rows."""
    w = (np.ones(topo.num_edges, np.float64) if edge_w is None
         else np.asarray(edge_w, np.float64))
    contrib = np.broadcast_to(beta0 * w, (b_rows, topo.num_edges))
    out = np.zeros((b_rows, n_pad), np.float64)
    rows = np.broadcast_to(np.arange(b_rows)[:, None],
                           (b_rows, topo.num_edges))
    dst = np.broadcast_to(np.asarray(topo.dst, np.int64)[None, :],
                          (b_rows, topo.num_edges))
    np.add.at(out, (rows, dst), contrib)
    return out.astype(np.float32)


def _host_watermarks(wm_dev, num_records: int, b: int, n: int) -> Watermarks:
    """Device watermark tuple -> host :class:`Watermarks`, padding cut
    away and the ν extremes converted to ppm (``freq_ppm``'s units)."""
    bmax, idx, lo, hi = (x[:b, :n].cpu().numpy() for x in wm_dev)
    return Watermarks(beta_abs_max=bmax, peak_record=idx,
                      nu_min_ppm=lo * 1e6, nu_max_ppm=hi * 1e6,
                      num_records=num_records)


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
                            device=None) -> DenseResult:
    """Batched fused synchronization: B draws in one kernel launch.

    Args:
      links: per-edge physical parameters; ``latency_s`` / ``beta0`` may
        carry a per-draw (B, E) axis that shares the latency-class
        structure (one value per class per draw).
      ppm_u: (B, N) unadjusted oscillator offsets in ppm.
      steps: control periods (floor-truncated to a multiple of
        ``record_every``).
      kp, beta_off: scalars or length-B arrays (one per draw).
      record_every: in-kernel telemetry decimation.
      use_ref: run the plain dense oracle instead of the fused kernel.
      init: optional ``(psi, nu)`` pair of (B, N) arrays or a prior
        DenseResult (segment chaining); default cold start (ψ = 0, ν = ν_u).
      ctrl_mask: optional (N,) shared or (B, N) per-draw controller-enable
        mask (0 = clock holdover).
      lat_classes: optional latency-class vector (frames) pinning the class
        axis.
      edge_w: optional (E,) edge weights (0 = dropped link).  Per-draw
        (B, E) weights need the sparse lane, which is not ported.
      options: :class:`EngineOptions`; ``engine`` is "auto" or "fused".
      telemetry: :class:`Telemetry` — ``beta`` / ``watermarks``.
      device: where to run; None means the CUDA card (raises without one).

    Returns:
      DenseResult ``(freq_ppm (B, R, N), psi (B, N))`` with R = steps //
      record_every, ``.nu``, ``.beta`` ((B, R, N) frames or None) and
      ``.watermarks``.
    """
    opts = EngineOptions() if options is None else options
    tel = Telemetry() if telemetry is None else telemetry
    if not isinstance(opts, EngineOptions):
        raise TypeError("options= must be a repro_torch.kernels."
                        f"EngineOptions, got {type(opts).__name__}")
    if not isinstance(tel, Telemetry):
        raise TypeError("telemetry= must be a repro_torch.telemetry."
                        f"Telemetry, got {type(tel).__name__}")
    if opts.interpret:
        raise ValueError("repro_torch has no kernel interpreter; pass "
                         "device='cpu' to run the plain PyTorch versions")
    if opts.chunk_records is not None:
        raise ValueError("simulate_ensemble_dense runs one launch per call; "
                         "chunk_records is a run_scenario option")
    engine = opts.engine
    if engine in _UNPORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: {_UNPORTED[engine]}")
    if engine not in ("auto", "fused"):
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
    if edge_w is not None and np.ndim(edge_w) == 2:
        raise NotImplementedError(
            "per-draw (B, E) edge_w needs the sparse lane, which is not "
            f"ported yet: {_UNPORTED['sparse']}; use "
            "repro_torch.core.simulate_ensemble (segment-sum)")
    if beta0_batched and use_ref:
        raise ValueError("use_ref does not support per-draw beta0 (the "
                         "oracle's lam_eff tensor is shared across draws)")
    if batched:
        # Class structure from draw 0, class VALUES from each draw's rows.
        lat_frames_be = lat_be * omega_nom
        classes_np, inv = latency_classes(lat_frames_be[0],
                                          lat_classes=lat_classes)
        classes_np = np.asarray(classes_np, np.float64)
        latv = _per_draw_class_values(lat_frames_be, classes_np, inv)
        links0 = LinkParams(latency_s=classes_np[inv] / omega_nom,
                            beta0=beta0_be[0])
    else:
        links0 = LinkParams(latency_s=lat_be[0], beta0=beta0_be[0])
    a, lam_eff, classes, n_pad = densify(
        topo, links0, omega_nom,
        lat_classes=classes_np if batched else lat_classes, edge_w=edge_w,
        device=dev)
    c = a.shape[0]
    classes_np = classes.cpu().numpy()
    if not batched:
        latv = np.broadcast_to(classes_np[None, :], (b, c))
    lamsum_rows = _lamsum_host(topo, beta0_be if beta0_batched
                               else beta0_be[0][None], edge_w,
                               b if beta0_batched else 1, n_pad)

    nu_u, b_pad = _pad_batch(ppm_u, n, n_pad)
    psi0, nu0 = _resolve_init(init, b, n, b_pad, n_pad, nu_u)
    mask_pad = _resolve_mask(ctrl_mask, b, n, b_pad, n_pad)

    if use_ref:
        chosen = "ref"
    else:
        chosen = select_engine(b_pad, n_pad, c)[0]
        if engine == "auto" and chosen != "fused":
            raise NotImplementedError(
                f"N={n_pad}, C={c} is outside the H100 fused regime and the "
                f"{chosen} lane is not ported yet: {_UNPORTED[chosen]}")
        chosen = "fused"

    lat_pad = np.empty((b_pad, c), np.float32)
    lat_pad[:b] = latv
    lat_pad[b:] = classes_np[None, :]
    lamsum_pad = np.zeros((b_pad, n_pad), np.float32)
    lamsum_pad[:b] = np.broadcast_to(lamsum_rows, (b, n_pad))

    put = lambda x: torch.as_tensor(np.array(x), device=dev)
    out = _fused_engine(
        put(psi0), put(nu0), put(nu_u), put(_pad_gain(kp, b_pad)),
        put(_pad_gain(beta_off, b_pad)), put(mask_pad), a, lam_eff,
        put(lamsum_pad), put(lat_pad), float(omega_nom * dt),
        int(num_records), int(record_every), bool(use_ref),
        tel.beta, tel.watermarks)

    host = lambda x: x[:, :b, :n].transpose(0, 1).contiguous().cpu().numpy()
    return DenseResult(
        host(out.freq * 1e6), out.psi[:b, :n].cpu().numpy(), chosen, n_pad,
        nu=out.nu[:b, :n].cpu().numpy(),
        beta=host(out.beta) if tel.beta else None,
        watermarks=(_host_watermarks(out.watermarks, num_records, b, n)
                    if tel.watermarks else None))


def simulate_fused(topo: Topology, links: LinkParams, ppm_u, steps: int,
                   kp: float, dt: float = 1e-3, beta_off: float = 0.0,
                   record_every: int = 1, omega_nom: float = OMEGA_NOM,
                   use_ref: bool = False, init=None, ctrl_mask=None,
                   lat_classes=None, edge_w=None,
                   options: Optional[EngineOptions] = None,
                   telemetry: Optional[Telemetry] = None, *,
                   device=None) -> DenseResult:
    """Single-draw fused run; returns (freq_ppm (R, N), psi (N,)).

    ``init`` takes (psi (N,), nu (N,)) or a prior single-draw DenseResult;
    everything else passes through to :func:`simulate_ensemble_dense`
    (``.beta`` is then (R, N), ``.watermarks`` per-node (N,) aggregates).
    """
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
