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

All return a :class:`DenseResult` — the ``(freq_ppm, psi)`` pair with
``.engine`` / ``.tile_j`` metadata, ``.nu`` (the exact final frequencies
for ``init=`` chaining), ``.beta`` (per-node net occupancy records in
frames) and ``.watermarks`` — as host numpy arrays.

Lanes: ``EngineOptions(engine="fused")``, ``"tiled"``, or ``"auto"``
(the H100 regime table, ``select_engine``: fused up to 256 nodes, tiled
above), and ``use_ref=True`` for the plain dense oracle.  The sparse and
per-step lanes raise ``NotImplementedError`` naming their ROADMAP items;
no lane falls back to another.

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
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.frame_model import LinkParams, OMEGA_NOM, broadcast_gain
from repro_torch.core.topology import Topology
from repro_torch.telemetry.api import Telemetry
from repro_torch.telemetry.watermarks import Watermarks

from .api import EngineOptions, EngineOutputs
from .bittide_step import TILE_J, bittide_fused, bittide_tiled, select_engine
from .ref import bittide_dense_multistep_ref

__all__ = ["densify", "latency_classes", "simulate_dense", "simulate_fused",
           "simulate_ensemble_dense", "DenseResult"]

# Beyond this many exact latency classes, densify falls back to quantized
# merging (the dense stack is (C, N, N) — C must stay small).
MAX_EXACT_CLASSES = 8

# Lanes of the reference this port does not have yet, by ROADMAP item.
_UNPORTED = {"sparse": "ROADMAP queue item 5 (sparse lane)",
             "per-step": "ROADMAP queue item 9 (per-step lane)"}


class DenseResult(tuple):
    """``(freq_ppm, psi)`` pair with engine-dispatch metadata attached.

    ``.engine`` names the lane (``"fused"`` | ``"tiled"`` | ``"ref"``),
    ``.tile_j`` the adjacency panel width in nodes (N on the fused lane,
    which keeps the whole stack; the tiled kernel's panel width, at most
    ``TILE_J``, on the tiled lane).  ``.nu`` carries the exact final relative frequencies
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
                  lam_t=None) -> EngineOutputs:
    """One run of a dense lane: ``engine`` is the chosen lane ("fused",
    "tiled", or "ref" for the dense oracle).

    psi, nu, nu_u: (B, N) state; kp, beta_off: (B,) gains; ctrl_mask:
    (1 | B, N); a_t: (C, N, N) stack in the kernels' layout with its
    degree fold deg (N,); lamsum: (B, N); lat: (B, C).  The oracle reads
    the dense λeff ``lam_t`` (same layout) instead of ``lamsum``.  With
    ``record_guard``, guard_lo / guard_hi (B,) and the int guard_stop feed
    the in-kernel guard (``EngineOutputs.guard_state``).  Watermarks are
    (beta_abs_max, peak_record, nu_min, nu_max).
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
    kernel = {"fused": bittide_fused, "tiled": bittide_tiled}[engine]
    return kernel(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off,
                  dt_frames, num_records=num_records,
                  record_every=record_every, ctrl_mask=ctrl_mask,
                  record_beta=record_beta,
                  record_watermarks=record_watermarks,
                  record_guard=record_guard, guard_lo=guard_lo,
                  guard_hi=guard_hi, guard_stop=guard_stop)


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
      edge_w: optional (E,) edge weights (0 = dropped link).  Per-draw
        (B, E) weights need the sparse lane, which is not ported.
      options: :class:`EngineOptions`; ``engine`` is "auto" (the H100
        regime table), "fused" or "tiled".
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
    if engine in _UNPORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: {_UNPORTED[engine]}")
    if engine not in ("auto", "fused", "tiled"):
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
        if chosen not in ("fused", "tiled"):
            raise NotImplementedError(
                f"N={n}, C={c} is outside the fused and tiled regimes and "
                f"the {chosen} lane is not ported yet: {_UNPORTED[chosen]}")
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
