"""The dense bittide engines on Hopper: wrappers, plain versions, dispatch.

Two kernels advance ``num_records × record_every`` control periods for a
batch of B independent oscillator draws and decimate the ν telemetry
in-kernel.  Per period, with the step-invariant per-node folds ``deg``
and ``lamsum``:

    err_i = Σ_c [A_c @ (ψ − ν·lat_c)]_i − (ψ_i + β_off)·deg_i + lamsum_i
    ν'_i  = ν_u_i + c_i + ν_u_i·c_i,  c_i = kp·err_i   (held where masked)
    ψ'_i  = ψ_i + ν'_i·Δt

``bittide_fused`` (``csrc/bittide_fused.cu``) replaces
``repro/kernels/bittide_step.py::_fused_kernel``: one launch, each CTA
owns whole draws and loops over every period itself.  ``bittide_tiled``
(``csrc/bittide_tiled.cu``) replaces ``_tiled_kernel``, the lane for dense
networks beyond the fused regime: one launch per period (the launch loop
runs in C), the stack streamed from device memory in panels.
``bittide_perstep`` (``csrc/bittide_step.cu``) replaces ``_kernel``, the
reference's per-step lane: one draw, one launch per period (the record
loop runs in C), one thread per node.  The sources' headers state each
design and bound.

The kernels sum every (b, i) in one order — classes in order, nodes
j = 0..N-1 in order, no fused multiply-add — so a draw's bits depend
neither on B nor on the kernel, and the plain PyTorch versions
``bittide_fused_torch`` / ``bittide_tiled_torch`` (one function: the two
kernels compute the same thing in the same order) and
``bittide_perstep_torch`` (the same period and measure pass on one draw)
equal them bit for bit.
A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises.

The stack is passed in the kernels' layout, source-major: ``a_t[c, j, i]
= A[c, i, j]``, the weight of the edge j → i in latency class c, as
:func:`repro_torch.kernels.densify` returns it.  Callers build it once per
stack.

Optional variants: ``record_beta`` — the per-node net occupancy of the
post-update state at every record, ψ centred by its row mean first;
``record_watermarks`` — per-node max |β| (strict ``>``: the first record
reaching it), its record index, and ν min / max; ``record_guard`` — the
reframing guard: a draw trips at the first record at which any node's β
leaves the band ``[guard_lo·deg_i, guard_hi·deg_i]``; from the batch's
earliest trip t* on, and after ``guard_stop``, no record runs, and
``EngineOutputs.guard_state`` holds the (B, 1) int32 trip records
(``num_records`` where a draw never tripped).  Records after
min(t*, guard_stop) are NaN.

Runtime data never selects a build: kp, β_off, lat, lamsum, mask, Δ, N, B,
C, ``num_records``, ``record_every``, the guard band and the stop cap are
kernel arguments.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .api import EngineOutputs

__all__ = ["bittide_fused", "bittide_fused_torch", "bittide_perstep",
           "bittide_perstep_torch", "bittide_tiled",
           "bittide_tiled_torch", "select_engine", "draws_per_cta",
           "launch_plan", "tiled_launch_plan", "FUSED_N_MAX", "KERNEL_N_MAX",
           "MAX_CLASSES", "SPARSE_TILE", "TILE_I", "TILE_J",
           "TILED_STACK_BYTES_MAX", "VARIANTS_USED", "sparse_bytes",
           "sparse_tile"]

# The H100 regime table.
# * fused: a draw's nodes are the threads of one CTA, so the kernel holds
#   at most 1024 nodes; the regime stops at 256 nodes, where one latency
#   class of A (N²·4 bytes = 256 KiB) outgrows the SM's shared memory and
#   each period is a chain of 256 dependent multiply-adds per class.
# * tiled: above 256 nodes, while the stack (C·N²·4 bytes) fits in device
#   memory beside the state — TILED_STACK_BYTES_MAX leaves 16 GiB of the
#   H100's 80 GB to everything else.  Each period streams the whole stack
#   (memory-bound: torus3d(22), 453.5 MB per pass).
# * sparse: beyond the tiled regime, for a caller that gives the degree
#   bound (the ELL slot count K), while the O(K·N) tables and the O(B·N)
#   state fit the same budget: one period reads (4 + 8)·K·N bytes of
#   tables, not a stack.
# * beyond: the per-step lane (one draw per launch, the stack read from
#   device memory every period) — on this card the stack no longer fits
#   there either, so in practice a caller reaches the lane by name.
FUSED_N_MAX = 256
KERNEL_N_MAX = 1024
MAX_CLASSES = 8            # latency classes the fused kernel keeps in registers
THREADS_PER_CTA = 128      # target CTA size for small networks
TILE_I = 32                # tiled kernel: destination rows per CTA
TILE_J = 64                # tiled kernel: source nodes per panel
TILED_GROUP_MAX = 8        # tiled kernel: draws per CTA
TILED_DRAWS_PER_WARP = 4   # tiled kernel: accumulators per thread
TILED_STACK_BYTES_MAX = 64 * 2**30
SPARSE_TILE = 256          # sparse kernel: nodes per CTA, one draw per CTA

# Kernel instances the wrappers selected in this process, keyed by what
# the CUDA side keys on: (kernel, record_beta, record_watermarks,
# record_guard).  Runtime data never enters the key — see
# telemetry.compile_stats.no_new_compiles.
VARIANTS_USED: set = set()


def sparse_tile(n: int) -> int:
    """The sparse kernel's nodes per CTA for N nodes: SPARSE_TILE, or N
    rounded up to a warp when the network is smaller."""
    return min(SPARSE_TILE, -(-n // 32) * 32)


def sparse_bytes(b: int, n: int, k: int) -> int:
    """Device bytes of a sparse-lane call beside its records: the shared
    tables (nbr, latf, w) and ten (B, N) float32 state arrays (ψ / ν in
    and the ping-pong pair, ν_u, lamsum, mask)."""
    return 12 * k * n + 40 * b * n


def select_engine(b: int, n: int, c: int,
                  max_deg: Optional[int] = None) -> Tuple[str, int]:
    """H100 dispatch: ``("fused", n)`` for n ≤ FUSED_N_MAX nodes and at
    most MAX_CLASSES latency classes; else ``("tiled", panel width)``
    while the stack fits TILED_STACK_BYTES_MAX; else, when the caller
    gives the ELL slot count ``max_deg`` and the sparse lane's tables and
    state fit the same budget, ``("sparse", nodes per CTA)`` (at C = 1:
    N > 131,072); else ``("per-step", 0)``, the reference's last lane
    (:func:`bittide_perstep`), which ``engine="per-step"`` also selects
    by name."""
    if n <= FUSED_N_MAX and c <= MAX_CLASSES:
        return "fused", n
    if 4 * c * n * n <= TILED_STACK_BYTES_MAX:
        return "tiled", min(TILE_J, n)
    if max_deg is not None and \
            sparse_bytes(b, n, int(max_deg)) <= TILED_STACK_BYTES_MAX:
        return "sparse", sparse_tile(n)
    return "per-step", 0


def draws_per_cta(b: int, n: int, num_sms: int) -> int:
    """Draws per CTA: up to THREADS_PER_CTA threads for small networks,
    fewer while that would leave under four CTAs per SM."""
    g = max(1, THREADS_PER_CTA // n)
    return max(1, min(g, b // (4 * num_sms)))


def _library(name: str) -> ctypes.CDLL:
    """A built kernel library with its C signatures declared."""
    lib = build.load(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "bittide_fused":
        lib.bittide_fused_launch.restype = ci
        lib.bittide_fused_launch.argtypes = (
            [vp] * 7 + [ci] + [vp] * 3 + [cf] + [ci] * 7 + [vp] * 10
            + [ci, vp, vp])
        lib.bittide_smem_optin.restype = ci
        lib.bittide_smem_optin.argtypes = []
    elif name == "bittide_step":
        lib.bittide_step_launch.restype = ci
        lib.bittide_step_launch.argtypes = (
            [vp] * 6 + [cf] * 3 + [ci] * 5 + [vp] * 8 + [cf] * 2
            + [vp] * 3)
    elif name == "bittide_tiled":
        lib.bittide_tiled_launch.restype = ci
        lib.bittide_tiled_launch.argtypes = (
            [vp] * 5 + [ci] + [vp] * 3 + [cf] + [ci] * 7 + [vp] * 14)
    else:
        cll = ctypes.c_longlong
        lib.bittide_sparse_launch.restype = ci
        lib.bittide_sparse_launch.argtypes = (
            [vp, vp, cll, vp, cll] + [vp] * 4 + [ci, vp, cf] + [ci] * 7
            + [vp] * 15)
    return lib


def launch_plan(b: int, n: int, c: int, device, guard: bool = False) -> dict:
    """How the fused kernel is launched on ``device`` for B draws of N
    nodes and C classes: draws per CTA, CTAs, threads per CTA, dynamic
    shared memory, and whether the stack A is copied into shared memory
    (when it fits beside the state, up to the device's opt-in limit) or
    read from L2.  The guard variant adds one int per draw."""
    optin = _library("bittide_fused").bittide_smem_optin()
    if optin < 0:
        raise RuntimeError(f"shared-memory query failed: CUDA error {-optin}")
    g = draws_per_cta(
        b, n, torch.cuda.get_device_properties(device).multi_processor_count)
    state = 4 * (g * c * n + 2 * g * n + (g if guard else 0))
    a_in_smem = state + 4 * c * n * n <= optin
    return dict(draws_per_cta=g, ctas=-(-b // g), threads=g * n,
                smem_bytes=state + (4 * c * n * n if a_in_smem else 0),
                a_in_smem=a_in_smem)


def tiled_launch_plan(b: int, n: int) -> dict:
    """How the tiled kernel is launched for B draws of N nodes: CTAs of
    TILE_I destination rows × up to TILED_GROUP_MAX draws (one warp per
    TILED_DRAWS_PER_WARP draws), panels of TILE_J source nodes, one launch
    per period and two per measure pass."""
    g = min(TILED_GROUP_MAX, b)
    return dict(draws_per_cta=g, grid=(-(-n // TILE_I), -(-b // g)),
                threads=TILE_I * -(-g // TILED_DRAWS_PER_WARP),
                tile_i=TILE_I, tile_j=TILE_J, panels=-(-n // TILE_J))


def _check(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off, ctrl_mask,
           num_records: int, record_every: int, guard):
    b, n = psi.shape
    c = a_t.shape[0]
    shapes = {"psi": (psi, (b, n)), "nu": (nu, (b, n)),
              "nu_u": (nu_u, (b, n)), "a_t": (a_t, (c, n, n)),
              "deg": (deg, (n,)), "lamsum": (lamsum, (b, n)),
              "lat": (lat, (b, c)), "kp": (kp, (b,)),
              "beta_off": (beta_off, (b,))}
    if ctrl_mask is not None:
        rows = ctrl_mask.shape[0] if ctrl_mask.dim() == 2 else -1
        shapes["ctrl_mask"] = (ctrl_mask, (rows if rows in (1, b) else 1, n))
    if guard is not None and all(x is not None for x in guard):
        shapes["guard_lo"] = (guard[0], (b,))
        shapes["guard_hi"] = (guard[1], (b,))
    _validate(shapes, psi.device, c, num_records, record_every, guard)


def _validate(shapes: dict, device, c: int, num_records: int,
              record_every: int, guard) -> None:
    """Raise on a tensor of ``shapes`` (name -> (tensor, shape)) that is
    not float32, contiguous, of its shape and on ``device``, on no latency
    class, on an empty run, or on a guard without its band or stop cap."""
    if guard is not None and any(x is None for x in guard):
        raise ValueError("record_guard=True requires guard_lo, guard_hi "
                         "and guard_stop")
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, psi on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c < 1:
        raise ValueError("at least one latency class")
    if num_records < 1 or record_every < 1:
        raise ValueError("num_records and record_every must be >= 1")


def _device_kind(psi, kernel: str) -> str:
    if psi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on cuda or cpu tensors, got "
                         f"{psi.device}")
    return psi.device.type


def _outputs(b, n, num_records, dev, record_beta, record_watermarks,
             record_guard):
    """Output tensors of a launch: ν (and β) records, NaN where a guard
    freeze may leave records unrun; the four watermark accumulators."""
    new = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=dev)
    rec = ((lambda: torch.full((num_records, b, n), float("nan"),
                               device=dev)) if record_guard
           else (lambda: new(num_records, b, n)))
    wm = ((new(b, n), new(b, n, dtype=torch.int32), new(b, n), new(b, n))
          if record_watermarks else None)
    return rec(), rec() if record_beta else None, wm


_ptr = lambda t: None if t is None else t.data_ptr()


def bittide_fused(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off,
                  dt_frames: float, *, num_records: int, record_every: int,
                  ctrl_mask: Optional[torch.Tensor] = None,
                  record_beta: bool = False,
                  record_watermarks: bool = False,
                  record_guard: bool = False,
                  guard_lo: Optional[torch.Tensor] = None,
                  guard_hi: Optional[torch.Tensor] = None,
                  guard_stop: Optional[int] = None) -> EngineOutputs:
    """Advance ``num_records * record_every`` control periods in one launch.

    Args:
      psi, nu, nu_u: (B, N) float32 state of B independent draws (ψ in
        frames, ν / ν_u relative frequency offsets).
      a_t: (C, N, N) float32 stack in kernel layout, ``a_t[c, j, i] =
        A[c, i, j]`` (one matrix per latency class).
      deg: (N,) per-node degree Σ_{c,j} A[c, ·, j] (``a_t.sum((0, 1))``).
      lamsum: (B, N) per-node λeff fold.
      lat: (B, C) per-draw class latencies in frames.
      kp, beta_off: (B,) per-draw controller gains.
      dt_frames: frames per control period.
      ctrl_mask: None (all on), (1, N) shared or (B, N) per-draw controller
        enables; nodes at ≤ 0.5 hold their ν (clock holdover).
      record_beta / record_watermarks / record_guard: the kernel variants.
      guard_lo, guard_hi: (B,) guard band in frames per unit degree, and
        guard_stop: the last record to run (an int) — with record_guard.

    All tensors float32, contiguous, on one device.  Returns
    :class:`EngineOutputs` — psi, nu (B, N); freq (R, B, N) ν records;
    beta (R, B, N) or None; watermarks (beta_abs_max f32, peak_record
    i32, nu_min f32, nu_max f32), each (B, N), or None; guard_state (B, 1)
    int32 trip records or None.

    Guard on the card: each draw freezes at its own first trip; when a
    draw ran past the earliest trip t*, the chunk is launched once more
    from the same inputs with the stop cap at t* (the batch-wide freeze,
    bit for bit, since a draw's bits do not depend on the batch).  Reading
    the trip records synchronizes with the card.
    """
    guard = (guard_lo, guard_hi, guard_stop) if record_guard else None
    _check(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off, ctrl_mask,
           num_records, record_every, guard)
    if a_t.shape[0] > MAX_CLASSES:
        raise ValueError(f"the fused kernel takes 1..{MAX_CLASSES} latency "
                         f"classes, got {a_t.shape[0]}")
    VARIANTS_USED.add(("fused", bool(record_beta), bool(record_watermarks),
                       bool(record_guard)))
    kw = dict(num_records=num_records, record_every=record_every,
              ctrl_mask=ctrl_mask, record_beta=record_beta,
              record_watermarks=record_watermarks, record_guard=record_guard,
              guard_lo=guard_lo, guard_hi=guard_hi, guard_stop=guard_stop)
    if _device_kind(psi, "bittide_fused") == "cpu":
        return bittide_fused_torch(psi, nu, nu_u, a_t, deg, lamsum, lat, kp,
                                   beta_off, dt_frames, **kw)
    b, n = psi.shape
    c = a_t.shape[0]
    if n > KERNEL_N_MAX:
        raise ValueError(f"the fused kernel holds at most {KERNEL_N_MAX} "
                         f"nodes per draw, got {n}")
    plan = launch_plan(b, n, c, psi.device, guard=record_guard)
    g = plan["draws_per_cta"]
    mask = (torch.ones((1, n), dtype=torch.float32, device=psi.device)
            if ctrl_mask is None else ctrl_mask)
    psi_out = torch.empty_like(psi)
    nu_out = torch.empty_like(psi)
    freq, beta, wm = _outputs(b, n, num_records, psi.device, record_beta,
                              record_watermarks, record_guard)
    trip = (torch.empty(b, dtype=torch.int32, device=psi.device)
            if record_guard else None)

    def launch(stop: int):
        rc = _library("bittide_fused").bittide_fused_launch(
            _ptr(a_t), _ptr(psi), _ptr(nu), _ptr(nu_u), _ptr(kp),
            _ptr(beta_off), _ptr(mask), mask.shape[0], _ptr(deg),
            _ptr(lamsum), _ptr(lat), float(dt_frames), b, n, c, num_records,
            record_every, g, int(plan["a_in_smem"]), _ptr(psi_out),
            _ptr(nu_out), _ptr(freq), _ptr(beta),
            *(_ptr(x) for x in (wm if wm else (None,) * 4)),
            _ptr(guard_lo), _ptr(guard_hi), int(stop), _ptr(trip),
            torch.cuda.current_stream(psi.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"bittide_fused launch failed with CUDA error {rc} (B={b}, "
                f"N={n}, C={c}, draws per CTA {g})")
        bittide_fused.launches += 1

    stop = int(guard_stop) if record_guard else num_records - 1
    launch(stop)
    if record_guard:
        trips = trip.cpu()
        tstar = int(trips.min())
        if tstar <= stop and bool((trips != tstar).any()):
            # Some draw ran past the batch's earliest trip: replay the
            # chunk with the stop cap at t*.
            freq.fill_(float("nan"))
            if beta is not None:
                beta.fill_(float("nan"))
            launch(tstar)
    return EngineOutputs(psi=psi_out, nu=nu_out, freq=freq, beta=beta,
                         watermarks=wm,
                         guard_state=None if trip is None else trip[:, None])


bittide_fused.launches = 0


def bittide_tiled(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off,
                  dt_frames: float, *, num_records: int, record_every: int,
                  ctrl_mask: Optional[torch.Tensor] = None,
                  record_beta: bool = False,
                  record_watermarks: bool = False,
                  record_guard: bool = False,
                  guard_lo: Optional[torch.Tensor] = None,
                  guard_hi: Optional[torch.Tensor] = None,
                  guard_stop: Optional[int] = None) -> EngineOutputs:
    """The tiled engine: same contract as :func:`bittide_fused`, for
    networks beyond the fused regime (any N, any number of classes).

    On the card it launches the tiled kernel once per period and twice
    per record's measure pass (all from one C call, on the current stream,
    with no sync); the state lives in a ping-pong pair in device memory,
    and the guard's batch-wide freeze is one device-resident word that
    every launch reads first.  ``launches`` counts calls that launched.
    """
    guard = (guard_lo, guard_hi, guard_stop) if record_guard else None
    _check(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off, ctrl_mask,
           num_records, record_every, guard)
    VARIANTS_USED.add(("tiled", bool(record_beta), bool(record_watermarks),
                       bool(record_guard)))
    kw = dict(num_records=num_records, record_every=record_every,
              ctrl_mask=ctrl_mask, record_beta=record_beta,
              record_watermarks=record_watermarks, record_guard=record_guard,
              guard_lo=guard_lo, guard_hi=guard_hi, guard_stop=guard_stop)
    if _device_kind(psi, "bittide_tiled") == "cpu":
        return bittide_tiled_torch(psi, nu, nu_u, a_t, deg, lamsum, lat, kp,
                                   beta_off, dt_frames, **kw)
    b, n = psi.shape
    c = a_t.shape[0]
    dev = psi.device
    g = tiled_launch_plan(b, n)["draws_per_cta"]
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
    mean = torch.empty(b, dtype=torch.float32, device=dev)
    last = (min(num_records - 1, int(guard_stop)) if record_guard
            else num_records - 1)
    rc = _library("bittide_tiled").bittide_tiled_launch(
        _ptr(a_t), _ptr(nu_u), _ptr(kp), _ptr(beta_off), _ptr(mask),
        mask.shape[0], _ptr(deg), _ptr(lamsum), _ptr(lat), float(dt_frames),
        b, n, c, num_records, record_every, last, g, _ptr(psi_buf),
        _ptr(nu_buf), _ptr(freq), _ptr(beta),
        *(_ptr(x) for x in (wm if wm else (None,) * 4)), _ptr(guard_lo),
        _ptr(guard_hi), _ptr(trip), _ptr(trip_min), _ptr(mean),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bittide_tiled launch failed with CUDA error {rc} "
                           f"(B={b}, N={n}, C={c}, draws per CTA {g})")
    bittide_tiled.launches += 1
    slot = (max(last + 1, 0) * record_every) % 2
    return EngineOutputs(psi=psi_buf[slot], nu=nu_buf[slot], freq=freq,
                         beta=beta, watermarks=wm,
                         guard_state=None if trip is None else trip[:, None])


bittide_tiled.launches = 0


def _check_perstep(psi, nu, nu_u, a_t, deg, lamsum, lat, ctrl_mask,
                   num_records: int, record_every: int, guard):
    n = psi.shape[-1]
    c = a_t.shape[0] if a_t.dim() == 3 else 0
    shapes = {"psi": (psi, (n,)), "nu": (nu, (n,)), "nu_u": (nu_u, (n,)),
              "a_t": (a_t, (c, n, n)), "deg": (deg, (n,)),
              "lamsum": (lamsum, (n,)), "lat": (lat, (c,))}
    if ctrl_mask is not None:
        shapes["ctrl_mask"] = (ctrl_mask, (n,))
    _validate(shapes, psi.device, c, num_records, record_every, guard)


def bittide_perstep(psi, nu, nu_u, a_t, deg, lamsum, lat, kp: float,
                    beta_off: float, dt_frames: float, *,
                    num_records: int, record_every: int,
                    ctrl_mask: Optional[torch.Tensor] = None,
                    record_beta: bool = False,
                    record_watermarks: bool = False,
                    record_guard: bool = False,
                    guard_lo: Optional[float] = None,
                    guard_hi: Optional[float] = None,
                    guard_stop: Optional[int] = None) -> EngineOutputs:
    """The per-step engine: ONE draw, one kernel launch per period.

    Args:
      psi, nu, nu_u: (N,) float32 state of the draw.
      a_t: (C, N, N) float32 stack in kernel layout (``a_t[c, j, i] =
        A[c, i, j]``); deg: its (N,) degree fold; lamsum: (N,) λeff fold.
      lat: (C,) class latencies in frames.
      kp, beta_off, dt_frames: the draw's gains and frames per period
        (Python floats, passed to the kernel as float32 arguments).
      ctrl_mask: None (all on) or (N,) controller enables; nodes at ≤ 0.5
        hold their ν.
      record_beta / record_watermarks / record_guard: the measure pass's
        outputs; guard_lo, guard_hi: the guard band in frames per unit
        degree (floats), guard_stop: the last record to run.

    Returns :class:`EngineOutputs` — psi, nu (N,); freq (R, N) ν records;
    beta (R, N) or None; watermarks, each (N,), or None; guard_state the
    0-dim int32 trip record (``num_records`` when the draw never tripped)
    or None.  Records after the trip or after ``guard_stop`` are frozen:
    ν re-emits the frozen state's ν and β is zero, as in the reference.

    On the card every period and both launches of each record's measure
    pass (the row mean, then β) run from one C call on the current
    stream with no sync; ``launches`` counts the kernels that call
    launched.
    """
    guard = (guard_lo, guard_hi, guard_stop) if record_guard else None
    _check_perstep(psi, nu, nu_u, a_t, deg, lamsum, lat, ctrl_mask,
                   num_records, record_every, guard)
    VARIANTS_USED.add(("per-step", bool(record_beta),
                       bool(record_watermarks), bool(record_guard)))
    kw = dict(num_records=num_records, record_every=record_every,
              ctrl_mask=ctrl_mask, record_beta=record_beta,
              record_watermarks=record_watermarks, record_guard=record_guard,
              guard_lo=guard_lo, guard_hi=guard_hi, guard_stop=guard_stop)
    if _device_kind(psi, "bittide_perstep") == "cpu":
        return bittide_perstep_torch(psi, nu, nu_u, a_t, deg, lamsum, lat,
                                     kp, beta_off, dt_frames, **kw)
    n = psi.shape[0]
    c = a_t.shape[0]
    dev = psi.device
    mask = (torch.ones(n, dtype=torch.float32, device=dev)
            if ctrl_mask is None else ctrl_mask)
    psi_buf = torch.empty((2, n), dtype=torch.float32, device=dev)
    nu_buf = torch.empty_like(psi_buf)
    psi_buf[0].copy_(psi)
    nu_buf[0].copy_(nu)
    freq = torch.empty((num_records, n), dtype=torch.float32, device=dev)
    beta = torch.empty_like(freq) if record_beta else None
    new = lambda dtype=torch.float32: torch.empty(n, dtype=dtype, device=dev)
    wm = ((new(), new(torch.int32), new(), new()) if record_watermarks
          else None)
    trip = (torch.full((), num_records, dtype=torch.int32, device=dev)
            if record_guard else None)
    mean = torch.empty(1, dtype=torch.float32, device=dev)
    measure = record_beta or record_watermarks or record_guard
    last = (min(num_records - 1, int(guard_stop)) if record_guard
            else num_records - 1)
    rc = _library("bittide_step").bittide_step_launch(
        _ptr(a_t), _ptr(nu_u), _ptr(mask), _ptr(deg), _ptr(lamsum),
        _ptr(lat), float(kp), float(beta_off), float(dt_frames), n, c,
        num_records, record_every, last, _ptr(psi_buf), _ptr(nu_buf),
        _ptr(freq), _ptr(beta),
        *(_ptr(x) for x in (wm if wm else (None,) * 4)),
        float(guard_lo) if record_guard else 0.0,
        float(guard_hi) if record_guard else 0.0, _ptr(trip), _ptr(mean),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bittide_step launch failed with CUDA error {rc} "
                           f"(N={n}, C={c})")
    ran = max(last + 1, 0)
    bittide_perstep.launches += ran * (record_every + (2 if measure else 0))
    slot = (ran * record_every) % 2
    psi_out, nu_out = psi_buf[slot], nu_buf[slot]
    if ran < num_records:
        # Records past the stop cap re-emit the frozen state.
        freq[ran:] = nu_out
        if beta is not None:
            beta[ran:] = 0.0
    return EngineOutputs(psi=psi_out, nu=nu_out, freq=freq, beta=beta,
                         watermarks=wm, guard_state=trip)


bittide_perstep.launches = 0


def _aggregate(a_t, xs):
    """Σ_c Σ_j A[c, i, j]·x_c[b, j], classes then nodes j summed in order
    (``a_t[c, j]`` is column j of A_c)."""
    acc = torch.zeros_like(xs[0])
    for c, x in enumerate(xs):
        part = torch.zeros_like(x)
        for j in range(x.shape[1]):
            part.add_(a_t[c, j] * x[:, j:j + 1])
        acc = acc + part
    return acc


def _period_torch(psi, nu, nu_u, a_t, deg, lamsum, lats, kp_col, boff_col,
                  enabled, dt_frames: float):
    """One control period of the plain versions, in the kernels' order."""
    acc = _aggregate(a_t, [psi - nu * lt for lt in lats])
    err = acc - (psi + boff_col) * deg + lamsum
    c_rel = kp_col * err
    nu_next = torch.where(enabled, nu_u + c_rel + nu_u * c_rel, nu)
    return psi + nu_next * dt_frames, nu_next


def _measure_torch(psi, nu, a_t, deg, lamsum, lats):
    """The measure pass of the plain versions: β of the state with ψ
    centred by its row mean (summed j = 0..N-1 in order)."""
    n = psi.shape[1]
    # A tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, the kernels by the true quotient.
    n_t = torch.tensor(float(n), dtype=torch.float32, device=psi.device)
    total = torch.zeros_like(psi[:, 0])
    for j in range(n):
        total = total + psi[:, j]
    psi_c = psi - (total / n_t)[:, None]
    return _aggregate(a_t, [psi_c - nu * lt for lt in lats]) \
        - psi_c * deg + lamsum


def _fold_watermarks(wm, bnode, nu, t: int):
    """Running (max |β|, its first record, ν min, ν max) after record t."""
    babs = bnode.abs()
    if wm is None:
        return babs, torch.zeros_like(babs, dtype=torch.int32), nu, nu
    bmax, idx, lo, hi = wm
    return (torch.maximum(bmax, babs),
            torch.where(babs > bmax, torch.full_like(idx, t), idx),
            torch.minimum(lo, nu), torch.maximum(hi, nu))


def bittide_fused_torch(psi, nu, nu_u, a_t, deg, lamsum, lat, kp, beta_off,
                        dt_frames: float, *, num_records: int,
                        record_every: int,
                        ctrl_mask: Optional[torch.Tensor] = None,
                        record_beta: bool = False,
                        record_watermarks: bool = False,
                        record_guard: bool = False,
                        guard_lo: Optional[torch.Tensor] = None,
                        guard_hi: Optional[torch.Tensor] = None,
                        guard_stop: Optional[int] = None) -> EngineOutputs:
    """The plain PyTorch version of :func:`bittide_fused` and
    :func:`bittide_tiled` (same contract).

    It performs the kernels' float32 operations in the kernels' order:
    each product and sum is its own rounded torch op, and the node sum of
    every class runs j = 0..N-1.  The guard freezes the batch directly:
    record t runs while min(trip) ≥ t and t ≤ guard_stop.
    """
    b, n = psi.shape
    c = a_t.shape[0]
    mask = (torch.ones((1, n), dtype=torch.float32, device=psi.device)
            if ctrl_mask is None else ctrl_mask)
    enabled = mask > 0.5
    kp_col, boff_col = kp[:, None], beta_off[:, None]
    lats = [lat[:, k:k + 1] for k in range(c)]
    measure = record_beta or record_watermarks or record_guard
    nan = float("nan")
    freq = torch.full((num_records, b, n), nan, device=psi.device)
    beta = (torch.full((num_records, b, n), nan, device=psi.device)
            if record_beta else None)
    trip = torch.full((b,), num_records, dtype=torch.int32,
                      device=psi.device)
    wm = None
    for t in range(num_records):
        if record_guard and (int(trip.min()) < t or t > guard_stop):
            break
        for _ in range(record_every):
            psi, nu = _period_torch(psi, nu, nu_u, a_t, deg, lamsum, lats,
                                    kp_col, boff_col, enabled, dt_frames)
        freq[t] = nu
        if not measure:
            continue
        bnode = _measure_torch(psi, nu, a_t, deg, lamsum, lats)
        if record_beta:
            beta[t] = bnode
        if record_watermarks:
            wm = _fold_watermarks(wm, bnode, nu, t)
        if record_guard:
            viol = ((bnode > guard_hi[:, None] * deg)
                    | (bnode < guard_lo[:, None] * deg)).any(dim=1)
            trip = torch.where(viol, torch.full_like(trip, t), trip)
    return EngineOutputs(psi=psi, nu=nu, freq=freq, beta=beta,
                         watermarks=wm,
                         guard_state=trip[:, None] if record_guard else None)


# The tiled kernel sums in the fused kernel's order: one plain version.
bittide_tiled_torch = bittide_fused_torch


def bittide_perstep_torch(psi, nu, nu_u, a_t, deg, lamsum, lat, kp: float,
                          beta_off: float, dt_frames: float, *,
                          num_records: int, record_every: int,
                          ctrl_mask: Optional[torch.Tensor] = None,
                          record_beta: bool = False,
                          record_watermarks: bool = False,
                          record_guard: bool = False,
                          guard_lo: Optional[float] = None,
                          guard_hi: Optional[float] = None,
                          guard_stop: Optional[int] = None) -> EngineOutputs:
    """The plain PyTorch version of :func:`bittide_perstep` (same
    contract): the fused plain version's period and measure pass on one
    draw, with the reference's per-draw freeze — record t runs while the
    draw has not tripped and t ≤ guard_stop; a frozen record re-emits the
    frozen ν and a zero β."""
    n = psi.shape[0]
    dev = psi.device
    f32 = lambda x: torch.tensor([[float(x)]], dtype=torch.float32,
                                 device=dev)
    row = lambda x: x.reshape(1, n)
    psi, nu, nu_u, lamsum = row(psi), row(nu), row(nu_u), row(lamsum)
    enabled = (torch.ones((1, n), dtype=torch.bool, device=dev)
               if ctrl_mask is None else row(ctrl_mask) > 0.5)
    lats = [lat[k:k + 1].reshape(1, 1) for k in range(a_t.shape[0])]
    kp_col, boff_col = f32(kp), f32(beta_off)
    freq = torch.empty((num_records, n), dtype=torch.float32, device=dev)
    beta = torch.empty_like(freq) if record_beta else None
    trip = num_records
    wm = None
    for t in range(num_records):
        if record_guard and (trip < num_records or t > guard_stop):
            freq[t] = nu[0]
            if beta is not None:
                beta[t] = 0.0
            continue
        for _ in range(record_every):
            psi, nu = _period_torch(psi, nu, nu_u, a_t, deg, lamsum, lats,
                                    kp_col, boff_col, enabled, dt_frames)
        freq[t] = nu[0]
        if not (record_beta or record_watermarks or record_guard):
            continue
        bnode = _measure_torch(psi, nu, a_t, deg, lamsum, lats)
        if record_beta:
            beta[t] = bnode[0]
        if record_watermarks:
            wm = _fold_watermarks(wm, bnode, nu, t)
        if record_guard and bool(((bnode > f32(guard_hi) * deg)
                                  | (bnode < f32(guard_lo) * deg)).any()):
            trip = t
    return EngineOutputs(
        psi=psi[0], nu=nu[0], freq=freq, beta=beta,
        watermarks=None if wm is None else tuple(x[0] for x in wm),
        guard_state=(torch.tensor(trip, dtype=torch.int32, device=dev)
                     if record_guard else None))
