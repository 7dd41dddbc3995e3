"""The fused bittide engine on Hopper: wrapper, plain version, dispatch.

``bittide_fused`` replaces ``repro/kernels/bittide_step.py::_fused_kernel``
(the resident Pallas engine): ONE launch advances ``num_records ×
record_every`` control periods for a batch of B independent oscillator
draws and decimates the ν telemetry in-kernel.  Per period, with the
step-invariant per-node folds ``deg`` and ``lamsum``:

    err_i = Σ_c [A_c @ (ψ − ν·lat_c)]_i − (ψ_i + β_off)·deg_i + lamsum_i
    ν'_i  = ν_u_i + c_i + ν_u_i·c_i,  c_i = kp·err_i   (held where masked)
    ψ'_i  = ψ_i + ν'_i·Δt

The CUDA kernel is ``csrc/bittide_fused.cu``; its header states its design
and bound.  ``bittide_fused_torch`` is the plain PyTorch version: the same
signature and outputs, the same operations in the same order (nodes summed
one after the other, no fused multiply-add), so on the card the kernel
equals it bit for bit.  The wrapper runs the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

Optional variants (separate template instances in one library):
``record_beta`` — the per-node net occupancy of the post-update state at
every record, ψ centred by its row mean first; ``record_watermarks`` —
per-node max |β| (strict ``>``: the first record reaching it), its record
index, and ν min / max.  The reference's ``record_guard`` variant belongs
to the scenario runner and is not ported yet (ROADMAP queue item 4).

Runtime data never selects a build: kp, β_off, lat, lamsum, mask, Δ, N, B,
C, ``num_records`` and ``record_every`` are kernel arguments.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .api import EngineOutputs

__all__ = ["bittide_fused", "bittide_fused_torch", "select_engine",
           "draws_per_cta", "launch_plan", "FUSED_N_MAX", "KERNEL_N_MAX", "MAX_CLASSES",
           "VARIANTS_USED"]

# The H100 regime table.  A draw's nodes are the threads of one CTA, so the
# kernel holds at most 1024 nodes; the fused regime stops at 256 nodes,
# where one latency class of A (N²·4 bytes = 256 KiB) outgrows the SM's
# shared memory and each period is a chain of 256 dependent multiply-adds
# per class.  Larger dense networks are the tiled lane's (ROADMAP queue 3).
FUSED_N_MAX = 256
KERNEL_N_MAX = 1024
MAX_CLASSES = 8            # latency classes the kernel keeps in registers
THREADS_PER_CTA = 128      # target CTA size for small networks

# Template instances the wrapper selected in this process, keyed by what
# the CUDA side keys on: (record_beta, record_watermarks).  Runtime data
# never enters the key — see telemetry.compile_stats.no_new_compiles.
VARIANTS_USED: set = set()


def select_engine(b: int, n: int, c: int) -> Tuple[str, int]:
    """H100 dispatch: ``("fused", n)`` for n ≤ FUSED_N_MAX nodes and at
    most MAX_CLASSES latency classes, else ``("tiled", 0)`` — the tiled
    lane, which is not ported yet."""
    del b
    if n <= FUSED_N_MAX and c <= MAX_CLASSES:
        return "fused", n
    return "tiled", 0


def draws_per_cta(b: int, n: int, num_sms: int) -> int:
    """Draws per CTA: up to THREADS_PER_CTA threads for small networks,
    fewer while that would leave under four CTAs per SM."""
    g = max(1, THREADS_PER_CTA // n)
    return max(1, min(g, b // (4 * num_sms)))


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("bittide_fused")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bittide_fused_launch.restype = ci
    lib.bittide_fused_launch.argtypes = (
        [vp] * 7 + [ci] + [vp] * 3 + [ctypes.c_float] + [ci] * 7 + [vp] * 9)
    lib.bittide_smem_optin.restype = ci
    lib.bittide_smem_optin.argtypes = []
    return lib


def launch_plan(b: int, n: int, c: int, device) -> dict:
    """How the kernel is launched on ``device`` for B draws of N nodes and
    C classes: draws per CTA, CTAs, threads per CTA, dynamic shared memory,
    and whether the stack A is copied into shared memory (when it fits
    beside the state, up to the device's opt-in limit) or read from L2."""
    optin = _library().bittide_smem_optin()
    if optin < 0:
        raise RuntimeError(f"shared-memory query failed: CUDA error {-optin}")
    g = draws_per_cta(
        b, n, torch.cuda.get_device_properties(device).multi_processor_count)
    state = 4 * (g * c * n + 2 * g * n)
    a_in_smem = state + 4 * c * n * n <= optin
    return dict(draws_per_cta=g, ctas=-(-b // g), threads=g * n,
                smem_bytes=state + (4 * c * n * n if a_in_smem else 0),
                a_in_smem=a_in_smem)


def _check(psi, nu, nu_u, a, deg, lamsum, lat, kp, beta_off, ctrl_mask,
           num_records: int, record_every: int):
    b, n = psi.shape
    c = a.shape[0]
    shapes = {"psi": (psi, (b, n)), "nu": (nu, (b, n)),
              "nu_u": (nu_u, (b, n)), "a": (a, (c, n, n)),
              "deg": (deg, (n,)), "lamsum": (lamsum, (b, n)),
              "lat": (lat, (b, c)), "kp": (kp, (b,)),
              "beta_off": (beta_off, (b,))}
    if ctrl_mask is not None:
        rows = ctrl_mask.shape[0] if ctrl_mask.dim() == 2 else -1
        shapes["ctrl_mask"] = (ctrl_mask, (rows if rows in (1, b) else 1, n))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != psi.device:
            raise ValueError(f"{name} is on {t.device}, psi on {psi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"1..{MAX_CLASSES} latency classes, got {c}")
    if num_records < 1 or record_every < 1:
        raise ValueError("num_records and record_every must be >= 1")


def bittide_fused(psi, nu, nu_u, a, deg, lamsum, lat, kp, beta_off,
                  dt_frames: float, *, num_records: int, record_every: int,
                  ctrl_mask: Optional[torch.Tensor] = None,
                  record_beta: bool = False,
                  record_watermarks: bool = False) -> EngineOutputs:
    """Advance ``num_records * record_every`` control periods in one launch.

    Args:
      psi, nu, nu_u: (B, N) float32 state of B independent draws (ψ in
        frames, ν / ν_u relative frequency offsets).
      a: (C, N, N) float32 adjacency stack, one matrix per latency class.
      deg: (N,) per-node degree Σ_{c,j} A[c, ·, j].
      lamsum: (B, N) per-node λeff fold.
      lat: (B, C) per-draw class latencies in frames.
      kp, beta_off: (B,) per-draw controller gains.
      dt_frames: frames per control period.
      ctrl_mask: None (all on), (1, N) shared or (B, N) per-draw controller
        enables; nodes at ≤ 0.5 hold their ν (clock holdover).
      record_beta / record_watermarks: the kernel variants.

    All tensors float32, contiguous, on one device.  Returns
    :class:`EngineOutputs` — psi, nu (B, N); freq (R, B, N) ν records;
    beta (R, B, N) or None; watermarks (beta_abs_max f32, peak_record
    i32, nu_min f32, nu_max f32), each (B, N), or None.
    """
    _check(psi, nu, nu_u, a, deg, lamsum, lat, kp, beta_off, ctrl_mask,
           num_records, record_every)
    VARIANTS_USED.add((bool(record_beta), bool(record_watermarks)))
    kw = dict(num_records=num_records, record_every=record_every,
              ctrl_mask=ctrl_mask, record_beta=record_beta,
              record_watermarks=record_watermarks)
    if psi.device.type == "cpu":
        return bittide_fused_torch(psi, nu, nu_u, a, deg, lamsum, lat, kp,
                                   beta_off, dt_frames, **kw)
    if psi.device.type != "cuda":
        raise ValueError(f"bittide_fused runs on cuda or cpu tensors, got "
                         f"{psi.device}")
    b, n = psi.shape
    c = a.shape[0]
    if n > KERNEL_N_MAX:
        raise ValueError(f"the fused kernel holds at most {KERNEL_N_MAX} "
                         f"nodes per draw, got {n}")
    plan = launch_plan(b, n, c, psi.device)
    g = plan["draws_per_cta"]

    mask = (torch.ones((1, n), dtype=torch.float32, device=psi.device)
            if ctrl_mask is None else ctrl_mask)
    at = a.transpose(1, 2).contiguous()
    new = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=psi.device)
    psi_out, nu_out = new(b, n), new(b, n)
    freq = new(num_records, b, n)
    beta = new(num_records, b, n) if record_beta else None
    wm = ((new(b, n), new(b, n, dtype=torch.int32), new(b, n), new(b, n))
          if record_watermarks else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _library().bittide_fused_launch(
        ptr(at), ptr(psi), ptr(nu), ptr(nu_u), ptr(kp), ptr(beta_off),
        ptr(mask), mask.shape[0], ptr(deg), ptr(lamsum), ptr(lat),
        float(dt_frames), b, n, c, num_records, record_every, g,
        int(plan["a_in_smem"]), ptr(psi_out), ptr(nu_out), ptr(freq),
        ptr(beta), *(ptr(x) for x in (wm if wm else (None,) * 4)),
        torch.cuda.current_stream(psi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bittide_fused launch failed with CUDA error {rc} "
                           f"(B={b}, N={n}, C={c}, draws per CTA {g})")
    bittide_fused.launches += 1
    return EngineOutputs(psi=psi_out, nu=nu_out, freq=freq, beta=beta,
                         watermarks=wm)


bittide_fused.launches = 0


def _aggregate(a, xs):
    """Σ_c Σ_j A[c, i, j]·x_c[b, j], classes then nodes j summed in order."""
    acc = torch.zeros_like(xs[0])
    for c, x in enumerate(xs):
        part = torch.zeros_like(x)
        for j in range(x.shape[1]):
            part = part + a[c, :, j] * x[:, j:j + 1]
        acc = acc + part
    return acc


def bittide_fused_torch(psi, nu, nu_u, a, deg, lamsum, lat, kp, beta_off,
                        dt_frames: float, *, num_records: int,
                        record_every: int,
                        ctrl_mask: Optional[torch.Tensor] = None,
                        record_beta: bool = False,
                        record_watermarks: bool = False) -> EngineOutputs:
    """The plain PyTorch version of :func:`bittide_fused` (same contract).

    It performs the kernel's float32 operations in the kernel's order:
    each product and sum is its own rounded torch op, and the node sum of
    every class runs j = 0..N-1.
    """
    b, n = psi.shape
    c = a.shape[0]
    mask = (torch.ones((1, n), dtype=torch.float32, device=psi.device)
            if ctrl_mask is None else ctrl_mask)
    enabled = mask > 0.5
    kp_col, boff_col = kp[:, None], beta_off[:, None]
    lats = [lat[:, k:k + 1] for k in range(c)]
    # A tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, the kernel by the true quotient.
    n_t = torch.tensor(float(n), dtype=torch.float32, device=psi.device)
    measure = record_beta or record_watermarks
    freq, betas = [], []
    wm = None
    for t in range(num_records):
        for _ in range(record_every):
            acc = _aggregate(a, [psi - nu * lt for lt in lats])
            err = acc - (psi + boff_col) * deg + lamsum
            c_rel = kp_col * err
            nu_next = nu_u + c_rel + nu_u * c_rel
            nu = torch.where(enabled, nu_next, nu)
            psi = psi + nu * dt_frames
        freq.append(nu)
        if not measure:
            continue
        total = torch.zeros_like(psi[:, 0])
        for j in range(n):
            total = total + psi[:, j]
        psi_c = psi - (total / n_t)[:, None]
        bacc = _aggregate(a, [psi_c - nu * lt for lt in lats])
        bnode = bacc - psi_c * deg + lamsum
        if record_beta:
            betas.append(bnode)
        if record_watermarks:
            babs = bnode.abs()
            if wm is None:
                wm = (babs, torch.zeros_like(babs, dtype=torch.int32), nu, nu)
            else:
                bmax, idx, lo, hi = wm
                wm = (torch.maximum(bmax, babs),
                      torch.where(babs > bmax, torch.full_like(idx, t), idx),
                      torch.minimum(lo, nu), torch.maximum(hi, nu))
    return EngineOutputs(
        psi=psi, nu=nu, freq=torch.stack(freq),
        beta=torch.stack(betas) if record_beta else None, watermarks=wm)
