"""Plain-torch oracle for the fused bittide step (port of ``repro.kernels.ref``).

Dense-adjacency formulation of one control period of the abstract frame
model:

    β[c,i,j]  = A[c,i,j] · (ψ_j − ν_j·lat_c − ψ_i) + λeff[c,i,j]
    err_i     = Σ_{c,j} (β[c,i,j] − A[c,i,j]·β_off)
    ν'_i      = (1 + ν_u_i)(1 + kp·err_i) − 1
    ψ'_i      = ψ_i + ν'_i · Δt_frames

The oracle materializes the full per-edge occupancy tensor, so it has none
of the fused kernel's ``−ψ_i·deg_i`` cancellation: it is the independent
dense check of the ``use_ref=True`` lane.  Every function takes a leading
draw axis B written out (state (B, N), per-draw gains (B,), class
latencies (C,) or (B, C), mask (N,) or (B, N)) and the stack and λeff in
the kernels' source-major layout (``a_t[c, j, i] = A[c, i, j]``, as
:func:`repro_torch.kernels.densify` returns them).
"""
from __future__ import annotations

import torch

__all__ = ["bittide_dense_step_ref", "bittide_dense_multistep_ref",
           "occupancy_ref", "node_occupancy_ref"]


def _lat_rows(lat_frames, b: int):
    lat = torch.as_tensor(lat_frames)
    return lat.expand(b, lat.shape[-1]) if lat.dim() == 1 else lat


def occupancy_ref(psi, nu, a_t, lam_t, lat_frames):
    """(B, C, N, N) summed occupancy tensor β[b, c, i, j] (zero where no
    edge).

    Multigraph semantics: entry (c, i, j) is the SUM of β over the
    A[c,i,j] parallel edges — the phase term scales with multiplicity
    while λeff already accumulates per edge in densify, so it is added
    unscaled.
    """
    a, lam_eff = a_t.transpose(1, 2), lam_t.transpose(1, 2)
    lat = _lat_rows(lat_frames, psi.shape[0])
    x = psi[:, None, None, :] - nu[:, None, None, :] * lat[:, :, None, None]
    return a[None] * (x - psi[:, None, :, None]) + lam_eff[None]


def node_occupancy_ref(psi, nu, a_t, lam_t, lat_frames):
    """(B, N) per-node net occupancy β_i = Σ_{e→i} w_e·β_e (frames)."""
    return occupancy_ref(psi, nu, a_t, lam_t, lat_frames).sum(dim=(1, 3))


def bittide_dense_step_ref(psi, nu, nu_u, a_t, lam_t, lat_frames, kp,
                           beta_off, dt_frames, ctrl_mask=None):
    """One control period over (B, N) state. Returns (psi', nu', err).

    ``kp`` / ``beta_off`` are (B,) per-draw gains; nodes with
    ``ctrl_mask`` ≤ 0.5 hold their ν (clock holdover).
    """
    beta = occupancy_ref(psi, nu, a_t, lam_t, lat_frames)
    err = (beta - a_t.transpose(1, 2)[None]
           * beta_off[:, None, None, None]).sum(dim=(1, 3))
    # cancellation-free form of (1+ν_u)(1+c) − 1
    c_rel = kp[:, None] * err
    nu_next = nu_u + c_rel + nu_u * c_rel
    if ctrl_mask is not None:
        nu_next = torch.where(ctrl_mask > 0.5, nu_next, nu)
    psi_next = psi + nu_next * dt_frames
    return psi_next, nu_next, err


def bittide_dense_multistep_ref(psi, nu, nu_u, a_t, lam_t, lat_frames, kp,
                                beta_off, dt_frames, num_records: int,
                                record_every: int, ctrl_mask=None,
                                record_beta: bool = False):
    """Multi-period batched oracle for the fused engine.

    Returns (psi_final, nu_final, nu_rec (R, B, N), beta_rec (R, B, N) or
    None); β is the per-node net occupancy of the post-update state at
    every record point.
    """
    nu_rec, beta_rec = [], []
    for _ in range(num_records):
        for _ in range(record_every):
            psi, nu, _ = bittide_dense_step_ref(
                psi, nu, nu_u, a_t, lam_t, lat_frames, kp, beta_off,
                dt_frames, ctrl_mask)
        nu_rec.append(nu)
        if record_beta:
            beta_rec.append(node_occupancy_ref(psi, nu, a_t, lam_t,
                                               lat_frames))
    return (psi, nu, torch.stack(nu_rec),
            torch.stack(beta_rec) if record_beta else None)
