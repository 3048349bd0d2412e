"""Schur-complement marginalization → linearized prior (port of
esvio_tpu/solver/marginalization.py; marginalization_factor.cpp:72-323).

MARGIN_OLD : drop pose0 + speedbias0 + the landmarks first seen in frame 0;
             factors entering: previous prior, IMU(0→1), all projections of
             those landmarks (estimator.cpp:2049-2206).
MARGIN_2ND : drop pose[WINDOW-1] from the previous prior only
             (estimator.cpp:2221-2285).
Both return the prior re-indexed for the slid window, from one symmetric
eigendecomposition (pseudo-inverse with eps 1e-8, J₀ = S^{1/2}Vᵀ).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver.window import (
    DIM_ALL, OFF_EX, OFF_SB, WINDOW, FeatureBook, WindowState, start_frame,
)
from esvio_tpu_torch.utils.metrics import count

_EPS = 1e-8  # eigenvalue threshold (marginalization_factor.cpp:233,257)


def _eigh(A):
    """Symmetric eigendecomposition computed in float64, returned in A's
    dtype: these systems reach cond ≈ 1e17 (bias random-walk weights next
    to vision rows) and float32 syevd (LAPACK on the CPU, cuSOLVER on the
    card) can fail to converge on them.  eigh reads its convergence flags
    back to the host: a counted host fetch."""
    count("host_fetches")
    w, V = torch.linalg.eigh(A.to(torch.float64))
    return w.to(A.dtype), V.to(A.dtype)


def _pose_cols(k):
    return tuple(range(k * 6, k * 6 + 6))


def _sb_cols(k):
    return tuple(range(OFF_SB + k * 9, OFF_SB + k * 9 + 9))


@functools.lru_cache(maxsize=None)
def _index(idx: tuple, device) -> torch.Tensor:
    """An index tuple as an int64 tensor on `device`, copied there once:
    each host-to-device copy of a fresh index would wait for the device."""
    return torch.tensor(idx, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _perm_shift_old():
    """new-layout index → old-layout index after MARGIN_OLD (-1 = free)."""
    perm = [-1] * DIM_ALL
    for k in range(WINDOW):
        for a in range(6):
            perm[k * 6 + a] = (k + 1) * 6 + a
        for a in range(9):
            perm[OFF_SB + k * 9 + a] = OFF_SB + (k + 1) * 9 + a
    for a in range(OFF_EX, DIM_ALL):
        perm[a] = a
    return tuple(perm)


@functools.lru_cache(maxsize=None)
def _perm_shift_second_new():
    """new ← old for MARGIN_SECOND_NEW: slot WINDOW-1 ← slot WINDOW."""
    perm = [-1] * DIM_ALL
    for k in range(WINDOW - 1):
        for a in range(6):
            perm[k * 6 + a] = k * 6 + a
        for a in range(9):
            perm[OFF_SB + k * 9 + a] = OFF_SB + k * 9 + a
    for a in range(6):
        perm[(WINDOW - 1) * 6 + a] = WINDOW * 6 + a
    for a in range(9):
        perm[OFF_SB + (WINDOW - 1) * 9 + a] = OFF_SB + WINDOW * 9 + a
    for a in range(OFF_EX, DIM_ALL):
        perm[a] = a
    return tuple(perm)


def _apply_perm(A, b, perm):
    """Re-index (A, b) from the old layout into the new; -1 slots are zero."""
    p = _index(perm, A.device)
    safe = torch.clamp(p, min=0)
    mask = (p >= 0).to(A.dtype)
    return (A[safe][:, safe] * mask[:, None] * mask[None, :], b[safe] * mask)


def _schur_eliminate(A, b, m_idx, eps=_EPS):
    """Eliminate the index set m_idx via the eigen pseudo-inverse; rows and
    columns of m come back zeroed in the full-size layout."""
    m_set = set(m_idx)
    r_idx = _index(tuple(i for i in range(A.shape[0]) if i not in m_set),
                   A.device)
    m_idx = _index(m_idx, A.device)

    Amm = A[m_idx][:, m_idx]
    Amm = 0.5 * (Amm + Amm.T)
    w, V = _eigh(Amm)
    ok = w > eps
    w_inv = torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    Amm_inv = (V * w_inv[None, :]) @ V.T

    Arm = A[r_idx][:, m_idx]
    Arr = A[r_idx][:, r_idx]
    A_out = Arr - Arm @ Amm_inv @ Arm.T
    b_out = b[r_idx] - Arm @ Amm_inv @ b[m_idx]
    A_full = torch.zeros_like(A)
    A_full[r_idx[:, None], r_idx[None, :]] = A_out
    b_full = torch.zeros_like(b)
    b_full[r_idx] = b_out
    return A_full, b_full


def _prior_from_hessian(A, b, lin: WindowState) -> gn.Prior:
    """J₀ = S^{1/2}Vᵀ, r₀ = S^{-1/2}Vᵀ b (marginalize(), .cpp:249-269)."""
    A = 0.5 * (A + A.T)
    w, V = _eigh(A)
    ok = w > _EPS
    s = torch.where(ok, torch.sqrt(torch.where(ok, w, torch.ones_like(w))),
                    torch.zeros_like(w))
    s_inv = torch.where(ok, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return gn.Prior(J0=s[:, None] * V.T, r0=s_inv * (V.T @ b), lin=lin,
                    valid=torch.ones((), dtype=torch.bool, device=A.device))


def _shift_state_old(state: WindowState) -> WindowState:
    roll = lambda x: torch.cat([x[1:], x[-1:]], dim=0)
    return dataclasses.replace(state, P=roll(state.P), Q=roll(state.Q),
                               V=roll(state.V), Ba=roll(state.Ba),
                               Bg=roll(state.Bg))


def _shift_state_second_new(state: WindowState) -> WindowState:
    def sh(x):
        x = x.clone()
        x[WINDOW - 1] = x[WINDOW]
        return x
    return dataclasses.replace(state, P=sh(state.P), Q=sh(state.Q),
                               V=sh(state.V), Ba=sh(state.Ba), Bg=sh(state.Bg))


def marginalize_old(state: WindowState, book_img: FeatureBook,
                    book_evt: FeatureBook, preints, imu_valid,
                    prior: gn.Prior, g, cauchy_c: float = 1.0) -> gn.Prior:
    """Marginalize frame 0 (+ its landmarks) → prior for the slid window."""

    def restrict(book):
        return dataclasses.replace(
            book, active=book.active & (start_frame(book) == 0))

    iv = torch.zeros_like(imu_valid)
    iv[0] = imu_valid[0]
    Hpp, Hpl, hll, bp, bl, _ = gn.assemble_normal_reduced(
        state, restrict(book_img), restrict(book_evt), preints, iv, prior, g,
        cauchy_c)

    # eliminate landmarks (diagonal block)
    act = hll > _EPS
    inv_hll = torch.where(act, 1.0 / torch.where(act, hll, torch.ones_like(hll)),
                          torch.zeros_like(hll))
    A = Hpp - (Hpl * inv_hll[None, :]) @ Hpl.T
    bb = bp - Hpl @ (bl * inv_hll)

    # eliminate pose0 + speedbias0, re-index for the slid window
    A, bb = _schur_eliminate(A, bb, _pose_cols(0) + _sb_cols(0))
    A, bb = _apply_perm(A, bb, _perm_shift_old())
    return _prior_from_hessian(A, bb, _shift_state_old(state))


def marginalize_second_new(prior: gn.Prior) -> gn.Prior:
    """Drop pose[WINDOW-1] from the prior; shift the new frame into its slot."""
    A = prior.J0.T @ prior.J0
    b = prior.J0.T @ prior.r0
    A, b = _schur_eliminate(A, b, _pose_cols(WINDOW - 1))
    A, b = _apply_perm(A, b, _perm_shift_second_new())
    new = _prior_from_hessian(A, b, _shift_state_second_new(prior.lin))
    return dataclasses.replace(new, valid=prior.valid)
