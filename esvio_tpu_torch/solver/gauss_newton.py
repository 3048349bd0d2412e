"""Sliding-window bundle adjustment: batched linearization + LM with Schur
elimination (port of the live part of esvio_tpu/solver/gauss_newton.py).

  * every projection factor of a book (mono, cross-stereo, static-stereo)
    is one row of a unified (L, 2F+1) table evaluated with ONE two-frame
    two-camera Jacobian (`_proj_factor_table`);
  * the normal equations come out in Schur-ready form (Hpp, Hpl, hll, bp,
    bl) — inverse depths have a diagonal block by construction;
  * Levenberg-Marquardt with deferred acceptance on the Jacobi-scaled
    reduced camera system, solved by kernel K2 (`reduced_solve`);
  * `solve_window_relo`: the same LM with the in-window relocalization
    pose appended as a 6-dim block (196 unknowns, solved by the library's
    Cholesky, as the JAX package does for any size but 190).

Not ported: `linearize`, `assemble_normal`, `assemble_normal_fast` (test
oracles of the JAX package) and the eigh branch of `reduced_solve`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.imu import preintegration as pre
from esvio_tpu_torch.solver import factors
from esvio_tpu_torch.solver.chol_solve import chol_solve
from esvio_tpu_torch.solver.window import (
    DIM_ALL, N_EX, N_STATES, OFF_EX, OFF_SB, OFF_TD, WINDOW,
    FeatureBook, WindowState, apply_delta, init_window, start_frame,
    state_minus, used_num,
)


@dataclasses.dataclass
class Prior:
    """Marginalization prior: r(x) = r0 + J0 · (x ⊟ lin)."""

    J0: torch.Tensor        # (DIM_ALL, DIM_ALL)
    r0: torch.Tensor        # (DIM_ALL,)
    lin: WindowState
    valid: torch.Tensor     # () bool


def empty_prior(device, dtype=torch.float32) -> Prior:
    return Prior(
        J0=torch.zeros((DIM_ALL, DIM_ALL), dtype=dtype, device=device),
        r0=torch.zeros((DIM_ALL,), dtype=dtype, device=device),
        lin=init_window(device, dtype),
        valid=torch.zeros((), dtype=torch.bool, device=device))


def _book_gate(book: FeatureBook):
    """Features entering the problem (estimator.cpp:1901-1904 + depth)."""
    return (book.active & (used_num(book) >= 2)
            & (start_frame(book) < WINDOW - 2) & book.depth_valid)


def _at_start(a, start):
    """a (L, F, ...) → a[l, start[l]] (L, ...)."""
    idx = start.reshape((-1, 1) + (1,) * (a.dim() - 2))
    idx = idx.expand((a.shape[0], 1) + a.shape[2:])
    return torch.gather(a, 1, idx)[:, 0]


@functools.lru_cache(maxsize=None)
def _imu_onehot(dtype, device):
    """(10, 30, DIM_ALL) one-hot column selector of each IMU factor's
    parameter layout [pose_k 6 | sb_k 9 | pose_k+1 6 | sb_k+1 9].  Built
    once per dtype and device: its copy to the device must not fall inside
    a CUDA graph capture."""
    E = torch.zeros((WINDOW, 30, DIM_ALL), dtype=dtype)
    for k in range(WINDOW):
        cols = (list(range(k * 6, k * 6 + 6))
                + list(range(OFF_SB + k * 9, OFF_SB + k * 9 + 9))
                + list(range((k + 1) * 6, (k + 1) * 6 + 6))
                + list(range(OFF_SB + (k + 1) * 9, OFF_SB + (k + 1) * 9 + 9)))
        E[k, torch.arange(30), cols] = 1.0
    return E.to(device)


def _proj_inputs(state: WindowState, book: FeatureBook, exl: int, exr: int):
    """Per-book projection-factor table inputs, rows per lane
    M = F (mono) + F (cross) + 1 (static); returns (args, mask, jidx, start)."""
    L = book.un.shape[0]
    F = N_STATES
    M = 2 * F + 1
    dev = book.un.device
    gate = _book_gate(book)
    start = start_frame(book)
    pt_i = _at_start(book.un, start)
    vel_i = _at_start(book.vel, start)
    td_i = _at_start(book.td_obs, start)
    inv_dep = torch.where(gate & (torch.abs(book.inv_depth) > 1e-4),
                          book.inv_depth, torch.ones_like(book.inv_depth))

    j_idx = torch.arange(F, device=dev)
    not_start = j_idx[None, :] != start[:, None]
    mask_mono = gate[:, None] & book.obs & not_start
    mask_cross = gate[:, None] & book.stereo & not_start
    mask_static = gate & _at_start(book.stereo, start)
    mask = torch.cat([mask_mono, mask_cross, mask_static[:, None]], 1)

    jidx = torch.cat([j_idx.expand(L, F), j_idx.expand(L, F), start[:, None]], 1)
    pt_j = torch.cat([book.un, book.un_r, _at_start(book.un_r, start)[:, None]], 1)
    vel_j = torch.cat([book.vel, book.vel_r,
                       _at_start(book.vel_r, start)[:, None]], 1)
    td_j = torch.cat([book.td_obs, book.td_obs, td_i[:, None]], 1)

    P_st, Q_st = state.P[start], state.Q[start]
    Pi = P_st[:, None].expand(L, M, 3)
    Qi = Q_st[:, None].expand(L, M, 4)

    def j_table(allf, st_val):
        grid = allf[None].expand((L,) + allf.shape)
        return torch.cat([grid, grid, st_val[:, None]], 1)

    Pj = j_table(state.P, P_st)
    Qj = j_table(state.Q, Q_st)
    ex1_idx = torch.where(torch.arange(M, device=dev) < F, exl, exr)
    ex_p0 = state.ex_p[exl].expand(L, M, 3)
    ex_q0 = state.ex_q[exl].expand(L, M, 4)
    ex_p1 = state.ex_p[ex1_idx][None].expand(L, M, 3)
    ex_q1 = state.ex_q[ex1_idx][None].expand(L, M, 4)
    lam = inv_dep[:, None].expand(L, M)
    pti = pt_i[:, None].expand(L, M, 2)
    vli = vel_i[:, None].expand(L, M, 2)
    tdi = td_i[:, None].expand(L, M)
    td = state.td.expand(L, M)
    args = (Pi, Qi, Pj, Qj, ex_p0, ex_q0, ex_p1, ex_q1, lam, td, pti, vli,
            tdi, pt_j, vel_j, td_j)
    return args, mask, jidx, start


def _proj_factor_table(state: WindowState, book: FeatureBook, exl: int,
                       exr: int, cauchy_c: float):
    """All mono + cross + static factors of a book through ONE proj22
    Jacobian: mono = two-cam with ex1 := ex0 (its ∂/∂ex0 and ∂/∂ex1 blocks
    sum to the shared-extrinsic derivative), static = two-frame with
    j := i (the pose blocks cancel and are zeroed).

    Returns (r (L,M,2), J (L,M,2,26), jidx (L,M), start (L,)), Cauchy
    weights and masks folded into r and J, mono ex1 block folded."""
    dtype = state.P.dtype
    F = N_STATES
    M = 2 * F + 1
    args, mask, jidx, start = _proj_inputs(state, book, exl, exr)
    r, J = factors.proj22_jac(*args)

    w = factors.cauchy_weight(torch.sum(r * r, -1), cauchy_c) * mask.to(dtype)
    r = r * w[..., None]
    J = J * w[..., None, None]

    dev = r.device
    m = (torch.arange(M, device=dev) < F).to(dtype)[None, :, None, None]
    s = (torch.arange(M, device=dev) == 2 * F).to(dtype)[None, :, None, None]
    J = torch.cat([J[..., 0:12] * (1.0 - s),
                   J[..., 12:18] + m * J[..., 18:24],
                   J[..., 18:24] * (1.0 - m),
                   J[..., 24:26]], dim=-1)
    return r, J, jidx, start


def _imu_inputs(state: WindowState):
    return (state.P[:-1], state.Q[:-1], state.V[:-1], state.Ba[:-1],
            state.Bg[:-1], state.P[1:], state.Q[1:], state.V[1:],
            state.Ba[1:], state.Bg[1:])


def _one_hot(idx, n, dtype):
    return torch.nn.functional.one_hot(idx, n).to(dtype)


def assemble_normal_reduced(state: WindowState, book_img: FeatureBook,
                            book_evt: FeatureBook, preints: pre.Preintegrated,
                            imu_valid, prior: Prior, g, cauchy_c: float = 1.0,
                            prior_H=None, imu_sqrt=None):
    """Normal equations in Schur-ready form: (Hpp, Hpl, hll, bp, bl, cost):
    the camera system Hpp (190²), the camera-landmark coupling Hpl
    (190 × L), the diagonal landmark block hll (L,) and the gradient."""
    dtype, dev = state.P.dtype, state.P.device
    L_img = book_img.un.shape[0]
    L_evt = book_evt.un.shape[0]
    L_tot = L_img + L_evt
    F = N_STATES
    M = 2 * F + 1

    # ---- IMU factors (banded JᵀJ via constant one-hot products) -----------
    if imu_sqrt is None:
        imu_sqrt = factors.imu_sqrt_info(preints.covariance)
    r_imu, J_imu = factors.imu_residual_jac(*_imu_inputs(state), preints, g,
                                            imu_sqrt)
    mw = imu_valid[:, None].to(dtype)
    r_imu = r_imu * mw
    J_imu = J_imu * mw[:, :, None]
    E = _imu_onehot(dtype, dev)                                  # (10, 30, 190)
    Hi = torch.einsum("nak,nal->nkl", J_imu, J_imu)              # (10, 30, 30)
    H_imu = torch.einsum("nka,nkb->ab", E, torch.einsum("nkl,nlb->nkb", Hi, E))
    b_imu = torch.einsum("nka,nk->a", E, torch.einsum("nak,na->nk", J_imu, r_imu))
    cost = torch.sum(r_imu * r_imu)

    # ---- projection factors: one table across both books ------------------
    ri, Ji, jidx_i, st_i = _proj_factor_table(state, book_img, 0, 2, cauchy_c)
    re_, Je, jidx_e, st_e = _proj_factor_table(state, book_evt, 1, 3, cauchy_c)
    r_all = torch.cat([ri, re_], 0)               # (Lt, M, 2)
    J_all = torch.cat([Ji, Je], 0)                # (Lt, M, 2, 26)
    jidx = torch.cat([jidx_i, jidx_e], 0)
    start_all = torch.cat([st_i, st_e], 0)

    # expansion to dense [pose 66 | ex 24 | td 1] = 91 columns via one-hots
    Oi = _one_hot(start_all, F, dtype)            # (Lt, 11)
    Oj = _one_hot(jidx, F, dtype)                 # (Lt, M, 11)
    is_mono = torch.arange(M, device=dev) < F
    exl_slot = torch.cat([torch.zeros(L_img, dtype=torch.int64, device=dev),
                          torch.ones(L_evt, dtype=torch.int64, device=dev)])
    exr_slot = exl_slot + 2
    Oex0 = _one_hot(exl_slot, N_EX, dtype)        # (Lt, 4)
    Oex1 = _one_hot(torch.where(is_mono[None, :], exl_slot[:, None],
                                exr_slot[:, None]), N_EX, dtype)   # (Lt, M, 4)

    Jpose = (torch.einsum("li,lmra->lmria", Oi, J_all[..., 0:6])
             .reshape(L_tot, M, 2, 66)
             + torch.einsum("lmi,lmra->lmria", Oj, J_all[..., 6:12])
             .reshape(L_tot, M, 2, 66))
    Jex = (torch.einsum("le,lmra->lmrea", Oex0, J_all[..., 12:18])
           .reshape(L_tot, M, 2, 24)
           + torch.einsum("lme,lmra->lmrea", Oex1, J_all[..., 18:24])
           .reshape(L_tot, M, 2, 24))
    Jd = torch.cat([Jpose, Jex, J_all[..., 25:26]], dim=-1)     # 91 cols
    Jlam = J_all[..., 24]                                       # (Lt, M, 2)

    Jx = Jd.reshape(-1, 91)
    H91 = Jx.T @ Jx
    b91 = Jx.T @ r_all.reshape(-1)
    Hlam91 = torch.einsum("lmra,lmr->al", Jd, Jlam)             # (91, Lt)
    hll = torch.einsum("lmr,lmr->l", Jlam, Jlam)
    bl = torch.einsum("lmr,lmr->l", Jlam, r_all)
    cost = cost + torch.sum(r_all * r_all)

    # ---- place the 91-wide system into the DIM_ALL layout -----------------
    secs = ((0, 0, 66), (66, OFF_EX, 24), (90, OFF_TD, 1))
    J0w = prior.J0 * prior.valid.to(dtype)
    if prior_H is None:
        prior_H = J0w.T @ J0w
    r_prior = (prior.r0 + prior.J0 @ state_minus(state, prior.lin)) \
        * prior.valid.to(dtype)

    Hpp = H_imu + prior_H
    Hpl = torch.zeros((DIM_ALL, L_tot), dtype=dtype, device=dev)
    bp = b_imu + J0w.T @ r_prior
    for (a, ra, n) in secs:
        for (b, rb, m) in secs:
            Hpp[ra:ra + n, rb:rb + m] += H91[a:a + n, b:b + m]
        Hpl[ra:ra + n] += Hlam91[a:a + n]
        bp[ra:ra + n] += b91[a:a + n]
    cost = cost + torch.sum(r_prior * r_prior)
    return Hpp, Hpl, hll, bp, bl, cost


def problem_cost(state: WindowState, book_img: FeatureBook,
                 book_evt: FeatureBook, preints: pre.Preintegrated,
                 imu_valid, prior: Prior, g, cauchy_c: float = 1.0):
    """0.5·Σ r² (robust-weighted) without building any Jacobian."""
    dtype = state.P.dtype
    imu_sqrt = factors.imu_sqrt_info(preints.covariance)
    r_imu = factors.imu_residual(*_imu_inputs(state), preints, g, imu_sqrt)
    cost = torch.sum((r_imu * imu_valid[:, None].to(dtype)) ** 2)
    for book, exl, exr in ((book_img, 0, 2), (book_evt, 1, 3)):
        args, mask, _, _ = _proj_inputs(state, book, exl, exr)
        r = factors.proj_two_frame_two_cam(*args)
        w = factors.cauchy_weight(torch.sum(r * r, -1), cauchy_c) * mask.to(dtype)
        cost = cost + torch.sum((r * w[..., None]) ** 2)
    r_prior = (prior.r0 + prior.J0 @ state_minus(state, prior.lin)) \
        * prior.valid.to(dtype)
    return 0.5 * (cost + torch.sum(r_prior * r_prior))


def reduced_solve(Hr, br, lam_damp):
    """Solve (Hr + λI) dx = −br on the Jacobi-scaled reduced camera system
    by LM-damped Cholesky.  A failed factorization yields non-finite dx,
    which the LM accept test rejects (then λ×100).  Returns (dx, finite)."""
    n = Hr.shape[0]
    lam = lam_damp if torch.is_tensor(lam_damp) else torch.full(
        (), lam_damp, dtype=Hr.dtype, device=Hr.device)
    if Hr.dtype == torch.float32 and n == DIM_ALL:
        dx = -chol_solve(Hr, br, lam)
    else:
        eye = torch.eye(n, dtype=Hr.dtype, device=Hr.device)
        L, info = torch.linalg.cholesky_ex(Hr + lam * eye)
        y = torch.linalg.solve_triangular(L, br[:, None], upper=False)
        dx = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
    finite = torch.all(torch.isfinite(dx))
    return torch.where(finite, dx, torch.zeros_like(dx)), finite


def damping_schedule(dtype):
    """(λ₀, λ_floor) for the scaled reduced system."""
    if dtype == torch.float64:
        return 1e-8, 1e-12
    return 1e-4, 3e-6


def _select(accept, old, new):
    """Field-wise torch.where(accept, new, old) over a dataclass."""
    return dataclasses.replace(old, **{
        f.name: torch.where(accept, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def _lm_proposal(sys_acc, lam_damp, frozen):
    """One LM step proposed from the accepted normal equations (Hpp, Hpl,
    hll, bp, bl, cost): Ceres-style Jacobi column scaling, Schur
    elimination of the diagonal landmark block, the damped reduced solve.
    frozen: optional bool rows of Hpp held constant.  Returns (dxp, dlam)
    unscaled."""
    Hpp_r, Hpl_r, hll_r, bp_r, bl_r, _ = sys_acc
    dtype = Hpp_r.dtype
    n = Hpp_r.shape[0]
    col_norm = torch.sqrt(torch.cat([torch.diagonal(Hpp_r), hll_r]))
    active_col = col_norm > 1e-10
    if frozen is not None:
        active_col = active_col & ~torch.cat(
            [frozen, torch.zeros(col_norm.shape[0] - frozen.shape[0],
                                 dtype=torch.bool, device=frozen.device)])
    d_inv = torch.where(active_col,
                        1.0 / torch.where(active_col, col_norm,
                                          torch.ones_like(col_norm)),
                        torch.zeros_like(col_norm))
    dp_i = d_inv[:n]
    dl_i = d_inv[n:]
    Hpp = Hpp_r * dp_i[None, :] * dp_i[:, None]
    Hpl = Hpl_r * dp_i[:, None] * dl_i[None, :]
    hll = hll_r * dl_i * dl_i
    bp = bp_r * dp_i
    bl = bl_r * dl_i

    active_lm = hll > 0.5
    inv_hll = torch.where(active_lm,
                          1.0 / torch.where(active_lm, hll, torch.ones_like(hll)),
                          torch.zeros_like(hll))
    Hr = Hpp - (Hpl * inv_hll[None, :]) @ Hpl.T
    br = bp - Hpl @ (bl * inv_hll)

    dxp_s, finite = reduced_solve(Hr, br, lam_damp)
    dlam_s = -(bl + Hpl.T @ dxp_s) * inv_hll * finite.to(dtype)
    return dxp_s * dp_i, dlam_s * dl_i


def _with_depths(book_img, book_evt, dlam):
    """Both books with their inverse depths moved by dlam (image lanes
    first)."""
    L_img = book_img.un.shape[0]
    return (dataclasses.replace(book_img,
                                inv_depth=book_img.inv_depth + dlam[:L_img]),
            dataclasses.replace(book_evt,
                                inv_depth=book_evt.inv_depth + dlam[L_img:]))


def _lm_accept(accept, book_img, book_evt, bi_new, be_new, sys_acc, sys_new,
               lam_damp, lam_floor):
    """The books, accepted system and damping after the accept test."""
    keep = lambda old, new: dataclasses.replace(old, inv_depth=torch.where(
        accept, new.inv_depth, old.inv_depth))
    sys_acc = tuple(torch.where(accept, n, o) for o, n in zip(sys_acc, sys_new))
    lam_damp = torch.where(accept, torch.clamp(lam_damp / 10.0, min=lam_floor),
                           torch.clamp(lam_damp * 100.0, max=1e4))
    return keep(book_img, bi_new), keep(book_evt, be_new), sys_acc, lam_damp


def solve_window(state: WindowState, book_img: FeatureBook,
                 book_evt: FeatureBook, preints: pre.Preintegrated, imu_valid,
                 prior: Prior, g, iters: int = 8, cauchy_c: float = 1.0,
                 frozen: Optional[torch.Tensor] = None):
    """LM on the sliding window → (state', book_img', book_evt', costs).

    frozen: optional (DIM_ALL,) bool — parameter rows held constant (Ceres
    SetParameterBlockConstant analog).  Deferred-acceptance LM: the normal
    equations at the current accepted state are carried; each iteration
    proposes a step from them and runs ONE assembly at the proposed state,
    whose cost is the accept test.  No host synchronisation inside."""
    dtype = state.P.dtype
    J0w = prior.J0 * prior.valid.to(dtype)
    prior_H0 = J0w.T @ J0w
    imu_sqrt0 = factors.imu_sqrt_info(preints.covariance)

    def assemble(st, bi, be):
        return assemble_normal_reduced(st, bi, be, preints, imu_valid, prior, g,
                                       cauchy_c, prior_H=prior_H0,
                                       imu_sqrt=imu_sqrt0)

    sys_acc = assemble(state, book_img, book_evt)
    lam0, lam_floor = damping_schedule(dtype)
    lam_damp = torch.full((), lam0, dtype=dtype, device=state.P.device)
    costs = []
    for _ in range(iters):
        dxp, dlam = _lm_proposal(sys_acc, lam_damp, frozen)
        st_new = apply_delta(state, dxp)
        bi_new, be_new = _with_depths(book_img, book_evt, dlam)
        sys_new = assemble(st_new, bi_new, be_new)
        accept = 0.5 * sys_new[5] < 0.5 * sys_acc[5]
        state = _select(accept, state, st_new)
        book_img, book_evt, sys_acc, lam_damp = _lm_accept(
            accept, book_img, book_evt, bi_new, be_new, sys_acc, sys_new,
            lam_damp, lam_floor)
        costs.append(0.5 * sys_new[5])
    return state, book_img, book_evt, torch.stack(costs)


# --------------------------------------------------------------------------
# In-window fast relocalization
# --------------------------------------------------------------------------

DIM_RELO = DIM_ALL + 6      # window params + the relo pose block


def _relo_family(state: WindowState, book: FeatureBook, exl: int,
                 relo_P, relo_Q, relo_obs, relo_lane, relo_valid,
                 cauchy_c: float):
    """Relo projection rows: a window landmark (lane) reprojected into the
    old keyframe at the relo pose, the reference's extra ProjectionFactor
    rows with relo_Pose as the j-side block (estimator.cpp:1988-2022),
    Cauchy-robust like the window rows.

    relo_obs: (Lr, 2) normalized observations in the old keyframe;
    relo_lane: (Lr,) lane into `book` (-1 = empty slot); relo_valid: (Lr,).
    Returns (r (Lr, 2), Jd (Lr, 2, DIM_RELO), Jlam (Lr, 2), lane (Lr,))."""
    dtype = state.P.dtype
    L = book.un.shape[0]
    Lr = relo_lane.shape[0]
    gate_book = _book_gate(book)
    start_all = start_frame(book)
    lane = torch.clamp(relo_lane, 0, L - 1)
    gate = gate_book[lane] & relo_valid & (relo_lane >= 0)
    start = start_all[lane]
    pt_i = _at_start(book.un, start_all)[lane]
    vel_i = _at_start(book.vel, start_all)[lane]
    td_i = _at_start(book.td_obs, start_all)[lane]
    inv_all = torch.where(gate_book & (torch.abs(book.inv_depth) > 1e-4),
                          book.inv_depth, torch.ones_like(book.inv_depth))
    ex_p = state.ex_p[exl].expand(Lr, 3)
    ex_q = state.ex_q[exl].expand(Lr, 4)
    # plain ProjectionFactor semantics: vel_j = 0, td_j = td_i, so the
    # old keyframe's observation is not td-compensated
    r, J = factors.proj22_jac(
        state.P[start], state.Q[start], relo_P.expand(Lr, 3),
        relo_Q.expand(Lr, 4), ex_p, ex_q, ex_p, ex_q, inv_all[lane],
        state.td.expand(Lr), pt_i, vel_i, td_i, relo_obs,
        torch.zeros_like(relo_obs), td_i)
    w = factors.cauchy_weight(torch.sum(r * r, -1), cauchy_c) * gate.to(dtype)
    r = r * w[:, None]
    J = J * w[:, None, None]

    # dense extended layout [pose 66 | sb 99 | ex 24 | td | relo 6]
    Oi = _one_hot(start, N_STATES, dtype)
    Jpi = torch.einsum("li,lra->lria", Oi, J[..., 0:6]).reshape(Lr, 2, 66)
    Jex6 = J[..., 12:18] + J[..., 18:24]          # shared extrinsic (i = j cam)
    Jex = torch.nn.functional.pad(Jex6, (exl * 6, 24 - exl * 6 - 6))
    Jd = torch.cat([Jpi, torch.zeros((Lr, 2, OFF_EX - OFF_SB), dtype=dtype,
                                     device=r.device),
                    Jex, J[..., 25:26], J[..., 6:12]], dim=-1)
    return r, Jd, J[..., 24], lane


def relo_residuals(state: WindowState, book: FeatureBook, exl: int,
                   relo_P, relo_Q, relo_obs, relo_lane, relo_valid):
    """Unweighted relo reprojection residuals (Lr, 2), for inlier gating."""
    return _relo_family(state, book, exl, relo_P, relo_Q, relo_obs,
                        relo_lane, relo_valid, cauchy_c=1e9)[0]


def solve_window_relo(state: WindowState, book_img: FeatureBook,
                      book_evt: FeatureBook, preints: pre.Preintegrated,
                      imu_valid, prior: Prior, g, relo_P, relo_Q, relo_obs,
                      relo_lane, relo_valid, relo_book: str = "evt",
                      iters: int = 8, cauchy_c: float = 1.0,
                      frozen: Optional[torch.Tensor] = None):
    """`solve_window` plus the in-window relo pose block
    (estimator.cpp:1988-2022): the old keyframe's pose is a 6-dim block
    refined jointly with the window against IMU, vision and the robust
    relo rows.  Its λ couplings are scatter-added into the landmark
    columns.  Returns (state', book_img', book_evt', costs, relo_P',
    relo_Q')."""
    dtype = state.P.dtype
    exl = 0 if relo_book == "img" else 1
    lm_base = 0 if relo_book == "img" else book_img.un.shape[0]
    J0w = prior.J0 * prior.valid.to(dtype)
    prior_H0 = J0w.T @ J0w
    imu_sqrt0 = factors.imu_sqrt_info(preints.covariance)

    def assemble(st, bi, be, rP, rQ):
        Hpp, Hpl, hll, bp, bl, cost = assemble_normal_reduced(
            st, bi, be, preints, imu_valid, prior, g, cauchy_c,
            prior_H=prior_H0, imu_sqrt=imu_sqrt0)
        r, Jd, Jlam, lane = _relo_family(
            st, bi if relo_book == "img" else be, exl, rP, rQ, relo_obs,
            relo_lane, relo_valid, cauchy_c)
        Jx = Jd.reshape(-1, DIM_RELO)
        pad6 = (0, 6, 0, 6)
        HppX = torch.nn.functional.pad(Hpp, pad6) + Jx.T @ Jx
        bpX = torch.nn.functional.pad(bp, (0, 6)) + Jx.T @ r.reshape(-1)
        cols = lm_base + lane
        Hcl = torch.einsum("lra,lr->la", Jd, Jlam)          # (Lr, DIM_RELO)
        HplX = torch.nn.functional.pad(Hpl, (0, 0, 0, 6)).index_add(1, cols, Hcl.T)
        hllX = hll.index_add(0, cols, torch.einsum("lr,lr->l", Jlam, Jlam))
        blX = bl.index_add(0, cols, torch.einsum("lr,lr->l", Jlam, r))
        return HppX, HplX, hllX, bpX, blX, cost + torch.sum(r * r)

    relo_P = relo_P.to(dtype)
    relo_Q = relo_Q.to(dtype)
    sys_acc = assemble(state, book_img, book_evt, relo_P, relo_Q)
    lam0, lam_floor = damping_schedule(dtype)
    lam_damp = torch.full((), lam0, dtype=dtype, device=state.P.device)
    costs = []
    for _ in range(iters):
        dxp, dlam = _lm_proposal(sys_acc, lam_damp, frozen)
        st_new = apply_delta(state, dxp[:DIM_ALL])
        rP_new = relo_P + dxp[DIM_ALL:DIM_ALL + 3]
        rQ_new = lie.quat_normalize(lie.quat_mul(
            relo_Q, lie.delta_q(dxp[DIM_ALL + 3:DIM_ALL + 6])))
        bi_new, be_new = _with_depths(book_img, book_evt, dlam)
        sys_new = assemble(st_new, bi_new, be_new, rP_new, rQ_new)
        accept = 0.5 * sys_new[5] < 0.5 * sys_acc[5]
        state = _select(accept, state, st_new)
        relo_P = torch.where(accept, rP_new, relo_P)
        relo_Q = torch.where(accept, rQ_new, relo_Q)
        book_img, book_evt, sys_acc, lam_damp = _lm_accept(
            accept, book_img, book_evt, bi_new, be_new, sys_acc, sys_new,
            lam_damp, lam_floor)
        costs.append(0.5 * sys_new[5])
    return state, book_img, book_evt, torch.stack(costs), relo_P, relo_Q
