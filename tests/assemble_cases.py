"""Kernel K4 (solver/normal_assembly.assemble_cuda) against the plain
assembly (gauss_newton.assemble_normal_reduced_plain), on one device.  numpy
and torch only: chip_smoke.py's K4 phase and
tests/test_torch_assemble_card.py run it on the card.

Cases (`CASES`), all at the fused tick's book sizes, 128 image + 128 event
lanes (`EstimatorConfig`'s capacities), on a varied dist/dryrun.make_problem
window: rotations of a few degrees, velocities and biases off their
linearization, a
time offset, partial and late observations, inactive, depth-invalid and
mono lanes, and a valid prior (a random J0 linearized near the state):

  window         the whole system;
  esio           ESIO's image book, no lane active, beside the event book;
  marg           marginalize_old's assembly: books cut to the lanes that
                 start at frame 0, the first IMU interval alone, prior_H
                 and imu_sqrt left to the callee;
  imu_invalid    three IMU intervals invalid;
  prior_invalid  the prior's valid flag off (its J0 and r0 left in place);
  batch4         four different windows in one call.

Tolerance, and why: every block (Hpp, Hpl, hll, bp, bl, cost) within
TOL = 1e-4 of its largest entry (the parity tests' normal-equation
tolerance) against the plain assembly in float64 of the same float32
inputs.  K4 sums in float32 in its own order and takes its Jacobians in
closed form; the plain float32 assembly lands within 1e-5 of the float64
one on these windows (bl, 9.6e-6, the farthest, on the CPU), so K4 is held
to its own rounding alone.

`proj22_jac_closed` and `imu_residual_jac_closed` are K4's closed-form
Jacobians in plain PyTorch, for tests/test_torch_solver.py to hold against
the forward-mode ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.dist import dryrun
from esvio_tpu_torch.solver import factors as fac
from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver import normal_assembly
from esvio_tpu_torch.solver import window as win

CASES = ("window", "esio", "marg", "imu_invalid", "prior_invalid", "batch4")
LANES = 128
TOL = 1e-4
NAMES = ("Hpp", "Hpl", "hll", "bp", "bl", "cost")


def _book(book, rng, live, device):
    L = book.un.shape[0]
    obs = rng.random((L, win.N_STATES)) < 0.7
    obs[:, 0] = rng.random(L) < 0.5
    obs[: L // 8, 1:] = False                         # seen once
    stereo = obs & (rng.random(obs.shape) < 0.6)
    stereo[L // 8: L // 4] = False                    # mono lanes
    un = rng.normal(0, 0.2, (L, win.N_STATES, 2))
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return dataclasses.replace(
        book, un=t(un), un_r=t(un - 0.02),
        vel=t(rng.normal(0, 0.1, (L, win.N_STATES, 2))),
        vel_r=t(rng.normal(0, 0.1, (L, win.N_STATES, 2))),
        obs=t(obs, torch.bool), stereo=t(stereo, torch.bool),
        td_obs=t(rng.normal(0, 1e-3, (L, win.N_STATES))),
        inv_depth=t(rng.uniform(0.2, 0.5, L)),
        depth_valid=t(rng.random(L) < 0.9, torch.bool),
        active=t(np.arange(L) < live, torch.bool))


def window(seed, device, img_live=100, evt_live=120):
    """(state, book_img, book_evt, preints, imu_valid, prior, g) of one
    varied window, float32 on `device`."""
    rng = np.random.default_rng(seed)
    st, bi, be, pre, iv, prior, g = dryrun.make_problem(
        torch.float32, L_img=LANES, L_evt=LANES, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    # rotations of a few degrees: every point stays well in front of every
    # camera, as in a real window, so no row's depth is near zero
    q = np.concatenate([np.ones((win.N_STATES, 1)),
                        rng.normal(0, 0.05, (win.N_STATES, 3))], -1)
    st = dataclasses.replace(
        st, Q=t(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        V=t(rng.normal(0, 0.5, (win.N_STATES, 3))),
        Ba=t(rng.normal(0, 0.05, (win.N_STATES, 3))),
        Bg=t(rng.normal(0, 0.01, (win.N_STATES, 3))), td=t(0.003))
    lin = dataclasses.replace(
        st.clone(), P=st.P + t(rng.normal(0, 0.01, (win.N_STATES, 3))))
    prior = gn.Prior(J0=t(rng.normal(0, 0.3, (win.DIM_ALL, win.DIM_ALL))),
                     r0=t(rng.normal(0, 1, win.DIM_ALL)), lin=lin,
                     valid=torch.ones((), dtype=torch.bool, device=device))
    return (st, _book(bi, rng, img_live, device), _book(be, rng, evt_live, device),
            pre, iv, prior, g)


def problem(case, device, seed=0):
    """(args, kwargs) of gauss_newton.assemble_normal_reduced for a case."""
    if case == "batch4":
        ws = [window(seed + k, device) for k in range(4)]
        g = ws[0][-1]
        args = tuple(win.tree_map(lambda *x: torch.stack(x), *parts)
                     if dataclasses.is_dataclass(parts[0]) else torch.stack(parts)
                     for parts in zip(*(w[:-1] for w in ws))) + (g,)
        return args, {}
    st, bi, be, pre, iv, prior, g = window(
        seed, device, img_live=0 if case == "esio" else 100)
    if case == "marg":
        cut = lambda b: dataclasses.replace(
            b, active=b.active & (win.start_frame(b) == 0))
        iv0 = torch.zeros_like(iv)
        iv0[0] = iv[0]
        return (st, cut(bi), cut(be), pre, iv0, prior, g), {}
    if case == "imu_invalid":
        iv = iv.clone()
        iv[[2, 5, 9]] = False
    if case == "prior_invalid":
        prior = dataclasses.replace(prior, valid=torch.zeros_like(prior.valid))
    J0w = prior.J0 * prior.valid.to(prior.J0.dtype)
    kw = dict(prior_H=J0w.mT @ J0w,
              imu_sqrt=fac.imu_sqrt_info(pre.covariance))
    return (st, bi, be, pre, iv, prior, g), kw


def _f64(x):
    if dataclasses.is_dataclass(x):
        return win.tree_map(_f64, x)
    return x.double() if x.is_floating_point() else x


def plain64(args, kw):
    """The plain assembly in float64 of the same inputs."""
    return gn.assemble_normal_reduced_plain(
        *(_f64(a) for a in args), **{k: _f64(v) for k, v in kw.items()})


def rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def compare(case, device, seed=0):
    """K4 against the float64 plain assembly, and against a second K4 call
    bit for bit; returns {block: relative error} and the K4 outputs."""
    args, kw = problem(case, device, seed)
    before = normal_assembly._kernels.NORMAL_ASSEMBLY.launches
    out = normal_assembly.assemble_cuda(*args, **kw)
    again = normal_assembly.assemble_cuda(*args, **kw)
    assert normal_assembly._kernels.NORMAL_ASSEMBLY.launches == before + 2
    ref = plain64(args, kw)
    errs = {}
    for name, a, b, c in zip(NAMES, out, again, ref):
        assert a.shape == c.shape and a.dtype == torch.float32, name
        assert torch.equal(a, b), f"{case}: {name} differs between two calls"
        assert bool(torch.isfinite(a).all()), name
        errs[name] = rel(a, c)
        assert errs[name] < TOL, (case, name, errs[name])
    return errs, out


def solve_pair(device, iters):
    """solve_window on dryrun.make_problem's window (tests/test_torch_solver's
    problem) through K4, and the same LM loop through the plain assembly,
    both with K2: (K4's result, the plain one's)."""
    st, bi, be, pre, iv, prior, g = dryrun.make_problem(torch.float32,
                                                        device=device)
    k4 = gn.solve_window(st, bi, be, pre, iv, prior, g, iters=iters)
    J0w = prior.J0 * prior.valid.to(prior.J0.dtype)
    kw = dict(prior_H=J0w.mT @ J0w,
              imu_sqrt=fac.imu_sqrt_info(pre.covariance))
    plain = gn.lm_iterate(
        st, bi, be, lambda s, b1, b2: gn.assemble_normal_reduced_plain(
            s, b1, b2, pre, iv, prior, g, **kw), iters)
    return k4, plain


# ---------------------------------------------------------------------------
# Closed-form Jacobians: the per-row arithmetic of kernel K4
# (csrc/normal_assembly.cu), written out in plain PyTorch so that
# tests/test_torch_solver.py can hold the derivation against the
# forward-mode Jacobians of solver/factors.py.  The program never calls
# them: on the card K4 computes them itself, on the CPU the assembly takes
# the forward-mode ones.
# ---------------------------------------------------------------------------

def _mv3(R, v):
    return (R @ v[..., None])[..., 0]


def _vec_block(M):
    """The 3×3 vector block of a 4×4 quaternion product matrix."""
    return M[..., 1:, 1:]


def proj22_jac_closed(Pi, Qi, Pj, Qj, ex_p0, ex_q0, ex_p1, ex_q1, inv_dep, td,
                      pt_i, vel_i, td_i, pt_j, vel_j, td_j):
    """`factors.proj22_jac` with its Jacobian derived by hand
    (projectionTwoFrameTwoCamFactor.cpp's): r (..., 2), J (..., 2, 26) in
    the same column layout.  A rotation block is the derivative along
    q ⊗ (1, δθ/2), which for a unit quaternion is R·Exp(δθ)."""
    Ri, Rj, R0, R1 = (lie.quat_to_rot(q) for q in (Qi, Qj, ex_q0, ex_q1))
    pts_i = fac._td_point(pt_i, vel_i, td, td_i)
    pts_j = fac._td_point(pt_j, vel_j, td, td_j)
    lam = inv_dep[..., None]
    cam_i = pts_i / lam
    imu_i = _mv3(R0, cam_i) + ex_p0
    w = _mv3(Ri, imu_i) + Pi
    imu_j = _mv3(Rj.mT, w - Pj)
    cam_j = _mv3(R1.mT, imu_j - ex_p1)
    x, y, z = cam_j.unbind(-1)
    sqrt_info = fac.PROJ_SQRT_INFO
    r = sqrt_info * (cam_j[..., :2] / z[..., None] - pts_j[..., :2])
    zero = torch.zeros_like(z)
    red = sqrt_info * torch.stack([
        torch.stack([1.0 / z, zero, -x / (z * z)], -1),
        torch.stack([zero, 1.0 / z, -y / (z * z)], -1)], -2)    # dr/dcam_j
    d_imu_j = red @ R1.mT                                       # dr/dimu_j
    d_w = d_imu_j @ Rj.mT                                       # dr/dw
    d_imu_i = d_w @ Ri                                          # dr/dimu_i
    d_cam_i = d_imu_i @ R0                                      # dr/dcam_i
    J_lam = -_mv3(d_cam_i, pts_i) / (lam * lam)
    J_td = -_mv3(d_cam_i[..., :, :2], vel_i) / lam + sqrt_info * vel_j
    J = torch.cat([d_w, -d_imu_i @ lie.skew(imu_i),
                   -d_w, d_imu_j @ lie.skew(imu_j),
                   d_imu_i, -d_cam_i @ lie.skew(cam_i),
                   -d_imu_j, red @ lie.skew(cam_j),
                   J_lam[..., None], J_td[..., None]], -1)
    return r, J


def imu_residual_jac_closed(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
                            pre_state, g, sqrt_info):
    """`factors.imu_residual_jac` with its Jacobian derived by hand (imu_factor.h's
    blocks, but the rotation residual's exactly: its corrected Δq is the
    unnormalized Δq ⊗ (1, ½ J_q^bg δbg), whose inverse divides by its
    norm): r (..., 15), J (..., 15, 30), both weighted by sqrt_info."""
    Jp = pre_state.jacobian
    dp_dba, dp_dbg = Jp[..., 0:3, 9:12], Jp[..., 0:3, 12:15]
    dq_dbg = Jp[..., 3:6, 12:15]
    dv_dba, dv_dbg = Jp[..., 6:9, 9:12], Jp[..., 6:9, 12:15]
    dba = Bai - pre_state.linearized_ba
    dbg = Bgi - pre_state.linearized_bg
    cq = lie.quat_mul(pre_state.delta_q, lie.delta_q(_mv3(dq_dbg, dbg)))
    cv = pre_state.delta_v + _mv3(dv_dba, dba) + _mv3(dv_dbg, dbg)
    cp = pre_state.delta_p + _mv3(dp_dba, dba) + _mv3(dp_dbg, dbg)
    sdt = pre_state.sum_dt[..., None]
    RiT = lie.quat_to_rot(Qi).mT
    vp = _mv3(RiT, 0.5 * g * sdt * sdt + Pj - Pi - Vi * sdt)
    vv = _mv3(RiT, g * sdt + Vj - Vi)
    A = lie.quat_mul(lie.quat_conj(Qi), Qj)
    n = torch.sum(cq * cq, -1)[..., None]
    ic = lie.quat_conj(cq) / n
    icA = lie.quat_mul(ic, A)
    r = torch.cat([vp - cp, 2.0 * icA[..., 1:], vv - cv, Baj - Bai,
                   Bgj - Bgi], -1)

    # d r_q / d bg: dc = G δbg, d(c⁻¹) = conj(dc)/n − c⁻¹ · 2 c·dc / n
    G = lie.quat_left(pre_state.delta_q)[..., :, 1:] @ dq_dbg * 0.5   # (4, 3)
    conj = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=cq.dtype,
                        device=cq.device)
    dq_bg = ((2.0 / n[..., None]) * (lie.quat_right(A) @ (conj[:, None] * G))
             - (4.0 / n[..., None]) * icA[..., :, None]
             * (cq[..., None, :] @ G))[..., 1:, :]
    eye = torch.eye(3, dtype=cq.dtype, device=cq.device).expand(RiT.shape)
    O = torch.zeros_like(RiT)
    rows = [
        [-RiT, lie.skew(vp), -RiT * sdt[..., None], -dp_dba, -dp_dbg,
         RiT, O, O, O, O],
        [O, -_vec_block(lie.quat_left(ic) @ lie.quat_right(A)), O, O, dq_bg,
         O, _vec_block(lie.quat_left(icA)), O, O, O],
        [O, lie.skew(vv), -RiT, -dv_dba, -dv_dbg, O, O, RiT, O, O],
        [O, O, O, -eye, O, O, O, O, eye, O],
        [O, O, O, O, -eye, O, O, O, O, eye],
    ]
    J = torch.cat([torch.cat(row, -1) for row in rows], -2)
    return fac._bmv(sqrt_info, r), sqrt_info @ J
