"""Factor residuals and their manifold Jacobians (port of
esvio_tpu/solver/factors.py).

Residuals re-derive the reference Ceres cost functions (imu_factor.h,
projectionTwoFrame{One,Two}CamFactor.cpp, projectionOneFrameTwoCamFactor).
Jacobians w.r.t. tangent-space perturbations are taken in forward mode
(dual tensors of `torch.autograd.forward_ad`), all tangent directions at
once as an extra leading axis — the counterpart of the JAX package's
`jax.jacfwd` under `vmap`.  Every function broadcasts over leading factor
axes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.imu import preintegration as pre
from esvio_tpu_torch.solver.window import FOCAL

PROJ_SQRT_INFO = FOCAL / 1.5   # projection sqrt-info (factor .cpp:33)


def jacobian_fwd(f, consts, lead, n: int, dtype, device):
    """(r, J) of f(δ, *consts) at δ = 0, where f maps δ (..., n) to
    r (..., m) and broadcasts over the leading `lead` factor axes:
    r (*lead, m), J (*lead, m, n).

    Every tensor f reads goes in through `consts` and enters as a dual
    number with a dense zero tangent: a plain tensor meeting a dual one
    would get a lazy zero tangent, whose arithmetic runs a slow Python
    path op by op."""
    d0 = torch.zeros((n,) + tuple(lead) + (n,), dtype=dtype, device=device)
    basis = torch.eye(n, dtype=dtype, device=device).reshape(
        (n,) + (1,) * len(lead) + (n,)).expand(d0.shape)
    with fwAD.dual_level():
        args = [fwAD.make_dual(c.contiguous(), torch.zeros_like(c.contiguous()))
                for c in consts]
        r, jr = fwAD.unpack_dual(f(fwAD.make_dual(d0, basis), *args))
    return r[0], jr.movedim(0, -1)


# ---------------------------------------------------------------------------
# IMU factor
# ---------------------------------------------------------------------------

def imu_sqrt_info(covariance):
    """Upper-triangular U with UᵀU = cov⁻¹ (imu_factor.h:48); NaN where the
    Cholesky fails (as the JAX/LAPACK path returns)."""
    dim = covariance.shape[-1]
    eye = torch.eye(dim, dtype=covariance.dtype, device=covariance.device)
    # solve_ex: linalg.solve would check `info` on the host
    cov_inv = torch.linalg.solve_ex(covariance + 1e-12 * eye,
                                    eye.expand(covariance.shape))[0]
    cov_inv = 0.5 * (cov_inv + cov_inv.transpose(-1, -2))
    L, info = torch.linalg.cholesky_ex(cov_inv)
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    return L.transpose(-1, -2)


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def imu_residual(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj,
                 pre_state: pre.Preintegrated, g, sqrt_info):
    """(..., 15) weighted residual."""
    r = pre.evaluate(pre_state, g, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)
    return _bmv(sqrt_info, r)


def imu_residual_jac(Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj, pre_state, g,
                     sqrt_info):
    """Residual + Jacobian w.r.t. (δpose_i 6, δsb_i 9, δpose_j 6, δsb_j 9):
    r (..., 15), J (..., 15, 30)."""

    n_pre = len(dataclasses.fields(pre_state))

    def f(d, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj, g, sqrt_info, *pre_f):
        dpi, dsi, dpj, dsj = d[..., 0:6], d[..., 6:15], d[..., 15:21], d[..., 21:30]
        Qi_ = lie.quat_mul(Qi, lie.delta_q(dpi[..., 3:6]))
        Qj_ = lie.quat_mul(Qj, lie.delta_q(dpj[..., 3:6]))
        r = pre.evaluate(
            pre.Preintegrated(*pre_f[:n_pre]), g,
            Pi + dpi[..., 0:3], Qi_, Vi + dsi[..., 0:3], Bai + dsi[..., 3:6],
            Bgi + dsi[..., 6:9],
            Pj + dpj[..., 0:3], Qj_, Vj + dsj[..., 0:3], Baj + dsj[..., 3:6],
            Bgj + dsj[..., 6:9])
        return _bmv(sqrt_info, r)

    consts = (Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj, g, sqrt_info,
              *(getattr(pre_state, fl.name) for fl in dataclasses.fields(pre_state)))
    return jacobian_fwd(f, consts, Pi.shape[:-1], 30, Pi.dtype, Pi.device)


# ---------------------------------------------------------------------------
# Projection factors (td-compensated); velocities are (2,) on the
# normalized plane
# ---------------------------------------------------------------------------

def _td_point(pt2, vel2, td, td_obs):
    p = pt2 - (td - td_obs)[..., None] * vel2
    one = torch.ops.aten.add.Scalar(lie.scale(p[..., :1], 0.0), 1.0)
    return torch.cat([p, one], dim=-1)


def proj_two_frame_two_cam(Pi, Qi, Pj, Qj, ex_p0, ex_q0, ex_p1, ex_q1,
                           inv_dep, td, pt_i, vel_i, td_i, pt_j, vel_j, td_j):
    """Cross-camera temporal-stereo residual (projectionTwoFrameTwoCamFactor);
    with ex1 := ex0 it is the mono TwoFrameOneCam residual."""
    pts_i = _td_point(pt_i, vel_i, td, td_i)
    pts_j = _td_point(pt_j, vel_j, td, td_j)
    cam_i = pts_i / inv_dep[..., None]
    imu_i = lie.quat_rotate(ex_q0, cam_i) + ex_p0
    w = lie.quat_rotate(Qi, imu_i) + Pi
    imu_j = lie.quat_rotate(lie.quat_conj(Qj), w - Pj)
    cam_j = lie.quat_rotate(lie.quat_conj(ex_q1), imu_j - ex_p1)
    r = cam_j[..., :2] / cam_j[..., 2:3] - pts_j[..., :2]
    return lie.scale(r, PROJ_SQRT_INFO)


def proj22_jac(Pi, Qi, Pj, Qj, ex_p0, ex_q0, ex_p1, ex_q1, inv_dep, td,
               pt_i, vel_i, td_i, pt_j, vel_j, td_j):
    """r (..., 2), J (..., 2, 26): [pose_i 6 | pose_j 6 | ex0 6 | ex1 6 | λ | td]."""

    def f(d, Pi, Qi, Pj, Qj, ex_p0, ex_q0, ex_p1, ex_q1, inv_dep, td,
          pt_i, vel_i, td_i, pt_j, vel_j, td_j):
        Qi_ = lie.quat_mul(Qi, lie.delta_q(d[..., 3:6]))
        Qj_ = lie.quat_mul(Qj, lie.delta_q(d[..., 9:12]))
        exq0_ = lie.quat_mul(ex_q0, lie.delta_q(d[..., 15:18]))
        exq1_ = lie.quat_mul(ex_q1, lie.delta_q(d[..., 21:24]))
        return proj_two_frame_two_cam(
            Pi + d[..., 0:3], Qi_, Pj + d[..., 6:9], Qj_,
            ex_p0 + d[..., 12:15], exq0_, ex_p1 + d[..., 18:21], exq1_,
            inv_dep + d[..., 24], td + d[..., 25], pt_i, vel_i, td_i,
            pt_j, vel_j, td_j)

    consts = (Pi, Qi, Pj, Qj, ex_p0, ex_q0, ex_p1, ex_q1, inv_dep, td,
              pt_i, vel_i, td_i, pt_j, vel_j, td_j)
    return jacobian_fwd(f, consts, inv_dep.shape, 26, Pi.dtype, Pi.device)


def cauchy_weight(r2, c: float = 1.0):
    """IRLS weight √ρ'(s) for Ceres CauchyLoss(c): ρ(s) = c² log(1+s/c²)."""
    return 1.0 / torch.sqrt(1.0 + r2 / (c * c))
