"""IMU preintegration — mid-point Δp/Δq/Δv with 15×15 Jacobian and
covariance (port of esvio_tpu/imu/preintegration.py;
integration_base.h:54-157).

The sample buffer of each interval is integrated by a Python loop over the
masked, fixed-capacity sample axis; intervals are a leading batch axis.
The caller may stop the loop after the last real sample it knows of
(trailing padding steps are no-ops by the mask), or run it a chunk of steps
at a time from a `Carry` (`integrate_begin`, `integrate_steps`,
`integrate_end`), as the estimator's tick graphs do.

Error-state ordering: [p, θ, v, ba, bg]; noise ordering (18):
[na0, ng0, na1, ng1, nba, nbg].
"""
from __future__ import annotations

import dataclasses

import torch

from esvio_tpu_torch.core import lie

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


@dataclasses.dataclass
class ImuParams:
    acc_n: torch.Tensor
    gyr_n: torch.Tensor
    acc_w: torch.Tensor
    gyr_w: torch.Tensor
    g: torch.Tensor  # (3,) gravity vector in world


def make_imu_params(acc_n=0.2, gyr_n=0.05, acc_w=0.002, gyr_w=4e-5,
                    g_norm=9.80766, dtype=torch.float32, device=None) -> ImuParams:
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return ImuParams(acc_n=t(acc_n), gyr_n=t(gyr_n), acc_w=t(acc_w),
                     gyr_w=t(gyr_w), g=t([0.0, 0.0, g_norm]))


@dataclasses.dataclass
class Preintegrated:
    """One IMU interval (or a leading batch of them) integrated at the
    linearization biases."""

    delta_p: torch.Tensor      # (..., 3)
    delta_q: torch.Tensor      # (..., 4) wxyz
    delta_v: torch.Tensor      # (..., 3)
    jacobian: torch.Tensor     # (..., 15, 15)
    covariance: torch.Tensor   # (..., 15, 15)
    sum_dt: torch.Tensor       # (...)
    linearized_ba: torch.Tensor  # (..., 3)
    linearized_bg: torch.Tensor  # (..., 3)

    def index(self, i):
        return Preintegrated(*(getattr(self, f.name)[i]
                               for f in dataclasses.fields(self)))


def _noise_cov(params: ImuParams, dtype):
    eye = torch.eye(3, dtype=dtype, device=params.g.device)
    an2 = params.acc_n * params.acc_n
    gn2 = params.gyr_n * params.gyr_n
    aw2 = params.acc_w * params.acc_w
    gw2 = params.gyr_w * params.gyr_w
    return torch.block_diag(an2 * eye, gn2 * eye, an2 * eye, gn2 * eye,
                            aw2 * eye, gw2 * eye)


def _mm(a, b):
    return torch.matmul(a, b)


def midpoint_step(dt, acc_0, gyr_0, acc_1, gyr_1, delta_p, delta_q, delta_v,
                  ba, bg, jacobian, covariance, noise):
    """One mid-point integration step (integration_base.h:54-127), batched
    over leading axes: dt (...), vectors (..., 3), matrices (..., 15, 15)."""
    dtype, dev = delta_p.dtype, delta_p.device
    d1 = dt[..., None]
    un_acc_0 = lie.quat_rotate(delta_q, acc_0 - ba)
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    dq_step = torch.cat([torch.ones_like(un_gyr[..., :1]), un_gyr * d1 * 0.5], -1)
    result_q = lie.quat_normalize(lie.quat_mul(delta_q, dq_step))
    un_acc_1 = lie.quat_rotate(result_q, acc_1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    result_p = delta_p + delta_v * d1 + 0.5 * un_acc * d1 * d1
    result_v = delta_v + un_acc * d1

    # error-state transition F (15×15) and noise mapping V (15×18)
    R_w = lie.skew(un_gyr)
    R_a0 = lie.skew(acc_0 - ba)
    R_a1 = lie.skew(acc_1 - ba)
    Rq = lie.quat_to_rot(delta_q)
    Rq1 = lie.quat_to_rot(result_q)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(Rq.shape)
    d = dt[..., None, None]
    dt2 = d * d
    lead = dt.shape

    F = torch.zeros(lead + (15, 15), dtype=dtype, device=dev)
    F[..., 0:3, 0:3] = eye
    F[..., 0:3, 3:6] = (-0.25 * _mm(Rq, R_a0) * dt2
                        - 0.25 * _mm(_mm(Rq1, R_a1), eye - R_w * d) * dt2)
    F[..., 0:3, 6:9] = eye * d
    F[..., 0:3, 9:12] = -0.25 * (Rq + Rq1) * dt2
    F[..., 0:3, 12:15] = 0.25 * _mm(Rq1, R_a1) * dt2 * d
    F[..., 3:6, 3:6] = eye - R_w * d
    F[..., 3:6, 12:15] = -eye * d
    F[..., 6:9, 3:6] = (-0.5 * _mm(Rq, R_a0) * d
                        - 0.5 * _mm(_mm(Rq1, R_a1), eye - R_w * d) * d)
    F[..., 6:9, 6:9] = eye
    F[..., 6:9, 9:12] = -0.5 * (Rq + Rq1) * d
    F[..., 6:9, 12:15] = 0.5 * _mm(Rq1, R_a1) * d * d
    F[..., 9:12, 9:12] = eye
    F[..., 12:15, 12:15] = eye

    V = torch.zeros(lead + (15, 18), dtype=dtype, device=dev)
    v03 = -0.25 * _mm(Rq1, R_a1) * dt2 * (0.5 * d)
    V[..., 0:3, 0:3] = 0.25 * Rq * dt2
    V[..., 0:3, 3:6] = v03
    V[..., 0:3, 6:9] = 0.25 * Rq1 * dt2
    V[..., 0:3, 9:12] = v03
    v63 = -0.5 * _mm(Rq1, R_a1) * d * (0.5 * d)
    V[..., 3:6, 3:6] = 0.5 * eye * d
    V[..., 3:6, 9:12] = 0.5 * eye * d
    V[..., 6:9, 0:3] = 0.5 * Rq * d
    V[..., 6:9, 3:6] = v63
    V[..., 6:9, 6:9] = 0.5 * Rq1 * d
    V[..., 6:9, 9:12] = v63
    V[..., 9:12, 12:15] = eye * d
    V[..., 12:15, 15:18] = eye * d

    new_jac = _mm(F, jacobian)
    new_cov = _mm(_mm(F, covariance), F.transpose(-1, -2)) \
        + _mm(_mm(V, noise), V.transpose(-1, -2))
    return result_p, result_q, result_v, new_jac, new_cov


@dataclasses.dataclass
class Carry:
    """An integration between two steps (a leading batch of intervals):
    the deltas so far, the last sample taken, and the next step's index."""

    delta_p: torch.Tensor      # (K, 3)
    delta_q: torch.Tensor      # (K, 4) wxyz
    delta_v: torch.Tensor      # (K, 3)
    jacobian: torch.Tensor     # (K, 15, 15)
    covariance: torch.Tensor   # (K, 15, 15)
    sum_dt: torch.Tensor       # (K,)
    acc0: torch.Tensor         # (K, 3)
    gyr0: torch.Tensor         # (K, 3)
    step: torch.Tensor         # () int64


def integrate_begin(acc0, gyr0, dtype) -> Carry:
    """The carry before the first step: acc0/gyr0 (K, 3) the sample at
    interval start."""
    K, dev = acc0.shape[0], acc0.device
    return Carry(
        delta_p=torch.zeros((K, 3), dtype=dtype, device=dev),
        delta_q=torch.eye(1, 4, dtype=dtype, device=dev).repeat(K, 1),
        delta_v=torch.zeros((K, 3), dtype=dtype, device=dev),
        jacobian=torch.eye(15, dtype=dtype, device=dev).repeat(K, 1, 1),
        covariance=torch.zeros((K, 15, 15), dtype=dtype, device=dev),
        sum_dt=torch.zeros((K,), dtype=dtype, device=dev),
        acc0=acc0.to(dtype), gyr0=gyr0.to(dtype),
        step=torch.zeros((), dtype=torch.int64, device=dev))


def _steps(c: Carry, dts, accs, gyrs, mask, ba, bg, noise) -> Carry:
    """One midpoint step per column of dts (K, S), accs/gyrs (K, S, 3),
    mask (K, S); a masked step leaves its interval as it was."""
    dp, dq, dv, jac, cov = (c.delta_p, c.delta_q, c.delta_v, c.jacobian,
                            c.covariance)
    sum_dt, a0, g0 = c.sum_dt, c.acc0, c.gyr0
    for n in range(dts.shape[1]):
        dt, a1, g1, m = dts[:, n], accs[:, n], gyrs[:, n], mask[:, n]
        ndp, ndq, ndv, njac, ncov = midpoint_step(
            dt, a0, g0, a1, g1, dp, dq, dv, ba, bg, jac, cov, noise)
        m1, m2 = m[:, None], m[:, None, None]
        dp = torch.where(m1, ndp, dp)
        dq = torch.where(m1, ndq, dq)
        dv = torch.where(m1, ndv, dv)
        jac = torch.where(m2, njac, jac)
        cov = torch.where(m2, ncov, cov)
        sum_dt = torch.where(m, sum_dt + dt, sum_dt)
        a0 = torch.where(m1, a1, a0)
        g0 = torch.where(m1, g1, g0)
    return Carry(dp, dq, dv, jac, cov, sum_dt, a0, g0,
                 c.step + dts.shape[1])


def integrate_steps(c: Carry, dts, accs, gyrs, mask, ba, bg,
                    params: ImuParams, n: int) -> Carry:
    """Steps c.step .. c.step + n - 1 of the sample buffers (shapes as
    `preintegrate_batch`), the columns read at the carry's step index on
    the device: the host need not know where the integration stands, so
    one CUDA graph of n steps, replayed, runs any number of them.  A step
    past the buffers is a no-op, as a masked one is."""
    dtype, N = c.delta_p.dtype, dts.shape[1]
    idx = c.step + torch.arange(n, device=dts.device)
    inside = idx < N
    idx = idx.clamp(max=N - 1)
    return _steps(c, dts.index_select(1, idx).to(dtype),
                  accs.index_select(1, idx).to(dtype),
                  gyrs.index_select(1, idx).to(dtype),
                  mask.index_select(1, idx).to(torch.bool) & inside,
                  ba, bg, _noise_cov(params, dtype))


def integrate_end(c: Carry, ba, bg) -> Preintegrated:
    """The intervals integrated so far, at the linearization biases ba/bg."""
    dtype = c.delta_p.dtype
    return Preintegrated(delta_p=c.delta_p, delta_q=c.delta_q,
                         delta_v=c.delta_v, jacobian=c.jacobian,
                         covariance=c.covariance, sum_dt=c.sum_dt,
                         linearized_ba=ba.to(dtype), linearized_bg=bg.to(dtype))


def preintegrate_batch(dts, accs, gyrs, acc0, gyr0, ba, bg,
                       params: ImuParams, mask, n_steps=None) -> Preintegrated:
    """Integrate K intervals at once.

    dts (K, N); accs/gyrs (K, N, 3) (acc_1 of each step); acc0/gyr0 (K, 3)
    the sample at interval start; ba/bg (K, 3) linearization biases;
    mask (K, N) bool — True for real samples (padding steps are skipped).

    n_steps: how many leading steps to run (all N by default), at least the
    longest interval's sample count: later steps are no-ops by the mask, so
    any larger value gives the same result.  The estimator passes it from
    its host-side sample counts."""
    dtype = accs.dtype
    n = dts.shape[1] if n_steps is None else n_steps
    c = _steps(integrate_begin(acc0, gyr0, dtype), dts[:, :n].to(dtype),
               accs[:, :n], gyrs[:, :n], mask[:, :n].to(torch.bool), ba, bg,
               _noise_cov(params, dtype))
    return integrate_end(c, ba, bg)


def preintegrate(dts, accs, gyrs, acc0, gyr0, ba, bg, params: ImuParams,
                 mask=None) -> Preintegrated:
    """One interval: dts (N,), accs/gyrs (N, 3), acc0/gyr0/ba/bg (3,)."""
    if mask is None:
        mask = torch.ones(dts.shape, dtype=torch.bool, device=dts.device)
    return preintegrate_batch(
        dts[None], accs[None], gyrs[None], acc0[None], gyr0[None], ba[None],
        bg[None], params, mask[None]).index(0)


def _bmv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def evaluate(pre: Preintegrated, g, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
    """15-dim preintegration residual (integration_base.h:159-185), batched
    over leading axes."""
    J = pre.jacobian
    dp_dba = J[..., O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = J[..., O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = J[..., O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = J[..., O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = J[..., O_V:O_V + 3, O_BG:O_BG + 3]

    dba = Bai - pre.linearized_ba
    dbg = Bgi - pre.linearized_bg

    corrected_q = lie.quat_mul(pre.delta_q, lie.delta_q(_bmv(dq_dbg, dbg)))
    corrected_v = pre.delta_v + _bmv(dv_dba, dba) + _bmv(dv_dbg, dbg)
    corrected_p = pre.delta_p + _bmv(dp_dba, dba) + _bmv(dp_dbg, dbg)

    sdt = pre.sum_dt[..., None]
    qi_inv = lie.quat_conj(Qi)
    r_p = lie.quat_rotate(qi_inv, lie.scale(g, 0.5) * sdt * sdt + Pj - Pi - Vi * sdt) \
        - corrected_p
    r_q = lie.scale(lie.quat_mul(lie.quat_inv(corrected_q),
                                 lie.quat_mul(qi_inv, Qj))[..., 1:], 2.0)
    r_v = lie.quat_rotate(qi_inv, g * sdt + Vj - Vi) - corrected_v
    return torch.cat([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi], dim=-1)
