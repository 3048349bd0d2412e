"""Camera-IMU extrinsic rotation self-calibration, hand-eye (port of
esvio_tpu/init/ex_rotation.py; InitialEXRotation::CalibrationExRotation,
initial_ex_rotation.cpp, used when estimate_extrinsic == 2,
estimator.cpp:226-242).

From pairs of per-interval camera rotations (essential matrix) and IMU
preintegrated rotations, Qleft(q_cam)·q = Qright(q_imu)·q is solved for the
body→camera quaternion as the null vector of the stacked (4N, 4) system,
with Huber down-weighting of pairs that disagree with the current
estimate."""
from __future__ import annotations

import math

import torch

from esvio_tpu_torch.core import lie


def calibrate_ex_rotation(q_cam, q_imu, ric0, valid=None):
    """q_cam (N, 4) camera relative rotations c_k→c_{k+1}; q_imu (N, 4)
    preintegrated body rotations b_k→b_{k+1}; ric0 (4,) the current
    cam→body extrinsic (the estimator's ex_q convention) for the Huber
    weights; valid (N,) the live pairs.

    Returns (q_ric, ok, S): the calibrated cam→body quaternion, the
    convergence flag and the singular values.  No host read."""
    dtype, dev = q_cam.dtype, q_cam.device
    N = q_cam.shape[0]
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)

    # camera rotation predicted from the IMU: ric⁻¹ ⊗ q_imu ⊗ ric
    q_pred = lie.quat_mul(lie.quat_mul(lie.quat_inv(ric0).expand(q_imu.shape),
                                       q_imu), ric0.expand(q_imu.shape))
    d = lie.quat_mul(lie.quat_inv(q_cam), q_pred)
    ang = 2.0 * torch.atan2(torch.linalg.vector_norm(d[:, 1:], dim=-1),
                            torch.abs(d[:, 0]))
    ang_deg = ang * (180.0 / math.pi)
    huber = torch.where(ang_deg > 5.0, 5.0 / torch.clamp(ang_deg, min=1e-6),
                        torch.ones_like(ang_deg))
    w = huber * valid.to(dtype)

    # w · (Qleft(q_cam) − Qright(q_imu)) stacked (reference :58-72)
    A = ((lie.quat_left(q_cam) - lie.quat_right(q_imu))
         * w[:, None, None]).reshape(N * 4, 4)
    _, S, Vh = torch.linalg.svd(A, full_matrices=False)
    # the null vector q solves q_cam ⊗ q = q ⊗ q_imu, so it is body→cam;
    # its inverse is the cam→body ex_q (reference :70-73)
    q = Vh[-1]
    q = torch.where(q[0] < 0, -q, q)
    q = lie.quat_inv(q / torch.linalg.vector_norm(q))
    # the reference's absolute gate (S[2] > 0.25) or the scale-invariant one:
    # the observable directions well separated from the null space
    n = torch.sum(valid)
    ok = ((S[2] > 0.25) | ((S[2] > 10.0 * S[3]) & (S[2] > 0.05) & (n >= 15))) \
        & (n >= 10)
    return q, ok, S
