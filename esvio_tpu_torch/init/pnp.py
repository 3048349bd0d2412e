"""Gauss-Newton PnP (3D-2D pose) used by the stereo initialization's PnP
chain (port of `pad_points` and `pnp_gn`, esvio_tpu/init/pnp.py;
cv::solvePnP in estimator.cpp:777-846).  `pnp_ransac` (relocalization)
is not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.solver.factors import jacobian_fwd


def pad_points(pts_w, obs_un, min_size: int = 16):
    """Pad host (n, 3)/(n, 2) correspondences to the next power-of-two
    bucket (at least min_size) with a validity mask (numpy)."""
    n = len(pts_w)
    b = max(min_size, 1 << max(n - 1, 0).bit_length())
    P = np.zeros((b, 3), float)
    O = np.zeros((b, 2), float)
    V = np.zeros(b, bool)
    if n:
        P[:n] = np.asarray(pts_w, float)
        O[:n] = np.asarray(obs_un, float)
        V[:n] = True
    return P, O, V


def pnp_gn(pts_w, obs_un, valid, R0, t0, iters: int = 10):
    """Minimize Σ‖π(R(p − t)) − obs‖² over the camera pose (R world→cam,
    t camera center).  Returns (R, t, mean_err)."""
    dtype, dev = pts_w.dtype, pts_w.device
    w = valid.to(dtype)
    eye = torch.eye(6, dtype=dtype, device=dev)

    def residual(R, t):
        pc = (pts_w - t[..., None, :]) @ R.transpose(-1, -2)
        z = torch.where(torch.abs(pc[..., 2]) > 1e-6, pc[..., 2],
                        torch.full_like(pc[..., 2], 1e-6))
        return (pc[..., :2] / z[..., None] - obs_un) * w[:, None]

    R, t = R0, t0
    for _ in range(iters):
        def r_of(d, R=R, t=t):
            return residual(lie.so3_exp(d[..., :3]) @ R, t + d[..., 3:6]).flatten(-2)

        r, J = jacobian_fwd(r_of, (), (), 6, dtype, dev)
        H = J.T @ J + 1e-8 * eye
        d = -torch.linalg.solve(H, J.T @ r)
        R, t = lie.so3_exp(d[:3]) @ R, t + d[3:6]
    r = residual(R, t)
    n = torch.clamp(torch.sum(w), min=1.0)
    err = torch.sum(torch.linalg.vector_norm(r, dim=-1)) / n
    return R, t, err
