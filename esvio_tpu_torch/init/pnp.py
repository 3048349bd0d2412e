"""Gauss-Newton PnP (3D-2D pose) and PnP-RANSAC (port of
esvio_tpu/init/pnp.py): the stereo initialization's PnP chain
(cv::solvePnP in estimator.cpp:777-846) and, with the RANSAC wrapper,
loop-closure verification and relocalization (KeyFrame::PnPRANSAC,
pose_graph/src/keyframe.cpp:264-317).  `pnp_gn` takes a leading batch of
poses, so RANSAC refines all its hypotheses in one batched solve."""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.core import lie, prng
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


def _camera_points(pts_w, R, t):
    """Points (N, 3) in the camera of pose (R world→cam, t camera center),
    with a leading batch of poses: (..., N, 3) and the guarded depth."""
    pc = (pts_w - t[..., None, :]) @ R.transpose(-1, -2)
    z = torch.where(torch.abs(pc[..., 2]) > 1e-6, pc[..., 2],
                    torch.full_like(pc[..., 2], 1e-6))
    return pc, z


def pnp_gn(pts_w, obs_un, valid, R0, t0, iters: int = 10):
    """Minimize Σ‖π(R(p − t)) − obs‖² over the camera pose (R world→cam,
    t camera center).  R0 (..., 3, 3), t0 (..., 3) and valid (..., N) may
    carry a leading batch of independent problems over the same points.
    Returns (R, t, mean_err).  No host read (solve_ex)."""
    dtype, dev = pts_w.dtype, pts_w.device
    lead = tuple(R0.shape[:-2])
    w = valid.to(dtype)
    eye = torch.eye(6, dtype=dtype, device=dev)

    def residual(R, t):
        pc, z = _camera_points(pts_w, R, t)
        return (pc[..., :2] / z[..., None] - obs_un) * w[..., None]

    R, t = R0, t0
    for _ in range(iters):
        def r_of(d, R=R, t=t):
            return residual(lie.so3_exp(d[..., :3]) @ R, t + d[..., 3:6]).flatten(-2)

        r, J = jacobian_fwd(r_of, (), lead, 6, dtype, dev)
        Jt = J.transpose(-1, -2)
        d = -torch.linalg.solve_ex(Jt @ J + 1e-8 * eye, Jt @ r[..., None])[0][..., 0]
        R, t = lie.so3_exp(d[..., :3]) @ R, t + d[..., 3:6]
    r = residual(R, t)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    err = torch.sum(torch.linalg.vector_norm(r, dim=-1), dim=-1) / n
    return R, t, err


def _inliers(pts_w, obs_un, valid, R, t, threshold):
    pc, z = _camera_points(pts_w, R, t)
    err = torch.linalg.vector_norm(pc[..., :2] / z[..., None] - obs_un, dim=-1)
    return (err < threshold) & valid & (pc[..., 2] > 0)


def pnp_ransac(key, pts_w, obs_un, valid, R0, t0, threshold: float = 10.0 / 460.0,
               num_hypotheses: int = 100, iters: int = 10):
    """RANSAC PnP in normalized coordinates with a prior pose seed
    (KeyFrame::PnPRANSAC: 100 iterations, 10/460 threshold).

    Each hypothesis refines the seed pose on a random minimal set (6 of the
    valid points, drawn as `jax.random.randint` draws them from `key`) by
    GN, all hypotheses as one batch; inliers by reprojection distance; the
    best model (the first of equal counts) is refined again on its inliers.
    Returns (R, t, inliers).  No host read."""
    N = pts_w.shape[0]
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    n_valid = torch.clamp(torch.sum(valid), min=6)
    draws = prng.randint(key, (num_hypotheses, 6), 0, n_valid)
    sel = torch.zeros((num_hypotheses, N), dtype=torch.bool, device=pts_w.device)
    sel = sel.scatter(1, order[draws], True) & valid
    Rs, ts, _ = pnp_gn(pts_w, obs_un, sel, R0.expand(num_hypotheses, 3, 3),
                       t0.expand(num_hypotheses, 3), iters=iters)
    inls = _inliers(pts_w, obs_un, valid, Rs, ts, threshold)
    best = torch.argmax(torch.sum(inls, dim=-1))
    R, t, _ = pnp_gn(pts_w, obs_un, inls[best], Rs[best], ts[best], iters=iters)
    return R, t, _inliers(pts_w, obs_un, valid, R, t, threshold)
