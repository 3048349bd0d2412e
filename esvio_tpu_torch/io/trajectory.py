"""Trajectory writers and the absolute trajectory error (port of
esvio_tpu/io/trajectory.py: the writers, `read_tum` and `ate_rmse` with its
four alignments, in numpy).

The writers match the reference's files byte for byte:
  * VIO CSV — `esvio_result_no_loop.csv`: ns, P, Q(wxyz), V, trailing comma
    (esvio_estimator/src/utility/visualization.cpp:185-200)
  * loop TXT — `esvio_result_loop.txt`: t x y z qx qy qz qw
    (pose_graph/src/pose_graph.cpp:635-652)
"""
from __future__ import annotations

import numpy as np


def write_vio_csv(path, stamps, P, Q, V):
    """stamps in seconds; P/V (N, 3); Q (N, 4) wxyz."""
    with open(path, "w") as f:
        for k in range(len(stamps)):
            f.write(f"{stamps[k] * 1e9:.0f},")
            f.write(f"{P[k][0]:.5f},{P[k][1]:.5f},{P[k][2]:.5f},")
            f.write(f"{Q[k][0]:.5f},{Q[k][1]:.5f},{Q[k][2]:.5f},{Q[k][3]:.5f},")
            f.write(f"{V[k][0]:.5f},{V[k][1]:.5f},{V[k][2]:.5f},\n")


def write_tum(path, stamps, P, Q):
    """TUM-style: t x y z qx qy qz qw (Q input is wxyz)."""
    with open(path, "w") as f:
        for k in range(len(stamps)):
            q = Q[k]
            f.write(f"{stamps[k]:.6f} {P[k][0]:.6f} {P[k][1]:.6f} {P[k][2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def read_tum(path):
    """(t, P, Q wxyz) of a TUM-style file."""
    data = np.loadtxt(path)
    t = data[:, 0]
    P = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    Q = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
    return t, P, Q


def _umeyama_alignment(est, gt, with_scale=False):
    """SE(3) (+ scale) alignment est → gt (Umeyama); returns (s, R, t)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (np.trace(np.diag(D) @ S) / (E * E).sum() * len(est)) if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def _yaw_alignment(est, gt):
    """4-DoF (yaw + translation) alignment est → gt."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = (est - mu_e)[:, :2]
    G = (gt - mu_g)[:, :2]
    num = (E[:, 0] * G[:, 1] - E[:, 1] * G[:, 0]).sum()
    den = (E[:, 0] * G[:, 0] + E[:, 1] * G[:, 1]).sum()
    yaw = np.arctan2(num, den)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return 1.0, R, mu_g - R @ mu_e


def ate_rmse(est_t, est_P, gt_t, gt_P, alignment="se3", max_dt=0.02):
    """Absolute trajectory error RMSE after temporal association +
    alignment: "none" | "yaw" (4-DoF, the fair metric for VIO) | "se3" |
    "sim3"."""
    est_t = np.asarray(est_t)
    gt_t = np.asarray(gt_t)
    gt_P = np.asarray(gt_P)
    gt_interp = np.stack(
        [np.interp(est_t, gt_t, gt_P[:, k]) for k in range(3)], axis=1)
    ok = (est_t >= gt_t[0] - max_dt) & (est_t <= gt_t[-1] + max_dt)
    est = np.asarray(est_P)[ok]
    gt = gt_interp[ok]
    if len(est) < 2:
        return float("nan")
    if alignment == "none":
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    elif alignment == "yaw":
        s, R, t = _yaw_alignment(est, gt)
    elif alignment == "se3":
        s, R, t = _umeyama_alignment(est, gt, with_scale=False)
    elif alignment == "sim3":
        s, R, t = _umeyama_alignment(est, gt, with_scale=True)
    else:
        raise ValueError(alignment)
    err = gt - (s * est @ R.T + t)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
