"""Trajectory writers and the absolute trajectory error (port of
esvio_tpu/io/trajectory.py: the writers, `read_tum` and `ate_rmse` with the
4-DoF yaw alignment; the SE(3)/Sim(3) alignments are not ported yet).

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


def ate_rmse(est_t, est_P, gt_t, gt_P, alignment="yaw", max_dt=0.02):
    """ATE RMSE after temporal association + alignment ("none" | "yaw")."""
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
    else:
        raise ValueError(f"alignment {alignment!r} is not ported")
    err = gt - (s * est @ R.T + t)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
