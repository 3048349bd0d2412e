"""Absolute trajectory error (port of `ate_rmse` with the 4-DoF yaw
alignment, esvio_tpu/io/trajectory.py).  The trajectory writers and the
SE(3)/Sim(3) alignments are not ported yet."""
from __future__ import annotations

import numpy as np


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
