"""The plain reference that decides `correct`, in numpy.

It knows the scene (the plane, the cameras, the closed-form trajectory the
streams were rendered from, evaluated here on its own) and reads the
program's outputs only to judge them:

  * front-end packets (event and image): a feature's normalized left
    coordinates, cast as a ray at the true pose of its stamp, meet the
    plane in one point; that point, projected at the next tick's true pose,
    is where the same id has to be (`*_track_*`), and projected into the
    right camera at the same stamp, where its right match has to be
    (`*_stereo_*`);
  * how many features each packet holds, against the configuration's
    `max_cnt` (`*_features_short`, `*_stereo_short`);
  * the estimator's trajectory: the RMSE of its positions over the window
    against the true ones after the 4-DoF (yaw and translation) alignment
    that visual-inertial odometry cannot observe (`ate_m`);
  * the loop closer's corrected path, the same way (`loop_ate_m`).

Of the pixel errors of a window's features it reads the median length
(`*_px`), the median signed error as one vector (`*_stereo_bias_px`: a
calibration or matching error that shifts every feature alike, which the
scatter of single features hides), the share longer than 1 px
(`*_over1px`: features the median lets be wrong).  A reading with
nothing to judge is infinite, so it fails.  `ate_frozen_m` is the reading
`ate_m` would give a state left unchanged (the reference put in the
program's place with a constant position): not compared, the upper reading
of `ate_m` and `loop_ate_m`.
"""
from __future__ import annotations

import math

import numpy as np


def _so3_exp(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = w / np.maximum(th, 1e-300)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


class Truth:
    """The true body pose of the circuit `traffic["circuit"]`, started tau
    seconds into its period, at any stamp."""

    def __init__(self, traffic: dict, tau: float):
        c = traffic["circuit"]
        self.r = float(c["radius_m"])
        self.f = float(c["circle_hz"])
        self.amp = math.radians(float(c["wobble_deg"]))
        self.wf = [float(x) for x in c["wobble_hz"]]
        self.wp = [float(x) for x in c["wobble_phase"]]
        self.speed = float(c["speed"])
        self.tau = float(tau)

    def pose(self, t):
        """(R_wb (N, 3, 3), p_wb (N, 3)) at stamps t (N,)."""
        u = (np.asarray(t, np.float64) + self.tau) * self.speed
        th = 2 * math.pi * self.f * u
        p = np.stack([self.r * np.sin(th), self.r * (np.cos(th) - 1.0),
                      np.zeros_like(th)], -1)
        w = np.stack([self.amp * np.sin(2 * math.pi * self.wf[0] * u + self.wp[0]),
                      self.amp * np.sin(2 * math.pi * self.wf[1] * u + self.wp[1]),
                      np.zeros_like(u)], -1)
        return _so3_exp(w), p


def _cam(R, p, offset):
    return R, p + R @ np.asarray(offset, np.float64)


def _on_plane(R, c, un, plane_z):
    ray = R @ np.array([un[0], un[1], 1.0])
    return c + (plane_z - c[2]) / ray[2] * ray


def _project(R, c, X):
    x = R.T @ (X - c)
    return x[:2] / x[2]


def packet_errors(packets, truth, scene, fx, fy):
    """The signed pixel errors of a list of packets, each a dict(t, ids,
    valid, un, right_valid, un_right) of numpy arrays in tick order:
    dict(track (N, 2), stereo (M, 2), features (T,) and matched (T,): the
    features and stereo matches of each packet)."""
    px = np.array([fx, fy])
    track, stereo, features, matched = [], [], [], []
    z = scene["plane_z_m"]
    right = (scene["baseline_m"], 0.0, 0.0)
    prev = None
    for pk in packets:
        R, p = truth.pose([pk["t"]])
        R, p = R[0], p[0]
        Rr, cr = _cam(R, p, right)
        ok = pk["valid"] & (pk["ids"] >= 0)
        both = ok & pk["right_valid"]
        features.append(int(ok.sum()))
        matched.append(int(both.sum()))
        for i in np.nonzero(both)[0]:
            X = _on_plane(R, p, pk["un"][i], z)
            stereo.append((pk["un_right"][i] - _project(Rr, cr, X)) * px)
        if prev is not None:
            R0, p0 = prev[0]
            where = {int(d): k for k, d in enumerate(prev[1]["ids"])
                     if prev[2][k]}
            for i in np.nonzero(ok)[0]:
                k = where.get(int(pk["ids"][i]))
                if k is None:
                    continue
                X = _on_plane(R0, p0, prev[1]["un"][k], z)
                track.append((pk["un"][i] - _project(R, p, X)) * px)
        prev = ((R, p), pk, ok)

    def arr(v):
        return np.asarray(v, np.float64).reshape(-1, 2)

    return dict(track=arr(track), stereo=arr(stereo),
                features=np.asarray(features), matched=np.asarray(matched))


def yaw_aligned_rmse(est, gt):
    """RMSE of est (N, 3) against gt after the yaw + translation alignment
    that minimises it."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    if len(est) < 2:
        return math.inf
    me, mg = est.mean(0), gt.mean(0)
    E, G = (est - me)[:, :2], (gt - mg)[:, :2]
    yaw = math.atan2((E[:, 0] * G[:, 1] - E[:, 1] * G[:, 0]).sum(),
                     (E[:, 0] * G[:, 0] + E[:, 1] * G[:, 1]).sum())
    c, s = math.cos(yaw), math.sin(yaw)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    err = gt - ((est - me) @ Rz.T + mg)
    return float(np.sqrt((err ** 2).sum(1).mean()))


def _median(v):
    return float(np.median(v)) if len(v) else math.inf


def _share_over(e, px):
    return float(np.mean(np.hypot(e[:, 0], e[:, 1]) > px)) if len(e) else math.inf


def _bias(e):
    return float(np.hypot(*np.median(e, 0))) if len(e) else math.inf


def _short(n, max_cnt):
    return 1.0 - float(np.mean(n)) / max_cnt if len(n) else math.inf


def front_end(prefix, e, max_cnt):
    """The readings of one front end's packet_errors."""
    tr, st = e["track"], e["stereo"]
    return {
        f"{prefix}_track_px": _median(np.hypot(tr[:, 0], tr[:, 1])),
        f"{prefix}_stereo_px": _median(np.hypot(st[:, 0], st[:, 1])),
        f"{prefix}_stereo_bias_px": _bias(st),
        f"{prefix}_track_over1px": _share_over(tr, 1.0),
        f"{prefix}_stereo_over1px": _share_over(st, 1.0),
        f"{prefix}_features_short": _short(e["features"], max_cnt),
        f"{prefix}_stereo_short": _short(e["matched"], max_cnt),
    }


def readings(truth, scene, evt_packets, img_packets, stamps, P, P_loop,
             max_cnt, max_cnt_img=None):
    """Every reading of a run, and the counts behind them.  max_cnt,
    max_cnt_img: the features per packet the configuration states."""
    out, counts = {}, {}
    e = packet_errors(evt_packets, truth, scene, scene["fx"], scene["fy"])
    out.update(front_end("evt", e, max_cnt))
    counts["evt_track"], counts["evt_stereo"] = len(e["track"]), len(e["stereo"])
    if img_packets is not None:
        e = packet_errors(img_packets, truth, scene, scene["img_fx"],
                          scene["img_fy"])
        out.update(front_end("img", e, max_cnt_img or max_cnt))
        counts["img_track"], counts["img_stereo"] = len(e["track"]), len(e["stereo"])
    _, gt = truth.pose(stamps) if len(stamps) else (None, np.zeros((0, 3)))
    out["ate_m"] = yaw_aligned_rmse(P, gt)
    out["ate_frozen_m"] = yaw_aligned_rmse(np.zeros_like(gt), gt)
    counts["poses"] = len(stamps)
    if P_loop is not None:
        out["loop_ate_m"] = yaw_aligned_rmse(P_loop, gt)
    return out, counts
