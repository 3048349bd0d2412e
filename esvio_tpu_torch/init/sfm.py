"""Global up-to-scale structure-from-motion over the sliding window (port
of esvio_tpu/init/sfm.py; GlobalSFM::construct, initial_sfm.cpp:204+,
solveFrameByPnP :23, triangulateTwoFrames :75) for the monocular
initialization fallback (estimator.cpp initialStructure :415-558).

The frame-chaining control flow stays on the host (it runs once, at
init), with the two-view triangulation in numpy float64; the relative
pose, the PnP chain and the full-window bundle adjustment run on the key's
device.  Data layout: obs (L, F, 2) normalized observations, mask (L, F)
validity, the estimator's stacked feature-book format.
"""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.init import pnp, relative_pose
from esvio_tpu_torch.solver.factors import jacobian_fwd


def _triangulate_two(Ri, ti, Rj, tj, pi, pj):
    """DLT with generic projections Pi=[Ri|ti], Pj=[Rj|tj] (world→cam)."""
    Pi_ = np.concatenate([Ri, ti[:, None]], axis=1)
    Pj_ = np.concatenate([Rj, tj[:, None]], axis=1)
    A = np.stack([
        pi[0] * Pi_[2] - Pi_[0],
        pi[1] * Pi_[2] - Pi_[1],
        pj[0] * Pj_[2] - Pj_[0],
        pj[1] * Pj_[2] - Pj_[1],
    ])
    v = np.linalg.svd(A)[2][-1]
    if abs(v[3]) < 1e-12:
        return None
    return v[:3] / v[3]


def find_frame_l(key, obs, mask, min_corr: int = 20,
                 parallax_px: float = 30.0, focal: float = 460.0):
    """relativePose scan (estimator.cpp:1365-1399): the first frame i with
    more than min_corr correspondences to the newest frame, average
    parallax·focal above parallax_px, and a successful solveRelativeRT
    (on the key's device, in obs's precision).

    Returns (l, R, t) with R, t the reference convention (frame-newest →
    frame-l) as numpy, or (None, None, None)."""
    L, F, _ = obs.shape
    newest = F - 1
    dt = torch.float64 if obs.dtype == np.float64 else torch.float32
    as_t = lambda a, d=dt: torch.as_tensor(np.asarray(a), dtype=d,
                                           device=key.device)
    for i in range(F - 1):
        corr = mask[:, i] & mask[:, newest]
        n = int(corr.sum())
        if n <= min_corr:
            continue
        d = obs[:, i] - obs[:, newest]
        par = np.where(corr, np.linalg.norm(d, axis=-1), 0.0)
        if par.sum() / max(n, 1) * focal <= parallax_px:
            continue
        ok, R, t, _ = relative_pose.solve_relative_rt(
            key, as_t(obs[:, i]), as_t(obs[:, newest]), as_t(corr, torch.bool))
        if bool(ok):
            return i, R.cpu().numpy(), t.cpu().numpy()
    return None, None, None


def _bundle_adjust(R0, t0, pts0, obs, mask, fix_pose, fix_trans,
                   iters: int = 10):
    """Full-window masked GN bundle adjustment (the Ceres BA of
    initial_sfm.cpp:262-293), a fixed iteration count with no host read.
    Gauge: the rotation of frame l frozen by fix_pose, the translations of
    frames l and newest by fix_trans (scale + origin lock, :270-276).

    R0 (F, 3, 3) world→cam, t0 (F, 3), pts0 (L, 3) world, obs (L, F, 2),
    mask (L, F) float.  Returns (R, t, pts, rms)."""
    F = R0.shape[0]
    L = pts0.shape[0]
    dtype, dev = t0.dtype, t0.device
    n = 6 * F + 3 * L
    free_pose = (~fix_pose).to(dtype)[:, None]
    free_trans = (~fix_trans).to(dtype)[:, None]
    eye = torch.eye(n, dtype=dtype, device=dev)

    def residual(R, t, X, obs, mask):
        Xc = torch.einsum("...fij,...lj->...lfi", R, X) + t[..., None, :, :]
        z = Xc[..., 2]
        z = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
        return (Xc[..., :2] / z[..., None] - obs) * mask[..., None]

    def unpack(d):
        lead = d.shape[:-1]
        dw = d[..., :3 * F].reshape(lead + (F, 3)) * free_pose
        dt_ = d[..., 3 * F:6 * F].reshape(lead + (F, 3)) * free_trans
        return dw, dt_, d[..., 6 * F:].reshape(lead + (L, 3))

    def r_of(d, R, t, X, obs, mask):
        dw, dt_, dX = unpack(d)
        return residual(lie.so3_exp(dw) @ R, t + dt_, X + dX, obs,
                        mask).flatten(-3)

    R, t, X = R0, t0, pts0
    for _ in range(iters):
        r, J = jacobian_fwd(r_of, (R, t, X, obs, mask), (), n, dtype, dev)
        d = -torch.linalg.solve_ex(J.T @ J + 1e-6 * eye, J.T @ r)[0]
        dw, dt_, dX = unpack(d)
        R, t, X = lie.so3_exp(dw) @ R, t + dt_, X + dX
    r = residual(R, t, X, obs, mask)
    nobs = torch.clamp(torch.sum(mask), min=1.0)
    return R, t, X, torch.sqrt(torch.sum(r ** 2) / nobs)


def construct(key, obs, mask, l, R_rel, t_rel, focal: float = 460.0):
    """GlobalSFM::construct (initial_sfm.cpp:204-300).

    obs (L, F, 2) numpy normalized observations, mask (L, F) bool, l the
    anchor frame, (R_rel, t_rel) the relative pose in the reference's
    solveRelativeRT convention (newest→l).  World frame := camera l.  The
    PnP chain and the bundle adjustment run in float64 on the key's device.

    Returns (ok, R (F,3,3) world→cam, t (F,3), pts (L,3), pt_valid (L,))."""
    L, F, _ = obs.shape
    newest = F - 1
    f64 = lambda a, d=torch.float64: torch.as_tensor(np.asarray(a), dtype=d,
                                                     device=key.device)
    fail = (False, None, None, None, None)

    R = [None] * F
    t = [None] * F
    # pose[l] = I; pose[newest] = inverse of (R_rel, t_rel) (:216-226)
    R[l] = np.eye(3)
    t[l] = np.zeros(3)
    R[newest] = R_rel.T
    t[newest] = -(R_rel.T @ t_rel)

    pts = np.zeros((L, 3))
    ptv = np.zeros(L, bool)

    def tri_frames(i, j):
        both = mask[:, i] & mask[:, j] & ~ptv
        for k in np.nonzero(both)[0]:
            X = _triangulate_two(R[i], t[i], R[j], t[j], obs[k, i], obs[k, j])
            if X is None:
                continue
            zi = R[i][2] @ X + t[i][2]
            zj = R[j][2] @ X + t[j][2]
            if zi <= 0 or zj <= 0:
                continue
            pts[k] = X
            ptv[k] = True

    def solve_pnp(i, R_seed, t_seed):
        """solveFrameByPnP: the pose of frame i from the known 3-D points."""
        sel = mask[:, i] & ptv
        if sel.sum() < 6:
            return None
        # pnp_gn's t is the camera CENTER in world coordinates
        c_seed = -(R_seed.T @ t_seed)
        Rn, cn, err = pnp.pnp_gn(f64(pts), f64(obs[:, i]), f64(sel, torch.bool),
                                 f64(R_seed), f64(c_seed), iters=15)
        if float(err) > 10.0 / focal:
            return None
        Rn = Rn.cpu().numpy()
        return Rn, -(Rn @ cn.cpu().numpy())

    # 1: triangulate l ↔ newest, then chain forward with PnP (:228-244)
    tri_frames(l, newest)
    for i in range(l + 1, newest):
        res = solve_pnp(i, R[i - 1], t[i - 1])
        if res is None:
            return fail
        R[i], t[i] = res
        tri_frames(i, newest)
    # 2: triangulate l ↔ i for the middle frames (:246-249)
    for i in range(l + 1, newest):
        tri_frames(l, i)
    # 3: chain backward from l (:251-260)
    for i in range(l - 1, -1, -1):
        res = solve_pnp(i, R[i + 1], t[i + 1])
        if res is None:
            return fail
        R[i], t[i] = res
        tri_frames(i, l)
    # 4: triangulate what is left between its first and last observation
    # (:262-281)
    for k in np.nonzero(~ptv)[0]:
        frames = np.nonzero(mask[k])[0]
        if len(frames) < 2:
            continue
        i, j = frames[0], frames[-1]
        X = _triangulate_two(R[i], t[i], R[j], t[j], obs[k, i], obs[k, j])
        if X is not None:
            pts[k] = X
            ptv[k] = True

    # 5: full-window BA, gauge fixed at frame l + the newest's translation
    fix_pose = np.zeros(F, bool)
    fix_pose[l] = True
    fix_trans = np.zeros(F, bool)
    fix_trans[l] = True
    fix_trans[newest] = True
    m = (mask & ptv[:, None]).astype(np.float64)
    Rb, tb, Xb, rms = _bundle_adjust(
        f64(np.stack(R)), f64(np.stack(t)), f64(pts), f64(obs), f64(m),
        f64(fix_pose, torch.bool), f64(fix_trans, torch.bool))
    rms = float(rms)
    if not np.isfinite(rms) or rms > 10.0 / focal:
        return fail
    return (True, Rb.cpu().numpy(), tb.cpu().numpy(), Xb.cpu().numpy(), ptv)
