"""Two-view relative pose from normalized correspondences — batched RANSAC
(port of esvio_tpu/init/relative_pose.py: solveRelativeRT and
solveRelativeHybrid, solve_5pts.cpp:211-302, and the rotation-only solve of
the hand-eye calibration, initial_ex_rotation.cpp:82-114).

Hypotheses are a leading batch axis: weighted 8-point essential estimates
scored by Sampson inliers, the best re-fitted with an annealed threshold;
the rotation comes from the essential matrix, the metric translation from
a depth-anchored Gauss-Newton, then a small joint (R, t) refinement.
"""
from __future__ import annotations

import torch

from esvio_tpu_torch.core import lie, prng
from esvio_tpu_torch.solver.factors import jacobian_fwd


def _eight_point(p1, p2, w):
    """Weighted 8-point essential estimate; w (..., N) → E (..., 3, 3)
    projected onto the essential manifold."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one],
                    dim=-1) * w[..., None]
    E = torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]
    E = E.reshape(E.shape[:-1] + (3, 3))
    U, S, Vt2 = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2
    D = torch.stack([s, s, torch.zeros_like(s)], -1)
    return (U * D[..., None, :]) @ Vt2


def sampson_dist(E, p1, p2):
    """First-order geometric (Sampson) distance; E (..., 3, 3) → (..., N)."""
    h1 = torch.cat([p1, torch.ones_like(p1[:, :1])], -1)
    h2 = torch.cat([p2, torch.ones_like(p2[:, :1])], -1)
    Ex1 = torch.einsum("nj,...ij->...ni", h1, E)
    Etx2 = torch.einsum("nj,...ji->...ni", h2, E)
    num = torch.sum(h2 * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def triangulate_pair(R, t, p1, p2):
    """DLT triangulation in frame 1 (cam1 = [I|0], cam2 = [R|t]); R (..., 3,
    3), t (..., 3), p1/p2 (N, 2) → (..., N, 3)."""
    dt, dev = R.dtype, R.device
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev),
                    torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    P2 = torch.cat([R, t[..., None]], -1)                    # (..., 3, 4)
    lead = R.shape[:-2]
    a = p1.reshape((1,) * len(lead) + p1.shape)
    b = p2.reshape((1,) * len(lead) + p2.shape)
    P2e = P2[..., None, :, :]
    A = torch.stack([
        (a[..., 0:1] * P1[2] - P1[0]).expand(lead + (p1.shape[0], 4)),
        (a[..., 1:2] * P1[2] - P1[1]).expand(lead + (p1.shape[0], 4)),
        b[..., 0:1] * P2e[..., 2, :] - P2e[..., 0, :],
        b[..., 1:2] * P2e[..., 2, :] - P2e[..., 1, :],
    ], dim=-2)                                               # (..., N, 4, 4)
    v = torch.linalg.svd(A).Vh[..., -1, :]
    w = v[..., 3:4]
    return v[..., :3] / torch.where(torch.abs(w) > 1e-12, w,
                                    torch.full_like(w, 1e-12))


def _cheirality_count(R, t, p1, p2, valid):
    """# of valid points in front of both cameras and nearer than 50."""
    X = triangulate_pair(R, t, p1, p2)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    ok = (z1 > 0) & (z1 < 50.0) & (z2 > 0) & (z2 < 50.0) & valid
    return torch.sum(ok, -1), X


def decompose_essential(E):
    """E → (R1, R2, t): the candidate poses are (R1, ±t), (R2, ±t)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2]


def recover_pose(E, p1, p2, valid):
    """(R, t, n_good): the decomposition with max cheirality support
    (R, t map frame-1 → frame-2)."""
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    counts, _ = _cheirality_count(cands_R, cands_t, p1, p2, valid)
    best = torch.argmax(counts)
    return cands_R[best], cands_t[best], counts[best]


def draw_hypotheses(key, valid, num_hypotheses: int = 256):
    """(K, 8) indices into the valid-first order, as the JAX version draws."""
    n_valid = torch.clamp(torch.sum(valid), min=8)
    return prng.randint(key, (num_hypotheses, 8), 0, n_valid)


def essential_ransac(key, p1, p2, valid, threshold: float = 0.3 / 460.0,
                     num_hypotheses: int = 256, draws=None):
    """Batched 8-point RANSAC with an annealed refit (16×→4×→1× threshold).
    Returns (E, inlier_mask)."""
    N = p1.shape[0]
    dtype = p1.dtype
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices
    if draws is None:
        draws = draw_hypotheses(key, valid, num_hypotheses)
    sample_idx = order[draws]                                  # (K, 8)
    thr2 = threshold * threshold
    K = sample_idx.shape[0]
    w = torch.zeros((K, N), dtype=dtype, device=p1.device)
    w[torch.arange(K, device=p1.device)[:, None], sample_idx] = 1.0
    w = w * valid.to(dtype)
    inls = (sampson_dist(_eight_point(p1, p2, w), p1, p2) < thr2) & valid
    best = torch.argmax(torch.sum(inls, -1))
    inl = inls[best]
    E = _eight_point(p1, p2, inl.to(dtype))
    for mult in (16.0, 4.0, 1.0):
        inl = (sampson_dist(E, p1, p2) < thr2 * mult) & valid
        E = _eight_point(p1, p2, inl.to(dtype))
    return E, (sampson_dist(E, p1, p2) < thr2) & valid


def solve_relative_rt(key, p1, p2, valid, min_inliers: int = 12):
    """MotionEstimator::solveRelativeRT (solve_5pts.cpp:211-245): returns
    (ok, R12, t_1←2, n_good), R and t mapping frame-2 points into frame 1
    (the inverse of the recovered [R|t]); ok needs more than min_inliers
    cheirality-consistent points (:227)."""
    E, inliers = essential_ransac(key, p1, p2, valid)
    R, t, n_good = recover_pose(E, p1, p2, inliers)
    return n_good > min_inliers, R.T, -(R.T @ t), n_good


def solve_relative_rotation(key, p1, p2, valid, min_inliers: int = 9):
    """Rotation-only relative pose of consecutive frames (InitialEXRotation::
    solveRelativeR): of the essential matrix's twins, the one with the
    smaller angle (the larger trace; the other differs by ~180° about t).
    Returns (ok, R12), R12 mapping frame-2 points into frame 1."""
    E, inl = essential_ransac(key, p1, p2, valid)
    R1, R2, _ = decompose_essential(E)
    R = torch.where(torch.trace(R1) >= torch.trace(R2), R1, R2)
    return torch.sum(inl) >= min_inliers, R.T


def _translate_gn(R, p1, p2, depth1, w, iters: int = 10):
    """Translation-only GN with fixed R (TranslateFactor, solve_opt.cpp:
    20-72): landmark i at depth1[i] along ray p1, reprojected against p2."""
    dtype, dev = p1.dtype, p1.device
    X1 = torch.cat([p1, torch.ones_like(p1[:, :1])], -1) * depth1[:, None]
    eye = torch.eye(3, dtype=dtype, device=dev)

    def r_of(t):
        X2 = X1 @ R.T + t[..., None, :]
        z = torch.where(torch.abs(X2[..., 2]) > 1e-6, X2[..., 2],
                        torch.full_like(X2[..., 2], 1e-6))
        return ((X2[..., :2] / z[..., None] - p2) * w[:, None]).flatten(-2)

    t = torch.zeros(3, dtype=dtype, device=dev)
    for _ in range(iters):
        r, J = jacobian_fwd(lambda d: r_of(t + d), (), (), 3, dtype, dev)
        H = J.T @ J + 1e-8 * eye
        t = t - torch.linalg.solve(H, J.T @ r)
    return t


def _pose_refine(R, t, p1, p2, depth1, w, iters: int = 5):
    """Small 3D-2D BA on (R, t) with landmarks fixed at their stereo depths
    (OptSolver::solveCeres, solve_opt.cpp:74-136)."""
    dtype, dev = p1.dtype, p1.device
    X1 = torch.cat([p1, torch.ones_like(p1[:, :1])], -1) * depth1[:, None]
    eye = torch.eye(6, dtype=dtype, device=dev)

    def r_of(d, R, t):
        Rn = lie.so3_exp(d[..., :3]) @ R
        X2 = X1 @ Rn.transpose(-1, -2) + (t + d[..., 3:])[..., None, :]
        z = torch.where(torch.abs(X2[..., 2]) > 1e-6, X2[..., 2],
                        torch.full_like(X2[..., 2], 1e-6))
        return ((X2[..., :2] / z[..., None] - p2) * w[:, None]).flatten(-2)

    for _ in range(iters):
        r, J = jacobian_fwd(lambda d: r_of(d, R, t), (), (), 6, dtype, dev)
        H = J.T @ J + 1e-8 * eye
        d = -torch.linalg.solve(H, J.T @ r)
        R, t = lie.so3_exp(d[:3]) @ R, t + d[3:]
    return R, t


def solve_relative_hybrid(key, p1, p2, depth1, valid, min_inliers: int = 12,
                          draws=None):
    """MotionEstimator::solveRelativeHybrid: returns (ok, R12, t_1←2, n_good)
    with R12, t12 mapping frame-2 points into frame 1."""
    E, inliers = essential_ransac(key, p1, p2, valid, draws=draws)
    R, t, n_good = recover_pose(E, p1, p2, inliers)
    has_depth = inliers & (depth1 > 0)
    w = has_depth.to(p1.dtype)
    n_depth = torch.sum(has_depth)
    t_metric = _translate_gn(R, p1, p2, depth1, w)
    R_ref, t_ref = _pose_refine(R, t_metric, p1, p2, depth1, w)
    use = n_depth >= 6
    R_out = torch.where(use, R_ref, R)
    t_out = torch.where(use, t_ref, t)
    ok = (n_good > min_inliers) & use
    return ok, R_out.T, -(R_out.T @ t_out), n_good
