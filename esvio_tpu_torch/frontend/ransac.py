"""Batched fundamental-matrix RANSAC, 8-point (port of
esvio_tpu/frontend/ransac.py) — replaces cv::findFundamentalMat.

All K hypotheses are evaluated at once as a leading batch axis: random
8-tuples → Householder null vectors → rank-2 projection → symmetric
epipolar distance scoring.  The 8-tuples are drawn exactly as the JAX
version draws them (core/prng.py), or passed in as `draws`.
"""
from __future__ import annotations

import math

import torch

from esvio_tpu_torch.core import prng

FOCAL_VIRTUAL = 460.0  # FOCAL_LENGTH in feature_tracker parameters.cpp


def _normalize_pts(pts, valid):
    """Hartley normalization over valid points: centroid, scale √2."""
    n = torch.clamp(torch.sum(valid), min=1)
    zero = torch.zeros_like(pts)
    mean = torch.sum(torch.where(valid[:, None], pts, zero), dim=0) / n
    d = torch.linalg.vector_norm(pts - mean, dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(
        torch.sum(torch.where(valid, d, torch.zeros_like(d))) / n, min=1e-9)
    T = torch.zeros((3, 3), dtype=pts.dtype, device=pts.device)
    T[0, 0] = scale
    T[1, 1] = scale
    T[0, 2] = -scale * mean[0]
    T[1, 2] = -scale * mean[1]
    T[2, 2] = 1.0
    return (pts - mean) * scale, T


def _householder_null(A):
    """Right null vector of each A (K, 8, 9) via Householder QR of Aᵀ."""
    dt, dev = A.dtype, A.device
    M = A.transpose(1, 2)                               # (K, 9, 8)
    idx = torch.arange(9, device=dev)
    vs = []
    for k in range(8):
        x = M[:, :, k]
        tail = (idx >= k).to(dt)
        xt = x * tail
        nrm = torch.sqrt(torch.sum(xt * xt, -1) + 1e-30)
        xk = x[:, k]
        alpha = -torch.sign(torch.where(xk == 0, torch.ones_like(xk), xk)) * nrm
        v = xt - alpha[:, None] * (idx == k).to(dt)
        vtv = torch.sum(v * v, -1) + 1e-30
        vM = torch.einsum("ki,kij->kj", v, M)
        M = M - (2.0 / vtv)[:, None, None] * (v[:, :, None] * vM[:, None, :])
        vs.append((v, vtv))
    q = (idx == 8).to(dt).expand(A.shape[0], 9)
    for v, vtv in reversed(vs):
        q = q - (2.0 * torch.sum(v * q, -1) / vtv)[:, None] * v
    return q


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _adj3(M):
    """Adjugate of (K, 3, 3) (∝ M⁻¹ without the determinant division)."""
    return torch.stack([_cross3(M[:, 1], M[:, 2]),
                        _cross3(M[:, 2], M[:, 0]),
                        _cross3(M[:, 0], M[:, 1])], dim=2)


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-30)


def _smallest_singular_vec(G, rows):
    """Unit eigenvector of the smallest eigenvalue of each PSD 3×3 G,
    seeded by the largest cross product of `rows` and refined by adjugate
    (inverse-power) iterations plus one Rayleigh-shifted step."""
    cs = torch.stack([_cross3(rows[:, 0], rows[:, 1]),
                      _cross3(rows[:, 0], rows[:, 2]),
                      _cross3(rows[:, 1], rows[:, 2])], dim=1)   # (K, 3, 3)
    norms = torch.sum(cs * cs, -1)
    best = torch.argmax(norms, dim=1)
    v = _unit(cs[torch.arange(cs.shape[0], device=cs.device), best])
    adj = _adj3(G)
    for _ in range(2):
        v = _unit(torch.einsum("kij,kj->ki", adj, v))
    mu = torch.einsum("ki,kij,kj->k", v, G, v)
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    v = _unit(torch.einsum("kij,kj->ki", _adj3(G - mu[:, None, None] * eye), v))
    return v


def _eight_point(p1, p2):
    """F of each hypothesis from 8 correspondences p1/p2 (K, 8, 2)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    F = _householder_null(A).reshape(-1, 3, 3)
    Ft = F.transpose(1, 2)
    v3 = _smallest_singular_vec(Ft @ F, F)
    u3 = _smallest_singular_vec(F @ Ft, Ft)
    s3 = torch.einsum("ki,kij,kj->k", u3, F, v3)
    return F - s3[:, None, None] * (u3[:, :, None] * v3[:, None, :])


def _epipolar_dist2(F, p1, p2):
    """Symmetric squared point-line distance of (N, 2) points under each
    F (K, 3, 3) → (K, N) (OpenCV FM_RANSAC error)."""
    ones = torch.ones_like(p1[:, :1])
    h1 = torch.cat([p1, ones], -1)
    h2 = torch.cat([p2, ones], -1)
    l2 = torch.einsum("nj,kij->kni", h1, F)       # h1 @ Fᵀ
    l1 = torch.einsum("nj,kji->kni", h2, F)       # h2 @ F
    num = torch.sum(h2[None] * l2, -1) ** 2
    d2 = num / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = num / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return torch.maximum(d1, d2)


def draw_hypotheses(key, valid, num_hypotheses: int):
    """(K, 8) indices into the valid-first order, as the JAX version draws
    them: randint over [0, max(n_valid, 8))."""
    n_valid = torch.sum(valid)
    return prng.randint(key, (num_hypotheses, 8), 0,
                        torch.clamp(n_valid, min=8))


def fundamental_ransac(key, pts1, pts2, valid, threshold: float = 1.0,
                       num_hypotheses: int = 256, draws=None):
    """RANSAC inlier mask for correspondences pts1 ↔ pts2 (N, 2).

    draws: optional (K, 8) hypothesis draws (as from `draw_hypotheses`);
    by default drawn from `key`.  Returns (inliers (N,) bool, best_F (3,3))."""
    n1, T1 = _normalize_pts(pts1, valid)
    n2, T2 = _normalize_pts(pts2, valid)
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices
    if draws is None:
        draws = draw_hypotheses(key, valid, num_hypotheses)
    sample_idx = order[draws]                                 # (K, 8)
    Fs = _eight_point(n1[sample_idx], n2[sample_idx])         # (K, 3, 3)
    F_px = T2.T[None] @ Fs @ T1[None]
    d2_px = _epipolar_dist2(F_px, pts1, pts2)
    inl = (d2_px < threshold * threshold) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return inl[best], F_px[best]
