"""BRIEF-256 descriptors and Hamming matching (port of
esvio_tpu/loop/brief.py; DVision::BRIEF and the Hamming searches of
KeyFrame, keyframe.cpp:116-161, searchInAera :183-234, threshold 80).

The test-pair pattern comes from a fixed seed (the same numpy draws as the
JAX package, so both describe a keypoint with the same bits).
Descriptors are ±1 int8 vectors, so a keyframe-against-keyframe match is
one float32 matmul: hamming = (256 − A·Bᵀ) / 2, exact for integers ≤ 256.
"""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.frontend.pyramid import _sep_conv2d

BRIEF_BITS = 256
PATCH = 24  # half-size of the sampling window

_rng = np.random.default_rng(42)
# gaussian test-pair pattern (σ = PATCH/2, clipped), like BRIEF-GIII
_PAT_A = np.clip(_rng.normal(0, PATCH / 2, (BRIEF_BITS, 2)), -PATCH, PATCH - 1)
_PAT_B = np.clip(_rng.normal(0, PATCH / 2, (BRIEF_BITS, 2)), -PATCH, PATCH - 1)
PATTERN_A = _PAT_A.astype(np.float32)
PATTERN_B = _PAT_B.astype(np.float32)
_BOX5 = np.ones((5,)) / 5.0


def smooth(img):
    """5-tap box blur with edge padding, rows first then columns (the JAX
    version's order of its two `jnp.convolve` passes): the smoothing BRIEF
    samples from."""
    return _sep_conv2d(img.T, _BOX5, _BOX5).T


def _fma(x, y, z):
    """x·y + z rounded once to float32 (the float32 product is exact in
    float64)."""
    return (x.double() * y.double() + z.double()).to(x.dtype)


def _bilinear(img, ys, xs):
    """Bilinear samples, rounded as the JAX version's fused CPU code rounds
    them: its compiler contracts three of the four products into the sum
    as fused multiply-adds.  The rounding matters: in flat image regions
    the two samples of a test are equal in exact arithmetic, and rounding
    alone decides the bit."""
    H, W = img.shape
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    gx, gy = 1 - fx, 1 - fy
    s = _fma(img[y0, x0] * gy, gx, img[y0, x0 + 1] * gy * fx)
    s = _fma(img[y0 + 1, x0] * fy, gx, s)
    return _fma(img[y0 + 1, x0 + 1] * fy, fx, s)


def describe_smoothed(sm, xy, valid):
    """BRIEF descriptors at keypoints xy (N, 2) of an image already passed
    through `smooth`: (N, 256) int8 in {−1, +1}, invalid rows all +1."""
    dev = sm.device
    pa = torch.as_tensor(PATTERN_A, device=dev)
    pb = torch.as_tensor(PATTERN_B, device=dev)
    va = _bilinear(sm, xy[:, None, 1] + pa[None, :, 1], xy[:, None, 0] + pa[None, :, 0])
    vb = _bilinear(sm, xy[:, None, 1] + pb[None, :, 1], xy[:, None, 0] + pb[None, :, 0])
    bits = torch.where(va < vb, 1, -1).to(torch.int8)
    return torch.where(valid[:, None], bits, torch.ones_like(bits))


def describe(img, xy, valid):
    """BRIEF descriptors of an (H, W) grayscale image at keypoints xy."""
    return describe_smoothed(smooth(img.to(torch.float32)), xy, valid)


def hamming_matrix(desc_a, desc_b):
    """(Na, Nb) Hamming distances via one matmul."""
    dot = desc_a.to(torch.float32) @ desc_b.to(torch.float32).T
    return 0.5 * (BRIEF_BITS - dot)


def match(desc_a, valid_a, desc_b, valid_b, max_dist: int = 80):
    """Best-match indices a→b under the Hamming gate (searchInAera
    semantics: nearest neighbour, distance < max_dist; the first of equal
    minimums).  Returns (idx (Na,), ok (Na,))."""
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_b[None, :], d, torch.full_like(d, float("inf")))
    idx = torch.argmin(d, dim=1)
    return idx, valid_a & (torch.amin(d, dim=1) < max_dist)
