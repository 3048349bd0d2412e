"""FAST-9/16 corner detection as dense shifted-plane arithmetic (port of
esvio_tpu/loop/fast.py; cv::FAST in KeyFrame::computeBRIEFPoint,
keyframe.cpp:133-161, threshold 20).

The 16 Bresenham-circle samples are 16 rolled copies of the image (rolled
with wrap-around, as `jnp.roll`); a corner needs 9 contiguous brighter or
darker samples, and its score is the largest over valid arcs of the arc's
smallest |difference|.  Everything is exact float arithmetic (differences,
minimums, maximums), so the scores equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# FAST-16 circle offsets (dx, dy), standard Bresenham r=3 ordering
_CIRCLE = np.array(
    [[0, -3], [1, -3], [2, -2], [3, -1], [3, 0], [3, 1], [2, 2], [1, 3],
     [0, 3], [-1, 3], [-2, 2], [-3, 1], [-3, 0], [-3, -1], [-2, -2], [-1, -3]],
    dtype=np.int64,
)
_ARC = 9
# sample index of the k-th position of the arc starting at i: (16, 9)
_ARCS = (np.arange(16)[:, None] + np.arange(_ARC)[None, :]) % 16


def fast_score(img, threshold: int = 20):
    """(H, W) FAST-9 corner score map (0 where not a corner)."""
    planes = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                          for dx, dy in _CIRCLE])                  # (16, H, W)
    diff = planes - img[None]
    arcs = torch.as_tensor(_ARCS, device=img.device)

    def run_scores(mask, mag):
        # arc i is valid when all 9 of its samples pass; its score is the
        # smallest magnitude among them
        ok = mask[arcs].all(dim=1)                                 # (16, H, W)
        m = mag[arcs].amin(dim=1)
        return torch.where(ok, m, torch.zeros_like(m)).amax(dim=0)

    score = torch.maximum(run_scores(diff > threshold, diff),
                          run_scores(diff < -threshold, -diff))
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return torch.where(inside, score, torch.zeros_like(score))


def detect_fast(img, threshold: int = 20, max_corners: int = 512):
    """Top-K FAST corners with 3×3 non-maximum suppression.  Ties go to the
    lower flat index, as `jax.lax.top_k` breaks them.  Returns
    (xy (K, 2) in img's dtype, score (K,), valid (K,) bool)."""
    score = fast_score(img, threshold)
    # 3×3 max with -inf "SAME" padding (max_pool2d pads with -inf)
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    is_max = (score >= neigh) & (score > 0)
    flat = torch.where(is_max, score, torch.zeros_like(score)).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    W = img.shape[1]
    xy = torch.stack([(idx % W).to(img.dtype), (idx // W).to(img.dtype)], dim=-1)
    return xy, vals, vals > 0
