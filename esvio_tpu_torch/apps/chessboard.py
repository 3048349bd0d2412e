"""Chessboard corner detection for the calibration tool (port of
esvio_tpu/apps/chessboard.py).

Instead of the reference's binarize → find-quads → assemble
(camera_model/src/chessboard/Chessboard.cc), the X-shaped saddle points
are detected directly with a correlation bank over a disc, 3×3 non-max
suppression and sub-pixel refinement on `device`, then ordered into the
(rows, cols) grid on the host by projecting onto the two dominant lattice
directions.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _disc_signs(radius: int):
    """The disc of offsets and its two checkerboard sign patterns, rotated
    45° apart (numpy constants)."""
    off = np.arange(-radius, radius + 1)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    disc = ((oy * oy + ox * ox) <= radius * radius) & ((oy != 0) | (ox != 0))
    ang = np.arctan2(oy.astype(np.float64), ox.astype(np.float64))
    s1 = np.where(disc, np.sign(np.cos(2 * ang)), 0.0)
    s2 = np.where(disc, np.sign(np.sin(2 * ang)), 0.0)
    return disc, s1, s2


def _saddle_response(img, radius: int = 4):
    """X-corner response: correlation with two phase-shifted checkerboard
    templates over a disc (the "ChESS"-style detector), max of the two
    polarities, zero at plain edges.  The disc's terms are added one offset
    at a time, in the JAX package's order, so the float32 sums are the
    same."""
    r = radius
    disc, s1, s2 = _disc_signs(r)
    H, W = img.shape
    pad = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    r1 = torch.zeros_like(img)
    r2 = torch.zeros_like(img)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            if not disc[dy, dx]:
                continue
            w = pad[dy:dy + H, dx:dx + W]
            r1 = r1 + w * float(s1[dy, dx])
            r2 = r2 + w * float(s2[dy, dx])
    # a multiply by 1/n, as XLA rewrites the division by a constant
    return torch.maximum(torch.abs(r1), torch.abs(r2)) * (1.0 / float(disc.sum()))


def detect_saddles(img, max_corners: int = 128, radius: int = 4,
                   device="cuda"):
    """(H, W) image → (xy (N, 2), score (N,), valid (N,)) saddle points with
    3×3 non-max suppression and quadratic sub-pixel refinement.  The N
    strongest come first; equal scores keep flat-index order, as
    `jax.lax.top_k` orders them."""
    img = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
    H, W = img.shape
    resp = _saddle_response(img, radius)
    pad = F.pad(resp, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack([pad[dy:dy + H, dx:dx + W]
                         for dy in range(3) for dx in range(3)
                         if not (dy == 1 and dx == 1)])
    is_max = (resp > neigh.amax(0)) & (resp > 0.2 * resp.max())
    flat = torch.where(is_max, resp, torch.zeros_like(resp)).reshape(-1)
    score, idx = torch.sort(flat, descending=True, stable=True)
    score, idx = score[:max_corners], idx[:max_corners]
    yi, xi = idx // W, idx % W
    valid = score > 0.0

    # sub-pixel: 1D quadratic fits along x and y on the response surface
    yc = torch.clamp(yi, 1, H - 2)
    xc = torch.clamp(xi, 1, W - 2)
    c = resp[yc, xc]
    dx = (resp[yc, xc + 1] - resp[yc, xc - 1]) * 0.5
    dxx = resp[yc, xc + 1] + resp[yc, xc - 1] - 2 * c
    dy = (resp[yc + 1, xc] - resp[yc - 1, xc]) * 0.5
    dyy = resp[yc + 1, xc] + resp[yc - 1, xc] - 2 * c
    zero = torch.zeros_like(dx)
    sx = torch.where(torch.abs(dxx) > 1e-9, -dx / dxx, zero)
    sy = torch.where(torch.abs(dyy) > 1e-9, -dy / dyy, zero)
    xs = xi.to(torch.float32) + torch.clamp(sx, -0.5, 0.5)
    ys = yi.to(torch.float32) + torch.clamp(sy, -0.5, 0.5)
    return torch.stack([xs, ys], -1), score, valid


def order_grid(xy, valid, rows: int, cols: int, score=None):
    """Order detected saddles into a (rows·cols, 2) boardrow-major grid.

    Host-side (runs once per calibration view): take the rows·cols strongest
    saddles (true X-corners respond markedly stronger than boundary
    T-junctions), estimate the two lattice directions, project corners onto
    them, and sort by (row, col) rank.  Returns (grid_xy, ok)."""
    valid = np.asarray(valid)
    xy = np.asarray(xy)[valid]
    n = rows * cols
    if len(xy) < n:
        return None, False
    if score is not None:
        sc = np.asarray(score)[valid]
        xy = xy[np.argsort(-sc)[:n]]
    elif len(xy) > n:
        return None, False
    # nearest-neighbor displacement vectors → dominant lattice direction.
    # Neighbors lie along BOTH lattice axes (90° apart): fold angles mod π/2
    # so they vote for one common angle, on the circle (wrap-around safe).
    d2 = np.sum((xy[:, None] - xy[None, :]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    nn = xy[np.argmin(d2, 1)] - xy
    ang4 = 4.0 * np.arctan2(nn[:, 1], nn[:, 0])
    a0 = np.arctan2(np.sin(ang4).mean(), np.cos(ang4).mean()) / 4.0
    u = np.array([np.cos(a0), np.sin(a0)])
    v = np.array([-u[1], u[0]])
    pu = xy @ u
    pv = xy @ v
    # rank rows by v-projection into `rows` clusters, then columns by u
    row_rank = np.argsort(np.argsort(pv)) // cols
    order = np.lexsort((pu, row_rank))
    grid = xy[order]
    # sanity: each row strictly increasing in u
    for r_ in range(rows):
        if not np.all(np.diff(grid[r_ * cols:(r_ + 1) * cols] @ u) > 0):
            return None, False
    return grid, True


def find_chessboard(img, rows: int, cols: int, radius: int = 4,
                    device="cuda"):
    """Chessboard.cc analog: (H, W) image + inner-corner grid size →
    (corners (rows·cols, 2) row-major, found)."""
    xy, score, valid = detect_saddles(
        img, max_corners=2 * rows * cols, radius=radius, device=device)
    return order_grid(xy.cpu().numpy(), valid.cpu().numpy(), rows, cols,
                      score=score.cpu().numpy())
