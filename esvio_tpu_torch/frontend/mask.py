"""Feature spacing (port of esvio_tpu/frontend/mask.py).

`greedy_spacing` is the reference's occupancy mask (Event_setMask /
setMask, feature_tracker.cpp:88-151): candidates in priority order each
take their spot when it is still free and paint a filled disc of radius
min_dist.  `grid_spacing`, the trackers' default, is its parallel form:
bucket the frame into min_dist-sized cells, keep one winner per cell (the
highest priority), then iterate winner-take-all suppression among the
8-cell neighbourhood to a fixed point (≤ suppress_iters sweeps), and cap
the survivors at max_keep by priority.
"""
from __future__ import annotations

import torch

from esvio_tpu_torch.utils.metrics import count, to_host


def _disc_offsets(radius: int, row: int, device):
    """Flat offsets, in a grid of row length `row`, of the filled disc's
    cells from its bounding box's top-left corner."""
    r = torch.arange(-radius, radius + 1, device=device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    inside = (yy * yy + xx * xx) <= radius * radius
    return ((yy + radius) * row + (xx + radius))[inside]


def greedy_spacing(priority, xs, ys, valid, height: int, width: int,
                   min_dist: int, max_keep: int, occupied=None):
    """Greedy min-dist selection.

    Args:
      priority: (N,) float — larger = selected first (the reference sorts
        by track count, feature_tracker.cpp:96-99); ties go by index.
      xs, ys: (N,) float pixel positions.
      valid: (N,) bool.
      occupied: optional (H, W) bool initial occupancy (True = blocked).

    Returns:
      (keep (N,) bool, occupied_out (H, W) bool) — keep ⊆ valid, at most
      max_keep features, each at least min_dist from any previously kept.

    The scan is sequential: candidate k reads the grid that candidates
    < k painted.  Each step is a few device operations on indices computed
    before the loop (the disc's cells as flat offsets from the candidate's
    pixel), so the loop makes no host read.
    """
    N = priority.shape[0]
    dev = priority.device
    r = min_dist
    row = width + 2 * r
    grid = torch.zeros((height + 2 * r) * row, dtype=torch.int32, device=dev)
    if occupied is not None:
        grid.view(height + 2 * r, row)[r:r + height, r:r + width] = \
            occupied.to(torch.int32)

    inf = torch.full_like(priority, float("inf"))
    order = torch.sort(torch.where(valid, -priority, inf), stable=True).indices
    xi = torch.clamp(torch.round(xs).to(torch.int64), 0, width - 1)[order]
    yi = torch.clamp(torch.round(ys).to(torch.int64), 0, height - 1)[order]
    corner = yi * row + xi                        # the disc box's top-left
    centre = (corner + r * row + r)[:, None]      # (N, 1)
    cells = corner[:, None] + _disc_offsets(r, row, dev)[None]   # (N, D)
    valid_o = valid[order][:, None]
    keep_o = torch.zeros((N, 1), dtype=torch.bool, device=dev)
    budget = torch.full((1,), max_keep, dtype=torch.int32, device=dev)
    for k in range(N):
        take = (grid[centre[k]] == 0) & valid_o[k] & (budget > 0)
        t32 = take.to(torch.int32)
        grid.index_add_(0, cells[k], t32.expand(cells.shape[1]))
        keep_o[k] = take
        budget -= t32
    keep = torch.empty(N, dtype=torch.bool, device=dev)
    keep[order] = keep_o[:, 0]
    occ = grid.view(height + 2 * r, row)[r:r + height, r:r + width] > 0
    return keep, occ


def grid_spacing(priority, xs, ys, valid, height: int, width: int,
                 min_dist: int, max_keep: int, suppress_iters: int = 16):
    """Returns (keep (N,) bool, occupied (H, W) bool); see the JAX
    docstring for the guarantees and the known deviations from the
    sequential greedy mask."""
    N = priority.shape[0]
    dev = priority.device
    r = max(min_dist, 1)
    ncx = -(-width // r)
    ncy = -(-height // r)
    ncell = ncx * ncy

    xi = torch.clamp(xs, 0.0, width - 1.0)
    yi = torch.clamp(ys, 0.0, height - 1.0)
    cx = torch.clamp(torch.div(xi, r, rounding_mode="floor").to(torch.int64),
                     0, ncx - 1)
    cy = torch.clamp(torch.div(yi, r, rounding_mode="floor").to(torch.int64),
                     0, ncy - 1)
    cell = cy * ncx + cx

    iota = torch.arange(N, dtype=torch.int64, device=dev)
    inf = torch.full_like(priority, float("inf"))
    order = torch.sort(torch.where(valid, -priority, inf), stable=True).indices
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[order] = iota
    rank = torch.where(valid, rank, torch.full_like(rank, N))

    cell_best = torch.full((ncell,), N, dtype=torch.int64, device=dev)
    cell_best.scatter_reduce_(0, cell, rank, "amin")
    is_winner = valid & (rank == cell_best[cell])
    win_of_cell = torch.full((ncell,), -1, dtype=torch.int64, device=dev)
    win_of_cell.scatter_reduce_(
        0, cell, torch.where(is_winner, iota, torch.full_like(iota, -1)), "amax")

    r2 = float(r * r)
    neighbours = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nx = cx + dx
            ny = cy + dy
            inb = (nx >= 0) & (nx < ncx) & (ny >= 0) & (ny < ncy)
            j = win_of_cell[torch.clamp(ny, 0, ncy - 1) * ncx
                            + torch.clamp(nx, 0, ncx - 1)]
            jc = torch.clamp(j, 0, N - 1)
            d2 = (xi - xi[jc]) ** 2 + (yi - yi[jc]) ** 2
            static_ok = inb & (j >= 0) & (j != iota) & (d2 < r2) \
                & (rank[jc] < rank)
            neighbours.append((jc, static_ok))

    def sweep(live):
        kill = torch.zeros(N, dtype=torch.bool, device=dev)
        for jc, static_ok in neighbours:
            kill = kill | (static_ok & live[jc])
        return is_winner & ~kill

    # Jacobi iteration of priority-ordered suppression to a fixed point,
    # checked on the host (a counted fetch) after each sweep
    prev = is_winner
    live = sweep(is_winner)
    n_sweeps = 1
    for _ in range(1, suppress_iters):
        if to_host(torch.all(live == prev)):
            break
        prev, live = live, sweep(live)
        n_sweeps += 1
    count("spacing_sweeps", n_sweeps)

    live_s = live[order]
    live_rank = torch.cumsum(live_s.to(torch.int64), 0) - 1
    keep_sorted = live_s & (live_rank < max_keep)
    keep = torch.empty(N, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted

    occ = torch.zeros(height * width, dtype=torch.int32, device=dev)
    flat = torch.round(yi).to(torch.int64) * width + torch.round(xi).to(torch.int64)
    occ.scatter_reduce_(0, flat, keep.to(torch.int32), "amax")
    return keep, occ.reshape(height, width).bool()
