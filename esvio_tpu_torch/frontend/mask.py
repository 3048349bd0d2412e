"""Feature spacing (port of `grid_spacing`, esvio_tpu/frontend/mask.py —
the tracker's default; `greedy_spacing` is not ported yet).

Bucket the frame into min_dist-sized cells, keep one winner per cell (the
highest priority), then iterate winner-take-all suppression among the
8-cell neighbourhood to a fixed point (≤ suppress_iters sweeps), and cap
the survivors at max_keep by priority.
"""
from __future__ import annotations

import torch


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

    # Jacobi iteration of priority-ordered suppression to a fixed point
    prev = is_winner
    live = sweep(is_winner)
    for _ in range(1, suppress_iters):
        if bool(torch.equal(live, prev)):
            break
        prev, live = live, sweep(live)

    live_s = live[order]
    live_rank = torch.cumsum(live_s.to(torch.int64), 0) - 1
    keep_sorted = live_s & (live_rank < max_keep)
    keep = torch.empty(N, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted

    occ = torch.zeros(height * width, dtype=torch.int32, device=dev)
    flat = torch.round(yi).to(torch.int64) * width + torch.round(xi).to(torch.int64)
    occ.scatter_reduce_(0, flat, keep.to(torch.int32), "amax")
    return keep, occ.reshape(height, width).bool()
