"""Arc*-style event-corner detection (port of esvio_tpu/events/corners.py).

The greedy arc expansion on the two Bresenham circles (r=3: 16 px, r=4:
20 px) of EventDetector::isCorner (event_detector.cc:308-544) is evaluated
densely at every pixel; per-event classification is then one lookup.

`corner_mask` is the wrapper of kernel K1 (csrc/corner_mask.cu, which
replaces the Pallas kernel esvio_tpu/events/corners_pallas.py:139): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
version `corner_mask_plain`, the rolled-circle formulation of the XLA path
(corners.py:136-159).  Both wrap around at the image border, so they agree
bit for bit everywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch import _kernels
from esvio_tpu_torch.events.sae import EventChunk, SAEState

# circle offsets (dx, dy) — event_detector.cc:14-22
SMALL_CIRCLE = np.array(
    [[0, 3], [1, 3], [2, 2], [3, 1], [3, 0], [3, -1], [2, -2], [1, -3],
     [0, -3], [-1, -3], [-2, -2], [-3, -1], [-3, 0], [-3, 1], [-2, 2], [-1, 3]],
    dtype=np.int32,
)
LARGE_CIRCLE = np.array(
    [[0, 4], [1, 4], [2, 3], [3, 2], [4, 1], [4, 0], [4, -1], [3, -2],
     [2, -3], [1, -4], [0, -4], [-1, -4], [-2, -3], [-3, -2], [-4, -1], [-4, 0],
     [-4, 1], [-3, 2], [-2, 3], [-1, 4]],
    dtype=np.int32,
)

_SMALL_MIN, _SMALL_MAX = 4, 6    # event_detector.cc:329-330
_LARGE_MIN, _LARGE_MAX = 5, 8    # event_detector.cc:331-332


def _take(vals, idx):
    return torch.gather(vals, -1, idx[..., None])[..., 0]


def _newest_segment_size(vals, min_thresh: int):
    """Greedy newest-arc expansion (event_detector.cc:337-426) over the
    last axis of vals (..., N), first maximum as the start."""
    n = vals.shape[-1]
    start = torch.argmax(vals, dim=-1)
    seg_min = torch.amax(vals, dim=-1)
    right = (start + 1) % n
    left = (start - 1 + n) % n
    right_val = _take(vals, right)
    left_val = _take(vals, left)
    right_min = right_val
    left_min = left_val

    def extend(go_right, right, left, right_val, left_val, right_min, left_min):
        new_right = (right + 1) % n
        new_left = (left - 1 + n) % n
        nrv = _take(vals, new_right)
        nlv = _take(vals, new_left)
        return (torch.where(go_right, new_right, right),
                torch.where(go_right, left, new_left),
                torch.where(go_right, nrv, right_val),
                torch.where(go_right, left_val, nlv),
                torch.where(go_right, torch.minimum(right_min, nrv), right_min),
                torch.where(go_right, left_min, torch.minimum(left_min, nlv)))

    for _ in range(1, min_thresh):
        go_right = right_val > left_val
        seg_min = torch.where(go_right, torch.minimum(seg_min, right_min),
                              torch.minimum(seg_min, left_min))
        right, left, right_val, left_val, right_min, left_min = extend(
            go_right, right, left, right_val, left_val, right_min, left_min)

    seg_size = torch.full(vals.shape[:-1], min_thresh, dtype=torch.int64,
                          device=vals.device)
    for i in range(min_thresh, n):
        go_right = right_val > left_val
        ext_val = torch.where(go_right, right_val, left_val)
        ext_min = torch.where(go_right, right_min, left_min)
        grow = ext_val >= seg_min
        seg_size = torch.where(grow, torch.full_like(seg_size, i + 1), seg_size)
        seg_min = torch.where(grow, torch.minimum(seg_min, ext_min), seg_min)
        right, left, right_val, left_val, right_min, left_min = extend(
            go_right, right, left, right_val, left_val, right_min, left_min)
    return seg_size


def _circle_ok(vals, min_thresh: int, max_thresh: int):
    n = vals.shape[-1]
    size = _newest_segment_size(vals, min_thresh)
    return (size <= max_thresh) | ((size >= n - max_thresh)
                                   & (size <= n - min_thresh))


def _rolled_circle(sae, circle):
    """(P, H, W, N): SAE value at each circle offset for every pixel
    (wraps around the border like jnp.roll)."""
    return torch.stack([torch.roll(sae, shifts=(-int(dy), -int(dx)), dims=(1, 2))
                        for dx, dy in circle], dim=-1)


def corner_mask_plain(sae: torch.Tensor) -> torch.Tensor:
    """(P, H, W) float SAE → (P, H, W) bool, rolled-circle formulation."""
    small = _rolled_circle(sae, SMALL_CIRCLE).reshape(-1, 16)
    ok_s = _circle_ok(small, _SMALL_MIN, _SMALL_MAX)
    large = _rolled_circle(sae, LARGE_CIRCLE).reshape(-1, 20)
    ok_l = _circle_ok(large, _LARGE_MIN, _LARGE_MAX)
    return (ok_s & ok_l).reshape(sae.shape)


def corner_mask_cuda(sae: torch.Tensor) -> torch.Tensor:
    """Launch kernel K1 on a CUDA (P, H, W) float32 SAE → (P, H, W) bool."""
    if sae.dtype != torch.float32 or sae.dim() != 3:
        raise ValueError(f"corner_mask_cuda takes (P, H, W) float32, got "
                         f"{tuple(sae.shape)} {sae.dtype}")
    if not sae.is_contiguous():
        raise ValueError("corner_mask_cuda takes a contiguous SAE")
    if not sae.is_cuda:
        raise ValueError("corner_mask_cuda needs a CUDA tensor")
    P, H, W = sae.shape
    out = torch.empty((P, H, W), dtype=torch.bool, device=sae.device)
    err = _kernels.CORNER_MASK.fn()(sae.data_ptr(), out.data_ptr(), P, H, W,
                                    _kernels.stream_ptr(sae.device))
    _kernels.check(err, _kernels.CORNER_MASK)
    _kernels.CORNER_MASK.launches += 1
    return out


def corner_mask(state: SAEState) -> torch.Tensor:
    """(2, H, W) bool — Arc* corner test at every pixel: kernel K1 on the
    card, the plain version on the CPU."""
    if state.sae.is_cuda:
        return corner_mask_cuda(state.sae)
    return corner_mask_plain(state.sae)


def accept_table(state: SAEState) -> torch.Tensor:
    """(2, H, W) bool — corner mask ∧ "the pixel's newest event has
    polarity p" (isCorner's opening rejection, event_detector.cc:315-317)."""
    mask = corner_mask(state)
    lat = state.sae_latest
    newest_is_p = torch.stack([~(lat[1] > lat[0]), ~(lat[0] > lat[1])])
    return mask & newest_is_p


def detect_corners(state: SAEState, chunk: EventChunk, min_dist: int = 10):
    """(E,) bool — event passes the harvest filter, the border check
    (kBorderLimit = min_dist + 1, event_detector.cc:320-324) and both
    circle arc criteria."""
    H, W = state.sae.shape[1:]
    border = min_dist + 1
    x, y = chunk.x.long(), chunk.y.long()
    in_border = (x >= border) & (x < W - border) & (y >= border) & (y < H - border)
    table = accept_table(state).reshape(2, H * W)
    idx = torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1)
    hit = table[(chunk.p == 1).long(), idx]
    return hit & in_border & chunk.valid
