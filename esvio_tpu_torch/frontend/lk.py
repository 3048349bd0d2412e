"""Pyramidal Lucas-Kanade optical flow batched over features (port of
esvio_tpu/frontend/lk.py).

Bouguet's algorithm as in cv::calcOpticalFlowPyrLK (feature_tracker.cpp:
185,410,490): template window + Scharr gradients from the previous image,
Gauss-Newton iterations sampling the current image bilinearly, batched over
all features with convergence masking.  A fixed-size patch is cut around
each feature once per level and every bilinear resample inside the GN loop
is two small batched matmuls against separable hat-function weights.

The JAX version stops its GN loop when every lane has converged; a
converged lane never moves again, so stopping there, later, or at each
lane's own convergence gives the same result.  The trackers run a forward
pass and its reverse check as one pair, `lk_track_fb`: on the card kernel
K3 (csrc/lk_track.cu), one launch per pair with no host round trip, each
lane stopping on its own; on the CPU the plain version, two `lk_track`
calls, whose loop checks convergence on the host every iteration (a
counted host fetch).  The per-tick record counts the calls of one level's
loop (`lk_calls`) and the iterations it ran (`lk_iters`, the most of any
lane); K3's are read from the card only while a record is active, once
the stage has closed.
"""
from __future__ import annotations

import ctypes

import torch

from esvio_tpu_torch import _kernels
from esvio_tpu_torch.utils.metrics import count, count_later, to_host

WIN = 21
HALF = WIN // 2
PATCH = 48              # per-feature patch side (tracking range ≈ ±13 px/level)
_MIN_EIG_THRESH = 1e-4  # OpenCV minEigThreshold (per-pixel normalized)
FB_LEVELS = 2           # the reverse check's levels, the finest (maxLevel)


def _extract_patches(img, oy, ox, Sy, Sx):
    """(N,) int origins → (N, Sy, Sx) patches of img (H, W)."""
    dev = img.device
    rows = oy[:, None] + torch.arange(Sy, device=dev)
    cols = ox[:, None] + torch.arange(Sx, device=dev)
    return img[rows[:, :, None], cols[:, None, :]]


def _scharr_patches(P):
    """Batched 3×3 Scharr (∂x, ∂y, 1/32 normalization) on (N, Sy, Sx)
    patches with edge replication."""
    N, Sy, Sx = P.shape
    Pp = torch.nn.functional.pad(P[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    rows = 3.0 * Pp[:, :-2, :] + 10.0 * Pp[:, 1:-1, :] + 3.0 * Pp[:, 2:, :]
    ix = (rows[:, :, 2:] - rows[:, :, :-2]) / 32.0
    cols = 3.0 * Pp[:, :, :-2] + 10.0 * Pp[:, :, 1:-1] + 3.0 * Pp[:, :, 2:]
    iy = (cols[:, 2:, :] - cols[:, :-2, :]) / 32.0
    return ix, iy


def _hat_sample(patch, ry, rx):
    """Bilinear resample inside patches via separable hat-weight matmuls.

    patch (N, Sy, Sx); ry/rx (N, WIN) positions in patch coordinates
    (clamped like cv borderValue=replicate) → (N, WIN, WIN) [y, x]."""
    N, Sy, Sx = patch.shape
    dt, dev = patch.dtype, patch.device
    ry = torch.clamp(ry, 0.0, Sy - 1.0)
    rx = torch.clamp(rx, 0.0, Sx - 1.0)
    sy = torch.arange(Sy, dtype=dt, device=dev)
    sx = torch.arange(Sx, dtype=dt, device=dev)
    Wy = torch.clamp(1.0 - torch.abs(ry[:, :, None] - sy), min=0.0)   # (N, 21, Sy)
    Wx = torch.clamp(1.0 - torch.abs(rx[:, :, None] - sx), min=0.0)   # (N, 21, Sx)
    V = torch.bmm(Wy, patch)                                          # (N, 21, Sx)
    return torch.bmm(V, Wx.transpose(1, 2))                           # (N, 21, 21)


def _track_level(img_prev, img_cur, pts_prev, guess, iters, eps,
                 check_status=True, active=None):
    """One pyramid level of LK for ALL features → (new_guess, ok)."""
    H, W = img_prev.shape
    dt, dev = img_prev.dtype, img_prev.device
    N = pts_prev.shape[0]
    Sy = min(PATCH, H)
    Sx = min(PATCH, W)
    off = torch.arange(-HALF, HALF + 1, dtype=dt, device=dev)

    # ---- template windows + gradients (prev image, fixed) -----------------
    px, py = pts_prev[:, 0], pts_prev[:, 1]
    oy_t = torch.clamp(torch.floor(py).to(torch.int64) - Sy // 2, 0, H - Sy)
    ox_t = torch.clamp(torch.floor(px).to(torch.int64) - Sx // 2, 0, W - Sx)
    ry_t = (py - oy_t.to(dt))[:, None] + off[None, :]
    rx_t = (px - ox_t.to(dt))[:, None] + off[None, :]
    Pp = _extract_patches(img_prev, oy_t, ox_t, Sy, Sx)
    Ixp, Iyp = _scharr_patches(Pp)
    Tp = _hat_sample(Pp, ry_t, rx_t)
    Ix = _hat_sample(Ixp, ry_t, rx_t)
    Iy = _hat_sample(Iyp, ry_t, rx_t)

    g_xx = torch.sum(Ix * Ix, (1, 2))
    g_xy = torch.sum(Ix * Iy, (1, 2))
    g_yy = torch.sum(Iy * Iy, (1, 2))
    det = g_xx * g_yy - g_xy * g_xy
    min_eig = 0.5 * (g_xx + g_yy
                     - torch.sqrt((g_xx - g_yy) ** 2 + 4.0 * g_xy ** 2))
    ok_grad = (min_eig / (WIN * WIN)) > _MIN_EIG_THRESH
    inv_det = torch.where(det > 1e-12, 1.0 / torch.clamp(det, min=1e-12),
                          torch.zeros_like(det))

    in_prev = ((px >= HALF) & (px < W - HALF) & (py >= HALF) & (py < H - HALF))

    # ---- current-image patches centered on the INITIAL guess --------------
    gx0, gy0 = guess[:, 0], guess[:, 1]
    oy_c = torch.clamp(torch.floor(gy0).to(torch.int64) - Sy // 2, 0, H - Sy)
    ox_c = torch.clamp(torch.floor(gx0).to(torch.int64) - Sx // 2, 0, W - Sx)
    Pc = _extract_patches(img_cur, oy_c, ox_c, Sy, Sx)
    oyf = oy_c.to(dt)
    oxf = ox_c.to(dt)

    converged = torch.zeros(N, dtype=torch.bool, device=dev) if active is None \
        else ~active
    g = guess
    n_it = 0
    for _ in range(iters):
        if to_host(converged.all()):
            break
        n_it += 1
        ry = (g[:, 1] - oyf)[:, None] + off[None, :]
        rx = (g[:, 0] - oxf)[:, None] + off[None, :]
        J = _hat_sample(Pc, ry, rx)
        r = J - Tp
        bx = torch.sum(Ix * r, (1, 2))
        by = torch.sum(Iy * r, (1, 2))
        dx = -(g_yy * bx - g_xy * by) * inv_det
        dy = -(g_xx * by - g_xy * bx) * inv_det
        delta = torch.stack([dx, dy], -1)
        done = torch.sum(delta * delta, -1) < eps * eps
        g = torch.where(converged[:, None], g, g + delta)
        converged = converged | done
    guess = g
    count("lk_calls")
    count("lk_iters", n_it)

    in_cur = ((guess[:, 0] >= 0.0) & (guess[:, 0] < W - 1.0)
              & (guess[:, 1] >= 0.0) & (guess[:, 1] < H - 1.0))
    in_patch = ((guess[:, 0] - oxf >= HALF - 1.0)
                & (guess[:, 0] - oxf <= Sx - HALF)
                & (guess[:, 1] - oyf >= HALF - 1.0)
                & (guess[:, 1] - oyf <= Sy - HALF))
    ok = ok_grad & in_prev & in_cur & in_patch
    if not check_status:
        ok = torch.ones_like(ok)
    return guess, ok


def lk_track(pyr_prev, pyr_cur, pts_prev, valid, pts_init=None,
             iters: int = 30, eps: float = 0.01):
    """Track features from the previous to the current pyramid.

    pyr_prev / pyr_cur: lists of (img,) levels, level 0 = full resolution;
    pts_prev (N, 2) (x, y) at level 0; valid (N,) bool; pts_init optional
    (N, 2) initial guess (OPTFLOW_USE_INITIAL_FLOW).
    Returns (pts_out (N, 2), status (N,) bool)."""
    levels = len(pyr_prev)
    if pts_init is None:
        pts_init = pts_prev
    scale_top = 2.0 ** (levels - 1)
    guess = pts_init / scale_top
    status = torch.ones(pts_prev.shape[0], dtype=torch.bool,
                        device=pts_prev.device)
    for lvl in reversed(range(levels)):
        img_p = pyr_prev[lvl][0]
        img_c = pyr_cur[lvl][0]
        if min(img_p.shape) >= WIN:  # skip levels smaller than the window
            p_lvl = pts_prev / (2.0 ** lvl)
            guess, ok = _track_level(img_p, img_c, p_lvl, guess, iters, eps,
                                     check_status=(lvl == 0), active=valid)
            status = status & ok
        if lvl > 0:
            guess = guess * 2.0
    return guess, status & valid


def _tracked_levels(imgs) -> int:
    """Level loops a pass over `imgs` runs: levels smaller than the window
    are skipped."""
    return sum(min(img.shape) >= WIN for img in imgs)


def launch_k3(pyr_prev, pyr_cur, pts, valid, pts_init=None,
              iters: int = 30, eps: float = 0.01):
    """Launch kernel K3 on CUDA float32 pyramids: the forward pass
    prev → cur from pts_init (default pts) and its reverse check
    cur → prev over the FB_LEVELS finest levels from pts.  Returns
    (pts_out (2, N, 2), status (2, N), lane_iters (N, level loops)):
    forward then reverse, and each lane's iterations per level loop."""
    imgs_a = [lvl[0] for lvl in pyr_prev]
    imgs_b = [lvl[0] for lvl in pyr_cur]
    pts_init = pts if pts_init is None else pts_init
    levels = len(imgs_a)
    floats = imgs_a + imgs_b + [pts, pts_init]
    if any(t.dtype != torch.float32 for t in floats) or valid.dtype != torch.bool:
        raise ValueError("launch_k3 takes float32 images and points and "
                         "a bool valid")
    N = pts.shape[0]
    if not (1 <= levels == len(imgs_b) <= 8) \
            or pts.shape != (N, 2) or pts_init.shape != (N, 2) \
            or valid.shape != (N,) \
            or any(a.dim() != 2 or a.shape != b.shape
                   for a, b in zip(imgs_a, imgs_b)):
        raise ValueError(
            f"launch_k3 shapes: pts {tuple(pts.shape)}, pts_init "
            f"{tuple(pts_init.shape)}, valid {tuple(valid.shape)}, levels "
            f"{[tuple(a.shape) for a in imgs_a]} / "
            f"{[tuple(b.shape) for b in imgs_b]}")
    if not all(t.is_contiguous() for t in floats + [valid]):
        raise ValueError("launch_k3 takes contiguous tensors")
    if not all(t.is_cuda for t in floats + [valid]):
        raise ValueError("launch_k3 needs CUDA tensors")
    loops = _tracked_levels(imgs_a) + _tracked_levels(imgs_a[:FB_LEVELS])
    dev = pts.device
    pts_out = torch.empty((2, N, 2), dtype=torch.float32, device=dev)
    st_out = torch.empty((2, N), dtype=torch.bool, device=dev)
    lane_iters = torch.empty((N, loops), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * (2 * levels))(*[t.data_ptr() for t in imgs_a + imgs_b])
    hw = (ctypes.c_int * (2 * levels))(*[d for a in imgs_a for d in a.shape])
    eps_sq = ctypes.c_float(eps * eps)
    err = _kernels.LK_TRACK.fn()(
        ctypes.addressof(ptrs), ctypes.addressof(hw), levels,
        pts.data_ptr(), pts_init.data_ptr(), valid.data_ptr(), pts_out.data_ptr(),
        st_out.data_ptr(), lane_iters.data_ptr(), N, iters,
        ctypes.addressof(eps_sq), _kernels.stream_ptr(dev))
    _kernels.check(err, _kernels.LK_TRACK)
    _kernels.LK_TRACK.launches += 1
    return pts_out, st_out, lane_iters


def lk_track_fb(pyr_prev, pyr_cur, pts, valid, pts_init=None,
                iters: int = 30, eps: float = 0.01):
    """A forward pass and its reverse check: track pts from the previous to
    the current pyramid (from pts_init, default pts), then the result back
    over the FB_LEVELS finest levels from pts, with the forward status as
    its valid flag.  Kernel K3 on the card (`launch_k3`; the record counts
    its level loops now and their iterations, each loop's most of any lane,
    once the stage has closed), two plain `lk_track` calls on the CPU.
    Returns (cur_pts, status, back_pts, back_status)."""
    if pts.is_cuda:
        pts_out, st_out, lane_iters = launch_k3(pyr_prev, pyr_cur, pts, valid,
                                                pts_init, iters, eps)
        count("lk_calls", lane_iters.shape[1])
        if lane_iters.numel():
            count_later("lk_iters", lambda: int(lane_iters.amax(0).sum()))
        return pts_out[0], st_out[0], pts_out[1], st_out[1]
    cur, st = lk_track(pyr_prev, pyr_cur, pts, valid, pts_init, iters, eps)
    back, st_b = lk_track(pyr_cur[:FB_LEVELS], pyr_prev[:FB_LEVELS], cur, st,
                          pts_init=pts, iters=iters, eps=eps)
    return cur, st, back, st_b
