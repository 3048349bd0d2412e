"""Sequence parallelism: one long trajectory → overlapping windows solved as
a batch → stitched global trajectory (port of
esvio_tpu/dist/sequence_parallel.py).

A recorded long sequence (offline refinement / mapping mode) is split into
overlapping 11-frame windows, solved together by
`solver/gauss_newton.solve_window_batched` (one assembly for all windows,
one K2 launch per LM iteration), and stitched back by aligning each
window's gauge (yaw + position, the unobservable directions of a VI
window) to its predecessor over the overlap frames.  The windows are also
the "dp" batch of `dist/distributed_ba.make_sharded_solver`.
"""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.core import lie_np
from esvio_tpu_torch.imu import preintegration as pre
from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver import window as win
from esvio_tpu_torch.vio import feature_manager as fm

WINDOW_FRAMES = win.N_STATES     # 11


def window_starts(T: int, overlap: int = 2) -> np.ndarray:
    """Start indices of overlapping windows covering frames [0, T)."""
    stride = WINDOW_FRAMES - overlap
    starts = list(range(0, max(T - WINDOW_FRAMES, 0) + 1, stride))
    if starts[-1] + WINDOW_FRAMES < T:
        starts.append(T - WINDOW_FRAMES)
    return np.asarray(starts, np.int32)


def gather_windows(long_state: dict, long_book: dict, starts,
                   imu_params: pre.ImuParams, dtype=torch.float32,
                   device="cuda"):
    """Slice a long log into batched windows on `device`.

    long_state: dict(P (T,3), Q (T,4), V (T,3), Ba (T,3), Bg (T,3),
                     ex_p (4,3), ex_q (4,4)) — the initial guess (e.g. the
                     online pipeline's output) — and the IMU samples of
                     each interval t→t+1: imu_dt (T-1, C), imu_acc/imu_gyr
                     (T-1, C, 3), imu_n (T-1,).
    long_book:  dict(un (L,T,2), un_r, vel, vel_r, obs (L,T), stereo (L,T))
                — per-frame normalized observations of L feature lanes.

    Returns (states, books_evt, preints, imu_valid) with a leading window
    axis B; the B × 10 intervals are preintegrated in one batch."""
    starts = np.asarray(starts, np.int64)
    idx = starts[:, None] + np.arange(WINDOW_FRAMES)[None, :]     # (B, 11)
    B = len(starts)
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=device)

    def g(x):  # gather frames along axis 0
        return t(np.asarray(x)[idx])

    states = win.WindowState(
        P=g(long_state["P"]), Q=g(long_state["Q"]), V=g(long_state["V"]),
        Ba=g(long_state["Ba"]), Bg=g(long_state["Bg"]),
        ex_p=t(long_state["ex_p"]).expand(B, 4, 3).contiguous(),
        ex_q=t(long_state["ex_q"]).expand(B, 4, 4).contiguous(),
        td=torch.zeros((B,), dtype=dtype, device=device))

    def gb(x, dt=dtype):  # (L, T, ...) → (B, L, 11, ...)
        return t(np.moveaxis(np.asarray(x)[:, idx], 1, 0), dt)

    obs = gb(long_book["obs"], torch.bool)
    L = obs.shape[1]
    books = win.FeatureBook(
        un=gb(long_book["un"]), vel=gb(long_book["vel"]),
        un_r=gb(long_book["un_r"]), vel_r=gb(long_book["vel_r"]),
        obs=obs, stereo=gb(long_book["stereo"], torch.bool),
        td_obs=torch.zeros(obs.shape, dtype=dtype, device=device),
        inv_depth=torch.zeros((B, L), dtype=dtype, device=device),
        depth_valid=torch.zeros((B, L), dtype=torch.bool, device=device),
        active=obs.sum(-1) >= 2,
        ids=torch.arange(L, dtype=torch.int32, device=device).expand(B, L)
        .contiguous())

    # the 10 intervals of every window, preintegrated as one (B·10) batch
    iidx = (starts[:, None] + np.arange(win.WINDOW)[None, :]).reshape(-1)
    dt_w = t(np.asarray(long_state["imu_dt"])[iidx])               # (B·10, C)
    acc_w = t(np.asarray(long_state["imu_acc"])[iidx])
    gyr_w = t(np.asarray(long_state["imu_gyr"])[iidx])
    n_w = t(np.asarray(long_state["imu_n"])[iidx], torch.int64)
    C = dt_w.shape[-1]
    mask = torch.arange(C, device=device)[None, :] < n_w[:, None]
    preints = pre.preintegrate_batch(
        dt_w, acc_w, gyr_w, acc_w[:, 0], gyr_w[:, 0],
        states.Ba[:, :win.WINDOW].reshape(-1, 3),
        states.Bg[:, :win.WINDOW].reshape(-1, 3), imu_params, mask)
    preints = win.tree_map(
        lambda x: x.reshape((B, win.WINDOW) + x.shape[1:]), preints)
    imu_valid = (torch.sum(dt_w * mask, -1) > 0).reshape(B, win.WINDOW)
    return states, books, preints, imu_valid


def _flat_lanes(book: win.FeatureBook) -> win.FeatureBook:
    """(B, L, ...) books → (B·L, ...) lanes."""
    return win.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), book)


def solve_windows_batched(states, books, preints, imu_valid, g,
                          iters: int = 8, rrl=None, trl=None):
    """Triangulate and solve the window batch on one device; use
    dist/distributed_ba.make_sharded_solver for the sharded version.

    The instant stereo triangulation reads no window state, so it runs on
    the B·L lanes flattened into one book; the multi-view triangulation
    reads each window's poses and runs once per window (a loop over B)."""
    dtype, dev = states.P.dtype, states.P.device
    B, L = books.obs.shape[:2]
    if rrl is not None:
        flat = fm.triangulate_stereo_instant(_flat_lanes(books), rrl, trl)
        books = win.tree_map(lambda x: x.reshape((B, L) + x.shape[1:]), flat)
    per = [fm.triangulate_multiview(
        win.tree_map(lambda x: x[b], books),
        win.tree_map(lambda x: x[b], states), 1) for b in range(B)]
    books = win.tree_map(lambda *xs: torch.stack(xs), *per)
    book_img = win.tree_map(lambda x: x.expand((B,) + x.shape),
                            win.empty_book(1, dev, dtype))
    prior = win.tree_map(lambda x: x.expand((B,) + x.shape),
                         gn.empty_prior(dev, dtype))
    st, _, be, costs = gn.solve_window_batched(
        states, book_img, books, preints, imu_valid, prior, g, iters=iters)
    return st, be, costs


def stitch(states: win.WindowState, starts, T: int, overlap: int = 2):
    """Chain the batch back into one trajectory by aligning each window's
    gauge to its predecessor over the shared frames.

    Window b+1's first `overlap` frames are window b's last `overlap`
    frames; the unobservable directions per window are yaw + position, so
    the alignment is the rigid yaw + translation mapping b+1's overlap
    poses onto b's (the reference's gauge-fix math,
    stereo_double2vector3 estimator.cpp:1600-1697, window to window).
    Returns (P (T,3), Q (T,4)) numpy."""
    starts = np.asarray(starts)
    P = states.P.detach().cpu().numpy().astype(np.float64)
    Q = states.Q.detach().cpu().numpy().astype(np.float64)
    out_P = np.zeros((T, 3))
    out_Q = np.zeros((T, 4))
    out_Q[:, 0] = 1.0

    Rz = lambda y: lie_np.ypr_to_rot([y, 0.0, 0.0])
    yaw_of = lambda q: float(lie_np.rot_to_ypr(lie_np.quat_to_rot(q))[0])

    R_fix = np.eye(3)
    t_fix = np.zeros(3)
    for b, s in enumerate(starts):
        Pb = P[b] @ R_fix.T + t_fix
        Qb = np.stack([lie_np.rot_to_quat(R_fix @ lie_np.quat_to_rot(q))
                       for q in Q[b]])
        n_new = WINDOW_FRAMES if b == 0 else WINDOW_FRAMES - overlap
        lo = s if b == 0 else s + overlap
        out_P[lo:s + WINDOW_FRAMES] = Pb[WINDOW_FRAMES - n_new:]
        out_Q[lo:s + WINDOW_FRAMES] = Qb[WINDOW_FRAMES - n_new:]
        if b + 1 < len(starts):
            s2 = starts[b + 1]
            ov = np.arange(s2, min(s + WINDOW_FRAMES, s2 + overlap))
            k2 = ov - s2
            # yaw angles in degrees (the rot_to_ypr / ypr_to_rot convention)
            dyaw = np.mean([yaw_of(out_Q[f]) - yaw_of(Q[b + 1][k])
                            for f, k in zip(ov, k2)])
            R_fix = Rz(dyaw)
            t_fix = np.mean([out_P[f] - R_fix @ P[b + 1][k]
                             for f, k in zip(ov, k2)], axis=0)
    return out_P, out_Q
