"""Feature book maintenance: insertion, parallax keyframe test,
triangulation, window-slide shifts (port of
esvio_tpu/vio/feature_manager.py; reference feature_manager.cpp).

Functions return new FeatureBooks; arrays that change are fresh copies
updated in place (`index_put_`), never the caller's tensors.  Writes that
the JAX version drops (`mode="drop"`) go to one extra scratch lane that is
cut off afterwards, so no host synchronisation is needed.
"""
from __future__ import annotations

import dataclasses

import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.solver.window import (
    FOCAL, N_STATES, WINDOW, FeatureBook, WindowState, start_frame, used_num,
)

INIT_DEPTH = -1.0   # parameters.cpp (INIT_DEPTH): invalid-depth sentinel


def _at_start(a, s):
    idx = s.reshape((-1, 1) + (1,) * (a.dim() - 2)).expand(
        (a.shape[0], 1) + a.shape[2:])
    return torch.gather(a, 1, idx)[:, 0]


# ---------------------------------------------------------------------------
# observation insertion (stereo_addFeatureCheckParallax :314-425)
# ---------------------------------------------------------------------------

def insert_packet(book: FeatureBook, ids, valid, un, vel, right_valid, un_r,
                  vel_r, td, frame_idx: int):
    """Insert one tracker packet into window slot `frame_idx`.

    Known ids update their lane; new ids take free lanes (oldest free
    first).  Returns (book, n_tracked, n_dropped) — n_dropped counts new
    features lost because every lane was occupied."""
    L = book.ids.shape[0]
    dev = book.ids.device

    eq = (book.ids[:, None] == ids[None, :]) & book.active[:, None] & valid[None, :]
    lane_of = torch.argmax(eq.to(torch.uint8), dim=0)
    matched = torch.any(eq, dim=0)
    n_tracked = torch.sum(matched & valid)

    free = ~book.active
    free_order = torch.sort((~free).to(torch.uint8), stable=True).indices
    need = (~matched) & valid
    alloc_rank = torch.cumsum(need.to(torch.int64), 0) - 1
    can_alloc = need & (alloc_rank < torch.sum(free))
    alloc_lane = free_order[torch.clamp(alloc_rank, 0, L - 1)]

    lane = torch.where(matched, lane_of, alloc_lane)
    write = (matched | can_alloc) & valid
    lane_safe = torch.where(write, lane, torch.full_like(lane, L))  # L = scratch
    lane_c = torch.clamp(lane_safe, 0, L - 1)

    def upd(arr, valnew):
        ext = torch.cat([arr, torch.zeros_like(arr[:1])], 0)
        ext[lane_safe, frame_idx] = valnew.to(arr.dtype)
        return ext[:L]

    def upd_lane(arr, valnew):
        ext = torch.cat([arr, torch.zeros_like(arr[:1])], 0)
        ext[lane_safe] = valnew.to(arr.dtype)
        return ext[:L]

    stereo_new = right_valid | book.stereo[lane_c, frame_idx]
    zero = torch.zeros_like(book.inv_depth[lane_c])
    book = dataclasses.replace(
        book,
        un=upd(book.un, un), vel=upd(book.vel, vel),
        un_r=upd(book.un_r, un_r), vel_r=upd(book.vel_r, vel_r),
        obs=upd(book.obs, torch.ones_like(valid)),
        stereo=upd(book.stereo, stereo_new),
        td_obs=upd(book.td_obs, td.expand(ids.shape)),
        ids=upd_lane(book.ids, ids),
        active=upd_lane(book.active, torch.ones_like(valid)),
        inv_depth=upd_lane(book.inv_depth,
                           torch.where(matched, book.inv_depth[lane_c], zero)),
        depth_valid=upd_lane(book.depth_valid,
                             matched & book.depth_valid[lane_c]),
    )
    return book, n_tracked, torch.sum(need & ~can_alloc)


def mean_parallax(book: FeatureBook, frame_count: int):
    """Average parallax between frames fc-2 and fc-1 over long tracks
    (compensatedParallax2 :1103-1171).  Returns (mean, num)."""
    dev = book.un.device
    if frame_count < 2:
        return (torch.zeros((), dtype=book.un.dtype, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    i, j = frame_count - 2, frame_count - 1
    ok = book.active & book.obs[:, i] & book.obs[:, j] & (start_frame(book) <= i)
    du = book.un[:, i, 0] - book.un[:, j, 0]
    dv = book.un[:, i, 1] - book.un[:, j, 1]
    par = torch.sqrt(du * du + dv * dv)
    num = torch.sum(ok)
    mean = torch.sum(torch.where(ok, par, torch.zeros_like(par))) \
        / torch.clamp(num, min=1)
    return mean, num


# ---------------------------------------------------------------------------
# triangulation (:5-121 getDepth, :809-948)
# ---------------------------------------------------------------------------

def _adjugate4(a):
    """Adjugate of (N, 4, 4) matrices by 2 × 2 sub-determinants."""
    (a00, a01, a02, a03), (a10, a11, a12, a13), \
        (a20, a21, a22, a23), (a30, a31, a32, a33) = \
        (r.unbind(-1) for r in a.unbind(-2))
    s0, s1, s2 = a00 * a11 - a10 * a01, a00 * a12 - a10 * a02, a00 * a13 - a10 * a03
    s3, s4, s5 = a01 * a12 - a11 * a02, a01 * a13 - a11 * a03, a02 * a13 - a12 * a03
    c0, c1, c2 = a20 * a31 - a30 * a21, a20 * a32 - a30 * a22, a20 * a33 - a30 * a23
    c3, c4, c5 = a21 * a32 - a31 * a22, a21 * a33 - a31 * a23, a22 * a33 - a32 * a23
    rows = [
        [a11 * c5 - a12 * c4 + a13 * c3, -a01 * c5 + a02 * c4 - a03 * c3,
         a31 * s5 - a32 * s4 + a33 * s3, -a21 * s5 + a22 * s4 - a23 * s3],
        [-a10 * c5 + a12 * c2 - a13 * c1, a00 * c5 - a02 * c2 + a03 * c1,
         -a30 * s5 + a32 * s2 - a33 * s1, a20 * s5 - a22 * s2 + a23 * s1],
        [a10 * c4 - a11 * c2 + a13 * c0, -a00 * c4 + a01 * c2 - a03 * c0,
         a30 * s4 - a31 * s2 + a33 * s0, -a20 * s4 + a21 * s2 - a23 * s0],
        [-a10 * c3 + a11 * c1 - a12 * c0, a00 * c3 - a01 * c1 + a02 * c0,
         -a30 * s3 + a31 * s1 - a32 * s0, a20 * s3 - a21 * s1 + a22 * s0]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _null_vector(A):
    """Unit v minimising |A v| for A (N, R, 4): the right singular vector of
    the smallest singular value, SVD's last row of Vh up to sign.

    Taken in float64 as the dominant eigenvector of adj(AᵀA + sI), raised to
    the 4096th power by twelve squarings (the other directions fall by their
    eigenvalue ratio to the 4096th: below 1e-10 for ratios up to 0.994); of
    ties the last axis wins, as SVD's identity V of a zero matrix.  Plain tensor arithmetic: torch.linalg.svd
    and eigh check convergence on the host, which a CUDA graph cannot hold."""
    A64 = A.to(torch.float64)
    M = A64.transpose(-1, -2) @ A64
    shift = 1e-12 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) + 1e-30
    X = _adjugate4(M + shift[:, None, None]
                   * torch.eye(4, dtype=M.dtype, device=M.device))
    for _ in range(12):
        X = X / torch.amax(torch.abs(X), dim=(-2, -1), keepdim=True)
        X = X @ X
    k = 3 - torch.argmax(torch.diagonal(X, dim1=-2, dim2=-1).flip(-1), dim=-1)
    v = torch.gather(X, 2, k[:, None, None].expand(-1, 4, 1))[..., 0]
    return (v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)).to(A.dtype)


def _dlt_two_view(pose0, pose1, p0, p1):
    """4-row DLT (triangulatePoint :775-791), batched: p0/p1 (N, 2)."""
    A = torch.stack([
        p0[:, 0:1] * pose0[2] - pose0[0],
        p0[:, 1:2] * pose0[2] - pose0[1],
        p1[:, 0:1] * pose1[2] - pose1[0],
        p1[:, 1:2] * pose1[2] - pose1[1],
    ], dim=1)                                      # (N, 4, 4)
    v = _null_vector(A)
    return v[:, :3] / v[:, 3:4]


def _stereo_poses(Rrl, Trl, dtype):
    dev = Rrl.device
    pose0 = torch.cat([torch.eye(3, dtype=dtype, device=dev),
                       torch.zeros((3, 1), dtype=dtype, device=dev)], 1)
    pose1 = torch.cat([Rrl.to(dtype), Trl.to(dtype)[:, None]], 1)
    return pose0, pose1


def triangulate_stereo_instant(book: FeatureBook, Rrl, Trl,
                               stereo_correction: bool = False):
    """Per-feature instant stereo depth at the start frame with the
    reference gates (getDepth :5-121): disparity sign, depth ∈ (1, 7) m,
    right depth > 1, reprojection error ≤ 2/FOCAL on both views; with
    `stereo_correction` one Sampson step onto the epipolar manifold is
    taken where it reduces BOTH reprojection errors (:65-121)."""
    dtype = book.un.dtype
    dev = book.un.device
    s = start_frame(book)
    L = book.un.shape[0]
    has_stereo0 = _at_start(book.stereo, s)
    p0 = _at_start(book.un, s)
    p1 = _at_start(book.un_r, s)
    pose0, pose1 = _stereo_poses(Rrl, Trl, dtype)
    Rrl = Rrl.to(dtype)
    Trl = Trl.to(dtype)

    def guard(z):
        return torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))

    def tri_and_errs(pa, pb):
        pt3 = _dlt_two_view(pose0, pose1, pa, pb)
        depth = pt3[:, 2]
        proj0 = pt3[:, :2] / guard(depth)[:, None]
        pt_r = pt3 @ Rrl.T + Trl
        zr = pt_r[:, 2]
        proj1 = pt_r[:, :2] / guard(zr)[:, None]
        err0 = torch.linalg.vector_norm(proj0 - pa, dim=-1)
        err1 = torch.linalg.vector_norm(proj1 - pb, dim=-1)
        return depth, zr, err0, err1

    depth, zr, err0, err1 = tri_and_errs(p0, p1)
    good = (has_stereo0 & book.active & (p0[:, 0] >= p1[:, 0])
            & (depth > 1.0) & (depth < 7.0) & (zr > 1.0)
            & (err0 <= 2.0 / FOCAL) & (err1 <= 2.0 / FOCAL))

    if stereo_correction:
        ones = torch.ones((L, 1), dtype=dtype, device=dev)
        n0 = torch.cat([p0, ones], 1)
        n1 = torch.cat([p1, ones], 1)
        G = lie.skew(Trl) @ Rrl.T
        fe = torch.einsum("li,ij,lj->l", n0, G, n1)
        v1 = n0 @ G
        v1[:, 2] = 0.0
        v2 = n1 @ G.T
        v2[:, 2] = 0.0
        de = torch.sum(v1 * v1, 1) + torch.sum(v2 * v2, 1)
        de = torch.where(de > 1e-12, de, torch.ones_like(de))
        c0 = p0 - (fe / de)[:, None] * v2[:, :2]
        c1 = p1 - (fe / de)[:, None] * v1[:, :2]
        depth_c, zr_c, err0_c, err1_c = tri_and_errs(c0, c1)
        improved = good & (zr_c > 1.0) & (err0_c <= err0) & (err1_c <= err1)
        depth = torch.where(improved, depth_c, depth)
        # the reference also overwrites point/pointRight on success
        lanes = torch.arange(L, device=dev)
        un = book.un.clone()
        un_r = book.un_r.clone()
        un[lanes, s] = torch.where(improved[:, None], c0, p0)
        un_r[lanes, s] = torch.where(improved[:, None], c1, p1)
        book = dataclasses.replace(book, un=un, un_r=un_r)

    take = good & ~book.depth_valid
    inv_depth = torch.where(take, 1.0 / torch.clamp(depth, min=1e-6),
                            book.inv_depth)
    return dataclasses.replace(book, inv_depth=inv_depth,
                               depth_valid=book.depth_valid | take)


def stereo_depth_table(un, un_r, stereo, Rrl, Trl):
    """(L, F) instant stereo DLT depths with the bootstrap gates (disparity
    sign, z ∈ (1, 7) m — getDepth :32); −1 where invalid."""
    L, F = stereo.shape
    pose0, pose1 = _stereo_poses(Rrl, Trl, un.dtype)
    z = _dlt_two_view(pose0, pose1, un.reshape(L * F, 2),
                      un_r.reshape(L * F, 2))[:, 2].reshape(L, F)
    ok = stereo & (un[..., 0] >= un_r[..., 0]) & (z > 1.0) & (z < 7.0)
    return torch.where(ok, z, torch.full_like(z, -1.0))


def triangulate_multiview(book: FeatureBook, state: WindowState, ex_idx: int):
    """Masked multi-view SVD triangulation (stereo_triangulate :822-877)."""
    dtype = book.un.dtype
    L = book.un.shape[0]
    s = start_frame(book)
    gate = book.active & (used_num(book) >= 2) & (s < WINDOW - 2) \
        & ~book.depth_valid

    Rws = lie.quat_to_rot(state.Q)                        # (11, 3, 3)
    Rex = lie.quat_to_rot(state.ex_q[ex_idx])
    tex = state.ex_p[ex_idx]
    t_wc = state.P + torch.einsum("fij,j->fi", Rws, tex)  # (11, 3)
    R_wc = torch.einsum("fij,jk->fik", Rws, Rex)          # (11, 3, 3)

    t0 = t_wc[s]                                          # (L, 3)
    R0 = R_wc[s]                                          # (L, 3, 3)
    t_rel = torch.einsum("lji,lfj->lfi", R0, t_wc[None] - t0[:, None])
    R_rel = torch.einsum("lji,fjk->lfik", R0, R_wc)       # (L, 11, 3, 3)
    P_rows = torch.cat(
        [R_rel.transpose(-1, -2),
         -torch.einsum("lfij,lfi->lfj", R_rel, t_rel)[..., None]], dim=-1)
    f = torch.cat([book.un, torch.ones_like(book.un[..., :1])], -1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    row0 = f[..., 0:1] * P_rows[..., 2, :] - f[..., 2:3] * P_rows[..., 0, :]
    row1 = f[..., 1:2] * P_rows[..., 2, :] - f[..., 2:3] * P_rows[..., 1, :]
    m = book.obs[..., None].to(dtype)
    A = torch.cat([row0 * m, row1 * m], dim=1)            # (L, 22, 4)
    v = _null_vector(A)
    depth = v[:, 2] / v[:, 3]
    ok = gate & (depth >= 0.1)
    inv_depth = torch.where(ok, 1.0 / torch.clamp(depth, min=1e-6),
                            book.inv_depth)
    return dataclasses.replace(book, inv_depth=inv_depth,
                               depth_valid=book.depth_valid | ok)


def world_points(book: FeatureBook, state: WindowState, ex_idx: int):
    """World positions of depth-valid landmarks (anchor-frame
    back-projection).  Returns (pts_w (L, 3), valid (L,))."""
    L = book.un.shape[0]
    s = start_frame(book)
    valid = book.active & book.depth_valid
    Rws = lie.quat_to_rot(state.Q)
    Rex = lie.quat_to_rot(state.ex_q[ex_idx])
    tex = state.ex_p[ex_idx]
    un_s = _at_start(book.un, s)
    depth = 1.0 / torch.clamp(torch.abs(book.inv_depth), min=1e-6)
    p_cam = torch.cat([un_s, torch.ones_like(un_s[:, :1])], 1) * depth[:, None]
    p_body = torch.einsum("ij,lj->li", Rex, p_cam) + tex
    pts_w = torch.einsum("lij,lj->li", Rws[s], p_body) + state.P[s]
    return pts_w, valid


# ---------------------------------------------------------------------------
# window slide (removeBackShiftDepth :952-1018, removeFront)
# ---------------------------------------------------------------------------

def slide_old(book: FeatureBook, marg_P, marg_Q, new_P, new_Q, ex_p, ex_q):
    """Slide after MARGIN_OLD: shift observations one slot left, re-anchor
    features anchored at frame 0 to the new frame 0 with transformed depth,
    drop lanes left with < 2 observations (removeBackShiftDepth)."""
    s = start_frame(book)
    anchored0 = book.active & (s == 0) & book.obs[:, 0]

    Rm = lie.quat_to_rot(marg_Q)
    Rn = lie.quat_to_rot(new_Q)
    Rex = lie.quat_to_rot(ex_q)
    R_w_old = Rm @ Rex
    t_w_old = marg_P + Rm @ ex_p
    R_w_new = Rn @ Rex
    t_w_new = new_P + Rn @ ex_p

    uv0 = book.un[:, 0]
    big = torch.abs(book.inv_depth) > 1e-9
    depth = torch.where(book.depth_valid & big,
                        1.0 / torch.where(big, book.inv_depth,
                                          torch.ones_like(book.inv_depth)),
                        torch.ones_like(book.inv_depth))
    pts_cam = torch.cat([uv0, torch.ones_like(uv0[:, :1])], 1) * depth[:, None]
    pts_w = pts_cam @ R_w_old.T + t_w_old
    new_depth = ((pts_w - t_w_new) @ R_w_new)[:, 2]
    re_ok = anchored0 & book.depth_valid & (new_depth > 0.1)

    def shift(a):
        return torch.cat([a[:, 1:], torch.zeros_like(a[:, -1:])], dim=1)

    obs2 = shift(book.obs)
    inv_new = torch.where(
        anchored0,
        torch.where(re_ok, 1.0 / torch.clamp(new_depth, min=1e-6),
                    torch.zeros_like(new_depth)),
        book.inv_depth)
    depth_valid = torch.where(anchored0, re_ok, book.depth_valid)
    n_obs = torch.sum(obs2, dim=1)
    alive = book.active & (n_obs >= 1) & ~(anchored0 & (n_obs < 2))
    return dataclasses.replace(
        book, un=shift(book.un), vel=shift(book.vel), un_r=shift(book.un_r),
        vel_r=shift(book.vel_r), obs=obs2, stereo=shift(book.stereo),
        td_obs=shift(book.td_obs),
        inv_depth=torch.where(alive, inv_new, torch.zeros_like(inv_new)),
        depth_valid=depth_valid & alive, active=alive,
        ids=torch.where(alive, book.ids, torch.full_like(book.ids, -1)))


def slide_second_new(book: FeatureBook, frame_count: int):
    """Slide after MARGIN_SECOND_NEW (removeFront): slot fc moves into
    fc-1, slot fc is cleared."""
    j = frame_count - 1

    def mv(a):
        a = a.clone()
        a[:, j] = a[:, frame_count]
        a[:, frame_count] = 0
        return a

    obs2 = mv(book.obs)
    alive = book.active & (torch.sum(obs2, dim=1) >= 1)
    return dataclasses.replace(
        book, un=mv(book.un), vel=mv(book.vel), un_r=mv(book.un_r),
        vel_r=mv(book.vel_r), obs=obs2, stereo=mv(book.stereo),
        td_obs=mv(book.td_obs), active=alive,
        ids=torch.where(alive, book.ids, torch.full_like(book.ids, -1)),
        depth_valid=book.depth_valid & alive)


def remove_failures(book: FeatureBook):
    """Drop features whose optimized depth went negative (removeFailures)."""
    bad = book.active & book.depth_valid & (book.inv_depth < 0)
    alive = book.active & ~bad
    return dataclasses.replace(
        book, active=alive,
        ids=torch.where(alive, book.ids, torch.full_like(book.ids, -1)),
        depth_valid=book.depth_valid & alive)
