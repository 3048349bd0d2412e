"""Stereo feature trackers — one functional step per tick (port of
esvio_tpu/frontend/tracker.py).

    track_event_stereo: (state, event_chunk_L, event_chunk_R, t_now)
    track_image_stereo: (image state, frame_L, frame_R, t_frame)
        → (state', FeaturePacket)

Per event tick (fixed capacity, masks):
  1. SAE update of both cameras (one batch of 2) + exponential time surfaces
     (+ CLAHE with `equalize`)
  2. temporal LK prev←cur on the left time surface + reverse check ≤ 0.5 px
  3. FM-RANSAC outlier rejection at virtual focal 460
  4. joint min-dist spacing of survivors (by track count) and fresh Arc*
     corner candidates (in event order, gated by time-surface ≠ 128)
  5. left→right stereo LK association with reverse check
  6. undistortion to the normalized plane + per-feature velocity

The image path (trackImage, feature_tracker.cpp:164-338) runs the same
steps 2-6 on frame pyramids, with Shi-Tomasi candidates in step 4.

Under the per-tick record (utils/metrics.py) the steps are the sub-spans
`frontend_event.sae` (1), `.temporal` (2-3), `.corners` (4, the corner
harvest) and `.refill_stereo` (4-6: spacing, compaction, stereo LK,
undistortion); the image path's are `frontend_image.prep` (CLAHE and the
pyramids), `.temporal`, `.corners` (Shi-Tomasi) and `.refill_stereo`,
after the pipeline's `frontend_image.upload` (apps/pipeline.py: the two
frames handed to the device, converted to float32 and resized).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from esvio_tpu_torch.core import prng
from esvio_tpu_torch.core.camera import CameraModel, lift_projective
from esvio_tpu_torch.events import corners as cor_mod
from esvio_tpu_torch.events import sae as sae_mod
from esvio_tpu_torch.frontend import detect, lk, pyramid, ransac
from esvio_tpu_torch.frontend import mask as mask_mod
from esvio_tpu_torch.frontend.clahe import clahe
from esvio_tpu_torch.utils.metrics import span

TS_LK_THRESHOLD = 128.0  # background value of polarity time surfaces


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    width: int = 346
    height: int = 260
    capacity: int = 256          # feature lanes (static)
    cand_capacity: int = 1024    # corner candidates considered per tick
    max_cnt: int = 150
    min_dist: int = 10
    f_threshold: float = 1.0
    decay_ms: float = 20.0
    ignore_polarity: bool = False
    filter_threshold: float = 0.01
    lk_levels: int = 4
    lk_iters: int = 30
    fb_threshold: float = 0.5
    ransac_hypotheses: int = 128
    use_time_surface_gate: bool = True
    equalize: bool = False         # CLAHE on time surfaces / frames (EQUALIZE)
    median_blur_ksize: int = 0
    spacing: str = "grid"          # "grid" (parallel WTA) | "greedy" (serial scan)

    def __post_init__(self):
        if self.spacing not in ("grid", "greedy"):
            raise ValueError(f"spacing {self.spacing!r}: 'grid' or 'greedy'")


@dataclasses.dataclass
class TrackerState:
    sae_left: sae_mod.SAEState
    sae_right: sae_mod.SAEState
    prev_pyr: list               # left time-surface LK pyramid, [(img,), ...]
    pts: torch.Tensor            # (F, 2) current feature pixels (left)
    ids: torch.Tensor            # (F,) int32
    track_cnt: torch.Tensor      # (F,) int32
    valid: torch.Tensor          # (F,) bool
    prev_un: torch.Tensor        # (F, 2)
    prev_un_right: torch.Tensor  # (F, 2)
    prev_right_valid: torch.Tensor  # (F,) bool
    prev_time: torch.Tensor      # () f32
    next_id: torch.Tensor        # () int32
    key: torch.Tensor            # (2,) threefry key for RANSAC


@dataclasses.dataclass
class FeaturePacket:
    """One tick of stereo feature observations (→ estimator), the PointCloud
    packet layout of stereo_event_tracker_node.cpp:268-342."""

    t: torch.Tensor
    ids: torch.Tensor           # (F,) int32
    valid: torch.Tensor         # (F,) bool
    un: torch.Tensor            # (F, 2) normalized left
    uv: torch.Tensor            # (F, 2) pixels left
    vel: torch.Tensor           # (F, 2)
    right_valid: torch.Tensor   # (F,) bool
    un_right: torch.Tensor      # (F, 2)
    uv_right: torch.Tensor      # (F, 2)
    vel_right: torch.Tensor     # (F, 2)
    track_cnt: torch.Tensor     # (F,) int32


def init_state(cfg: TrackerConfig, device="cuda", key=None,
               dtype=torch.float32) -> TrackerState:
    F = cfg.capacity
    zero_img = torch.zeros((cfg.height, cfg.width), dtype=dtype, device=device)
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return TrackerState(
        sae_left=sae_mod.init_sae(cfg.height, cfg.width, device, dtype),
        sae_right=sae_mod.init_sae(cfg.height, cfg.width, device, dtype),
        prev_pyr=pyramid.build_lk_pyramid(zero_img, cfg.lk_levels),
        pts=z(F, 2),
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        track_cnt=z(F, dt=torch.int32),
        valid=z(F, dt=torch.bool),
        prev_un=z(F, 2), prev_un_right=z(F, 2),
        prev_right_valid=z(F, dt=torch.bool),
        prev_time=torch.zeros((), dtype=dtype, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        key=key.to(device) if key is not None else prng.PRNGKey(0, device),
    )


def _compact_order(keep, is_new, F: int):
    """Kept existing lanes first (lane order), then kept new detections
    (detection order): top-k over group-ranked keys.
    Returns (order (F,) int64, valid (F,) bool)."""
    n_all = keep.shape[0]
    i = torch.arange(n_all, dtype=torch.float32, device=keep.device)
    key = torch.where(keep & ~is_new, 3.0 * n_all - i,
                      torch.where(keep, 2.0 * n_all - i, 1.0 * n_all - i))
    order = torch.topk(key, F).indices
    n_keep = torch.clamp(torch.sum(keep.to(torch.int64)), max=F)
    valid = torch.arange(F, device=keep.device) < n_keep
    return order, valid


def _in_border(cfg: TrackerConfig, pts):
    x = torch.round(pts[..., 0])
    y = torch.round(pts[..., 1])
    return (x >= 1) & (x < cfg.width - 1) & (y >= 1) & (y < cfg.height - 1)


def _virtual_pixels(cfg: TrackerConfig, un):
    return torch.stack(
        [un[..., 0] * ransac.FOCAL_VIRTUAL + cfg.width / 2.0,
         un[..., 1] * ransac.FOCAL_VIRTUAL + cfg.height / 2.0], dim=-1)


def _stack_chunks(a: sae_mod.EventChunk, b: sae_mod.EventChunk):
    return sae_mod.EventChunk(
        t=torch.stack([a.t, b.t]), x=torch.stack([a.x, b.x]),
        y=torch.stack([a.y, b.y]), p=torch.stack([a.p, b.p]),
        valid=torch.stack([a.valid, b.valid]))


def _track_temporal(cfg: TrackerConfig, cam_left: CameraModel, state,
                    pyr_l, k_ransac, ransac_draws=None):
    """Steps 2-3: temporal LK prev←cur with a reverse check on the two fine
    levels (feature_tracker.cpp:410-428), then FM-RANSAC in the
    virtual-focal frame (rejectWithF).  Returns (cur, tracked, track_cnt)."""
    cur, st, back, st_b = lk.lk_track_fb(state.prev_pyr, pyr_l, state.pts,
                                         state.valid, iters=cfg.lk_iters)
    fb_ok = torch.sum((back - state.pts) ** 2, dim=-1) <= cfg.fb_threshold ** 2
    tracked = st & st_b & fb_ok & _in_border(cfg, cur)

    un_cur3 = lift_projective(cam_left, cur)
    un_cur2 = un_cur3[..., :2] / un_cur3[..., 2:3]
    inl, _ = ransac.fundamental_ransac(
        k_ransac, _virtual_pixels(cfg, state.prev_un),
        _virtual_pixels(cfg, un_cur2), tracked, cfg.f_threshold,
        cfg.ransac_hypotheses, draws=ransac_draws)
    tracked = torch.where(torch.sum(tracked) >= 8, inl & tracked, tracked)
    track_cnt = torch.where(tracked, state.track_cnt + 1,
                            torch.zeros_like(state.track_cnt))
    return cur, tracked, track_cnt


def _refill_and_stereo(cfg: TrackerConfig, cam_left: CameraModel,
                       cam_right: CameraModel, state, pyr_l, pyr_r, cur,
                       tracked, track_cnt, cand_x, cand_y, cand_valid, t_now):
    """Steps 4-6 from the C candidates (in priority order): joint spacing of
    survivors and candidates, compaction (kept lanes first, then new
    detections), stereo LK with a reverse check, undistortion and
    velocities.  Returns (packet, the new state's fields but prev_pyr and
    key)."""
    F = cfg.capacity
    C = cand_x.shape[0]
    dtype = cur.dtype
    dev = cur.device

    # priorities: existing (1e6 + track_cnt) ≫ candidates (1e5 - rank)
    pri = torch.cat([1e6 + track_cnt.to(dtype),
                     1e5 - torch.arange(C, dtype=dtype, device=dev)])
    all_x = torch.cat([cur[:, 0], cand_x])
    all_y = torch.cat([cur[:, 1], cand_y])
    all_valid = torch.cat([tracked, cand_valid])
    spacing_fn = mask_mod.grid_spacing if cfg.spacing == "grid" \
        else mask_mod.greedy_spacing
    keep, _ = spacing_fn(pri, all_x, all_y, all_valid, cfg.height, cfg.width,
                         cfg.min_dist, cfg.max_cnt)
    keep_new = keep[F:]

    # ---- compaction: kept existing lanes first, then new detections -------
    new_rank = (torch.cumsum(keep_new.to(torch.int32), 0) - 1).to(torch.int32)
    new_ids = torch.where(keep_new, state.next_id + new_rank,
                          torch.full_like(new_rank, -1))
    next_id = state.next_id + torch.sum(keep_new.to(torch.int32)).to(torch.int32)

    all_pts = torch.cat([cur, torch.stack([cand_x, cand_y], dim=-1)])
    all_ids = torch.cat([state.ids, new_ids])
    all_cnt = torch.cat([track_cnt, torch.ones(C, dtype=torch.int32, device=dev)])
    is_new = torch.cat([torch.zeros(F, dtype=torch.bool, device=dev),
                        torch.ones(C, dtype=torch.bool, device=dev)])
    zc2 = torch.zeros((C, 2), dtype=dtype, device=dev)
    all_prev_un = torch.cat([state.prev_un, zc2])
    all_prev_unr = torch.cat([state.prev_un_right, zc2])
    all_prev_rv = torch.cat([state.prev_right_valid,
                             torch.zeros(C, dtype=torch.bool, device=dev)])

    order, valid_n = _compact_order(keep, is_new, F)
    pts_n = all_pts[order]
    ids_n = torch.where(valid_n, all_ids[order], torch.full_like(all_ids[order], -1))
    cnt_n = torch.where(valid_n, all_cnt[order], torch.zeros_like(all_cnt[order]))
    isnew_n = is_new[order] & valid_n
    prev_un_n = all_prev_un[order]
    prev_unr_n = all_prev_unr[order]
    prev_rv_n = all_prev_rv[order]

    # ---- 5. stereo LK with reverse check (feature_tracker.cpp:490-505) ----
    r_pts, r_st, r_back, r_st_b = lk.lk_track_fb(pyr_l, pyr_r, pts_n, valid_n,
                                                 iters=cfg.lk_iters)
    r_fb = torch.sum((r_back - pts_n) ** 2, dim=-1) <= cfg.fb_threshold ** 2
    right_valid = r_st & r_st_b & r_fb & _in_border(cfg, r_pts) & valid_n

    # ---- 6. undistort + velocities ----------------------------------------
    un3 = lift_projective(cam_left, pts_n)
    un = un3[..., :2] / un3[..., 2:3]
    unr3 = lift_projective(cam_right, r_pts)
    unr = unr3[..., :2] / unr3[..., 2:3]

    dt = torch.clamp(t_now - state.prev_time, min=1e-6)
    zero2 = torch.zeros_like(un)
    vel = torch.where((valid_n & ~isnew_n)[:, None], (un - prev_un_n) / dt, zero2)
    vel_r = torch.where((right_valid & prev_rv_n & ~isnew_n)[:, None],
                        (unr - prev_unr_n) / dt, zero2)

    packet = FeaturePacket(
        t=t_now, ids=ids_n, valid=valid_n, un=un, uv=pts_n, vel=vel,
        right_valid=right_valid, un_right=unr, uv_right=r_pts, vel_right=vel_r,
        track_cnt=cnt_n)
    fields = dict(pts=pts_n, ids=ids_n, track_cnt=cnt_n, valid=valid_n,
                  prev_un=un, prev_un_right=unr, prev_right_valid=right_valid,
                  prev_time=t_now, next_id=next_id)
    return packet, fields


def track_event_stereo(cfg: TrackerConfig, cam_left: CameraModel,
                       cam_right: CameraModel, state: TrackerState,
                       chunk_left: sae_mod.EventChunk,
                       chunk_right: sae_mod.EventChunk,
                       t_now, ransac_draws=None
                       ) -> Tuple[TrackerState, FeaturePacket]:
    """One event tracker tick.  ransac_draws: optional (K, 8) RANSAC draws
    that replace the ones drawn from the state's key (tests inject JAX's)."""
    C = cfg.cand_capacity
    dtype = state.pts.dtype
    dev = state.pts.device
    t_now = torch.as_tensor(t_now, dtype=dtype, device=dev)

    keys = prng.split(state.key)
    key, k_ransac = keys[0], keys[1]

    # ---- 1. SAE + time surfaces — both cameras as one batch of 2 ----------
    with span("frontend_event.sae"):
        sae_lr = sae_mod.SAEState(
            sae=torch.stack([state.sae_left.sae, state.sae_right.sae]),
            sae_latest=torch.stack([state.sae_left.sae_latest,
                                    state.sae_right.sae_latest]))
        sae_lr, _ = sae_mod.update_sae(
            sae_lr, _stack_chunks(chunk_left, chunk_right),
            cfg.filter_threshold)
        ts_lr = sae_mod.time_surface(sae_lr, t_now, cfg.decay_ms,
                                     cfg.ignore_polarity,
                                     median_blur_ksize=cfg.median_blur_ksize)
        if cfg.equalize:  # CLAHE (feature_tracker.cpp:375-387)
            ts_lr = clahe(ts_lr)
        pyr_lr = pyramid.build_lk_pyramid(ts_lr, cfg.lk_levels)
    sae_l = sae_mod.SAEState(sae=sae_lr.sae[0], sae_latest=sae_lr.sae_latest[0])
    sae_r = sae_mod.SAEState(sae=sae_lr.sae[1], sae_latest=sae_lr.sae_latest[1])
    ts_l = ts_lr[0]
    pyr_l = [(lvl[0][0],) for lvl in pyr_lr]
    pyr_r = [(lvl[0][1],) for lvl in pyr_lr]

    # ---- 2-3. temporal LK + reverse check, FM-RANSAC ----------------------
    with span("frontend_event.temporal"):
        cur, tracked, track_cnt = _track_temporal(cfg, cam_left, state, pyr_l,
                                                  k_ransac, ransac_draws)

    # ---- 4. corner harvest ------------------------------------------------
    with span("frontend_event.corners"):
        corner_ok = cor_mod.detect_corners(sae_l, chunk_left, cfg.min_dist)
        if cfg.use_time_surface_gate and not cfg.ignore_polarity:
            ex = torch.clamp(chunk_left.x.long(), 0, cfg.width - 1)
            ey = torch.clamp(chunk_left.y.long(), 0, cfg.height - 1)
            corner_ok = corner_ok & (ts_l[ey, ex] != TS_LK_THRESHOLD)
        # stable compaction of corner events into C candidate slots (corners
        # first, each group in event order) via top-k over rank keys
        n_ev = corner_ok.shape[0]
        ev_i = torch.arange(n_ev, dtype=torch.float32, device=dev)
        c_key = torch.where(corner_ok, 2.0 * n_ev - ev_i, 1.0 * n_ev - ev_i)
        cand_order = torch.topk(c_key, C).indices
        cand_valid = torch.arange(C, device=dev) \
            < torch.sum(corner_ok.to(torch.int64))

    # ---- 4-6. spacing, compaction, stereo LK, undistortion ----------------
    with span("frontend_event.refill_stereo"):
        packet, fields = _refill_and_stereo(
            cfg, cam_left, cam_right, state, pyr_l, pyr_r, cur, tracked,
            track_cnt, chunk_left.x[cand_order].to(dtype),
            chunk_left.y[cand_order].to(dtype), cand_valid, t_now)
    new_state = TrackerState(sae_left=sae_l, sae_right=sae_r, prev_pyr=pyr_l,
                             key=key, **fields)
    return new_state, packet


# ---------------------------------------------------------------------------
# image (frame) path — trackImage (feature_tracker.cpp:164-338)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ImageTrackerState:
    prev_pyr: list               # left frame LK pyramid, [(img,), ...]
    pts: torch.Tensor            # (F, 2)
    ids: torch.Tensor            # (F,) int32, from id_offset up
    track_cnt: torch.Tensor      # (F,) int32
    valid: torch.Tensor          # (F,) bool
    prev_un: torch.Tensor        # (F, 2)
    prev_un_right: torch.Tensor  # (F, 2)
    prev_right_valid: torch.Tensor  # (F,) bool
    prev_time: torch.Tensor      # () f32
    next_id: torch.Tensor        # () int32
    key: torch.Tensor            # (2,) threefry key for RANSAC


def init_image_state(cfg: TrackerConfig, device="cuda", key=None,
                     dtype=torch.float32,
                     id_offset: int = 1 << 24) -> ImageTrackerState:
    """Image-path state; ids start at id_offset so the event and image
    books never collide."""
    F = cfg.capacity
    zero_img = torch.zeros((cfg.height, cfg.width), dtype=dtype, device=device)
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return ImageTrackerState(
        prev_pyr=pyramid.build_lk_pyramid(zero_img, cfg.lk_levels),
        pts=z(F, 2),
        ids=torch.full((F,), -1, dtype=torch.int32, device=device),
        track_cnt=z(F, dt=torch.int32),
        valid=z(F, dt=torch.bool),
        prev_un=z(F, 2), prev_un_right=z(F, 2),
        prev_right_valid=z(F, dt=torch.bool),
        prev_time=torch.zeros((), dtype=dtype, device=device),
        next_id=torch.tensor(id_offset, dtype=torch.int32, device=device),
        key=key.to(device) if key is not None else prng.PRNGKey(1, device),
    )


def track_image_stereo(cfg: TrackerConfig, cam_left: CameraModel,
                       cam_right: CameraModel, state: ImageTrackerState,
                       img_left, img_right, t_now
                       ) -> Tuple[ImageTrackerState, FeaturePacket]:
    """One frame tick: temporal LK + F-RANSAC, Shi-Tomasi refill, stereo LK
    (trackImage, feature_tracker.cpp:164-338).  Frames are (H, W) at the
    config's size."""
    C = cfg.cand_capacity
    dtype = state.pts.dtype
    dev = state.pts.device
    t_now = torch.as_tensor(t_now, dtype=dtype, device=dev)
    keys = prng.split(state.key)
    key, k_ransac = keys[0], keys[1]

    with span("frontend_image.prep"):
        img_lr = torch.stack([img_left.to(dtype), img_right.to(dtype)])
        if cfg.equalize:  # CLAHE (trackImage, feature_tracker.cpp:656)
            img_lr = clahe(img_lr)
        pyr_lr = pyramid.build_lk_pyramid(img_lr, cfg.lk_levels)
    pyr_l = [(lvl[0][0],) for lvl in pyr_lr]
    pyr_r = [(lvl[0][1],) for lvl in pyr_lr]

    with span("frontend_image.temporal"):
        cur, tracked, track_cnt = _track_temporal(cfg, cam_left, state, pyr_l,
                                                  k_ransac)
    with span("frontend_image.corners"):
        cand_xy, _, cand_ok = detect.shi_tomasi(pyr_l[0][0], max_corners=C,
                                                quality_level=0.01)
    with span("frontend_image.refill_stereo"):
        packet, fields = _refill_and_stereo(
            cfg, cam_left, cam_right, state, pyr_l, pyr_r, cur, tracked,
            track_cnt, cand_xy[:, 0], cand_xy[:, 1], cand_ok, t_now)
    return ImageTrackerState(prev_pyr=pyr_l, key=key, **fields), packet
