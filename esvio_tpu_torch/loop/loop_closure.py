"""Loop-closure orchestrator: keyframes → detection → verification → 4-DoF
graph (port of esvio_tpu/loop/loop_closure.py; pose_graph_node +
PoseGraph::addKeyFrame/KeyFrame::findConnection, pose_graph.cpp:53-240,
keyframe.cpp:319-563).

Descriptors, FAST corners, BRIEF matching, PnP-RANSAC and the 4-DoF solve
run on the closer's device; the keyframe database and the bookkeeping are
numpy on the host.  Drift (r_drift/t_drift) is re-applied to newer
keyframes and corrects incoming VIO odometry (pose_graph_node.cpp:241-318).
"""
from __future__ import annotations

import dataclasses
import functools
import pickle
from typing import Optional

import numpy as np
import torch

from esvio_tpu_torch.core import camera, lie_np, prng
from esvio_tpu_torch.init import pnp
from esvio_tpu_torch.loop import brief, fast, keyframe_db, pose_graph

MIN_LOOP_NUM = 15       # keyframe.h:18
MAX_YAW_DEG = 30.0      # keyframe.cpp:523
MAX_DIST_M = 20.0


def _loop_features(img, win_uv, win_valid, cam, *, threshold: int,
                   max_corners: int, uv_is_normalized: bool = False):
    """The device work of keyframe construction: BRIEF at the window points
    (computeWindowBRIEFPoint), FAST + BRIEF + the ray lift of the retrieval
    and PnP point set (computeBRIEFPoint, keyframe.cpp:116-161).

    uv_is_normalized: win_uv holds normalized image-plane coordinates (the
    estimator's keyframe packet), projected to pixels here."""
    if uv_is_normalized:
        win_uv = camera.space_to_plane(
            cam, torch.cat([win_uv, torch.ones_like(win_uv[..., :1])], dim=-1))
    sm = brief.smooth(img)
    xy, _score, ok = fast.detect_fast(img, threshold, max_corners)
    out = dict(win_desc=brief.describe_smoothed(sm, win_uv, win_valid), xy=xy,
               ok=ok, ext_desc=brief.describe_smoothed(sm, xy, ok))
    if cam is not None:
        out["rays"] = camera.lift_projective(cam, xy)
    return out


@dataclasses.dataclass
class LoopConfig:
    fast_threshold: int = 20
    max_extra_corners: int = 512
    hamming_max: int = 80
    pnp_threshold: float = 10.0 / 460.0
    pnp_hypotheses: int = 100
    graph_iters: int = 5
    graph_capacity: int = 2048     # starting DB size — grows unbounded
    loop_capacity: int = 256       # starting loop-edge padding — grows
    skip_recent: int = 50
    # 4-DoF solve cadence: the reference optimizes on a 2 s thread
    # (pose_graph.cpp:423-433), not per accepted loop.  Here: run the solve
    # at most every `optimize_cadence` registered keyframes once a loop is
    # pending (the first loop optimizes immediately); `flush()` forces it.
    optimize_cadence: int = 5
    # above this many graph nodes the dense (4K)² solve gives way to the
    # matrix-free CG solve (pose_graph.optimize_4dof_cg)
    dense_solve_max: int = 512
    cg_iters: int = 100
    # node-level keyframe throttles (pose_graph_node.cpp:345-375): skip the
    # first N keyframes, keep 1-in-(skip_cnt+1), require ≥ skip_dis metres
    # of travel between registered keyframes
    skip_first_cnt: int = 0
    skip_cnt: int = 0
    skip_dis: float = 0.0


class LoopCloser:
    """Pose-graph node on one device (the card unless the caller asks for
    the CPU); `cam` is the keyframe image's camera (None: pixel
    coordinates serve as the normalized ones)."""

    def __init__(self, cfg: LoopConfig = LoopConfig(), cam=None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.cam = cam.to(self.device) if cam is not None else None
        self.db = keyframe_db.KeyFrameDB(capacity=cfg.graph_capacity,
                                         n_extra=cfg.max_extra_corners,
                                         skip_recent=cfg.skip_recent)
        self.loops = []           # dicts of i_old, j_new, rel_t, rel_yaw, ...
        self.r_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.key = prng.PRNGKey(7, self.device)
        self.first_loop_idx: Optional[int] = None
        self.kf_ids = []          # per-KF feature ids of the window points
        # inter-sequence/map fusion shift applied to incoming VIO poses
        # (w_r_vio/w_t_vio, pose_graph.cpp:72-73,124-145)
        self.w_r_vio = np.eye(3)
        self.w_t_vio = np.zeros(3)
        self._fused_sequences = {0}   # sequences already in the world frame
        self._n_seen = 0              # keyframe throttle counters
        self._n_since_kept = 0
        self._last_kept_P = None
        self._opt_pending = False     # loops accepted since the last solve
        self._kfs_since_opt = 0
        self.n_optimize = 0

    def _t(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    # ------------------------------------------------------------------ add
    def begin_keyframe(self, stamp, t_w, q_w, win_pts_w, win_uv, win_valid,
                       image, sequence=0, ids=None,
                       uv_is_normalized=False) -> Optional[dict]:
        """Queue the device half of keyframe registration (descriptors, FAST
        corners, ray lifts) and start its copy to the host without waiting;
        returns a pending handle for commit_keyframe, or None when the node
        throttles drop the frame.  The pipeline commits the handle one tick
        later, so the device work and the copy hide under that tick (the
        pose-graph node is an asynchronous process in the reference,
        pose_graph_node.cpp:333-473)."""
        self._n_seen += 1
        if self._n_seen <= self.cfg.skip_first_cnt:
            return None
        self._n_since_kept += 1
        if self._n_since_kept <= self.cfg.skip_cnt:
            return None
        if self._last_kept_P is not None and self.cfg.skip_dis > 0 and \
                np.linalg.norm(np.asarray(t_w) - self._last_kept_P) \
                < self.cfg.skip_dis:
            return None
        self._n_since_kept = 0
        self._last_kept_P = np.asarray(t_w, float).copy()

        # pad the window point set to the DB lane width (fixed shapes)
        nw = self.db.n_window
        n = min(len(win_uv), nw)
        uvp = np.zeros((nw, 2), np.float32)
        vp = np.zeros(nw, bool)
        uvp[:n] = np.asarray(win_uv, np.float32)[:n]
        vp[:n] = np.asarray(win_valid)[:n]

        feats = _loop_features(
            self._t(image) if not torch.is_tensor(image)
            else image.to(self.device, torch.float32),
            self._t(uvp), self._t(vp, torch.bool), self.cam,
            threshold=self.cfg.fast_threshold,
            max_corners=self.cfg.max_extra_corners,
            uv_is_normalized=uv_is_normalized)
        ready = None
        if self.device.type == "cuda":
            # non-blocking copies into pinned host memory, awaited at commit
            feats = {k: v.to("cpu", non_blocking=True) for k, v in feats.items()}
            ready = torch.cuda.Event()
            ready.record()
        return dict(feats=feats, ready=ready, stamp=stamp,
                    t_w=np.asarray(t_w, float), q_w=np.asarray(q_w, float),
                    win_pts_w=np.asarray(win_pts_w, float),
                    win_valid=vp, sequence=sequence, ids=ids)

    def commit_keyframe(self, pending) -> Optional[dict]:
        """Finish registering a keyframe begun with begin_keyframe: take the
        device results, add to the database, run retrieval + verification;
        returns the loop info dict when a loop closes."""
        sequence = pending["sequence"]
        ids = pending["ids"]

        # map the incoming VIO pose into the fused world frame
        # (addKeyFrame entry, pose_graph.cpp:70-75)
        t_w = self.w_r_vio @ pending["t_w"] + self.w_t_vio
        q_w = lie_np.rot_to_quat(self.w_r_vio @ lie_np.quat_to_rot(pending["q_w"]))
        win_pts_w = (self.w_r_vio @ pending["win_pts_w"].T).T + self.w_t_vio

        if pending["ready"] is not None:
            pending["ready"].synchronize()
        got = {k: v.numpy() for k, v in pending["feats"].items()}
        xy, ext_desc, ok = got["xy"], got["ext_desc"], got["ok"]
        if self.cam is not None:
            ext_un = got["rays"][:, :2] / got["rays"][:, 2:]
        else:
            ext_un = xy

        idx = self.db.add(pending["stamp"], t_w, q_w, win_pts_w,
                          np.zeros((len(win_pts_w), 2)), got["win_desc"],
                          pending["win_valid"], ext_un, ext_desc, ok, sequence)
        # the current drift applies to every incoming keyframe's optimized
        # pose (addKeyFrame: P = r_drift*P + t_drift, pose_graph.cpp:76-80)
        self.db.t_opt[idx] = self.r_drift @ self.db.t_vio[idx] + self.t_drift
        self.db.q_opt[idx] = lie_np.rot_to_quat(
            self.r_drift @ lie_np.quat_to_rot(self.db.q_vio[idx]))
        self.kf_ids.append(np.asarray(ids, np.int32) if ids is not None
                           else np.full(len(win_pts_w), -1, np.int32))

        self._kfs_since_opt += 1
        cand = self.db.query(idx)
        if cand is None:
            # a pending solve still runs on cadence without a new loop
            if self._opt_pending and \
                    self._kfs_since_opt >= self.cfg.optimize_cadence:
                self._optimize()
            return None
        info = self._find_connection(idx, cand)
        if info is None:
            return None
        # inter-sequence / loaded-map fusion: the first loop from a sequence
        # not yet in the world frame shifts that whole sequence
        # (pose_graph.cpp:124-145)
        if sequence not in self._fused_sequences:
            self._apply_sequence_shift(idx, cand, info, sequence)
        self.db.has_loop[idx] = True
        self.db.loop_target[idx] = cand
        self.loops.append(info)
        first_ever = self.first_loop_idx is None
        if first_ever or info["i_old"] < self.first_loop_idx:
            self.first_loop_idx = info["i_old"]
        # cadence scheduling (reference: 2 s optimize4DoF thread)
        self._opt_pending = True
        if first_ever or self._kfs_since_opt >= self.cfg.optimize_cadence:
            self._optimize()
        return info

    def add_keyframe(self, stamp, t_w, q_w, win_pts_w, win_uv, win_valid,
                     image, sequence=0, ids=None) -> Optional[dict]:
        """Synchronous begin + commit.  win_pts_w: (P, 3) world landmarks of
        the sliding window seen by this keyframe; win_uv: (P, 2) their pixel
        coordinates in `image`."""
        pending = self.begin_keyframe(stamp, t_w, q_w, win_pts_w, win_uv,
                                      win_valid, image, sequence, ids)
        if pending is None:
            return None
        return self.commit_keyframe(pending)

    def flush(self):
        """Run any pending 4-DoF solve (end of sequence / shutdown)."""
        if self._opt_pending:
            self._optimize()

    def update_loop(self, stamp_new, rel_t, rel_q, rel_yaw):
        """Replace a loop edge with the estimator's window-refined relative
        pose and update the drift at once (updateKeyFrameLoop,
        pose_graph.cpp:887-933): the fast-relocalization feedback."""
        info = None
        for cand in reversed(self.loops):
            if abs(cand["stamp_new"] - stamp_new) < 1e-6:
                info = cand
                break
        if info is None:
            return
        rel_t = np.asarray(rel_t, float)
        rel_R = lie_np.quat_to_rot(np.asarray(rel_q, float))
        rel_yaw = float(rel_yaw)
        # gate identical to the acceptance gate (pose_graph.cpp:891)
        if abs(rel_yaw) > MAX_YAW_DEG or np.linalg.norm(rel_t) > MAX_DIST_M:
            return
        info["rel_t"] = rel_t
        info["rel_R"] = rel_R
        info["rel_yaw"] = rel_yaw
        db = self.db
        i_old, j_new = info["i_old"], info["j_new"]
        # instant drift from the refined edge (pose_graph.cpp:894-920):
        # w_T_cur = w_T_old ∘ rel, then
        # shift_t = w_P_cur − w_R_cur·vio_R_curᵀ·vio_P_cur
        R_old = lie_np.quat_to_rot(db.q_opt[i_old])
        w_P_cur = R_old @ rel_t + db.t_opt[i_old]
        w_R_cur = R_old @ rel_R
        vio_R = lie_np.quat_to_rot(db.q_vio[j_new])
        shift_yaw = lie_np.rot_to_ypr(w_R_cur)[0] - lie_np.rot_to_ypr(vio_R)[0]
        self.r_drift = lie_np.ypr_to_rot([shift_yaw, 0.0, 0.0])
        self.t_drift = w_P_cur - w_R_cur @ vio_R.T @ db.t_vio[j_new]
        self._opt_pending = True

    # ---------------------------------------------------------- verification
    def _find_connection(self, j_new: int, i_old: int) -> Optional[dict]:
        """BRIEF match + PnP-RANSAC + geometric gates (findConnection)."""
        cfg = self.cfg
        dbw = self.db
        # match the new window descriptors to the old keyframe's FAST ones
        idx, ok = brief.match(
            self._t(dbw.win_desc[j_new], torch.int8),
            self._t(dbw.win_valid[j_new], torch.bool),
            self._t(dbw.ext_desc[i_old], torch.int8),
            self._t(dbw.ext_valid[i_old], torch.bool), cfg.hamming_max)
        idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
        if ok.sum() < MIN_LOOP_NUM:
            return None

        pts_w = dbw.win_pts[j_new]           # 3D in world
        obs_old = dbw.ext_un[i_old][idx]     # matched normalized obs, old KF

        # seed with the old keyframe pose: PnP solves the old camera pose
        R_old = lie_np.quat_to_rot(dbw.q_vio[i_old])
        self.key, k = prng.split(self.key)
        R, t, inl = pnp.pnp_ransac(
            k, self._t(pts_w), self._t(obs_old), self._t(ok, torch.bool),
            self._t(R_old.T), self._t(dbw.t_vio[i_old]), cfg.pnp_threshold,
            cfg.pnp_hypotheses)
        R, t, inl = (v.cpu().numpy() for v in (R, t, inl))
        n_inl = int(inl.sum())
        if n_inl < MIN_LOOP_NUM:
            return None

        # relative pose: old (PnP, world frame) vs new (VIO)
        R_w_old = R.astype(float).T
        t_w_old = t.astype(float)
        R_new = lie_np.quat_to_rot(dbw.q_vio[j_new])
        rel_t = R_w_old.T @ (dbw.t_vio[j_new] - t_w_old)
        rel_R = R_w_old.T @ R_new
        rel_yaw = float(lie_np.rot_to_ypr(rel_R)[0])
        if abs(rel_yaw) > MAX_YAW_DEG or np.linalg.norm(rel_t) > MAX_DIST_M:
            return None

        # fast-relocalization payload (keyframe.cpp:531-557): matched window
        # feature ids of the NEW keyframe, their normalized observations in
        # the OLD keyframe, and the old keyframe's optimized pose
        win_lanes = np.nonzero(ok & inl)[0]
        match_ids = self.kf_ids[j_new][win_lanes] \
            if j_new < len(self.kf_ids) else np.full(len(win_lanes), -1)
        return dict(i_old=i_old, j_new=j_new, rel_t=rel_t, rel_yaw=rel_yaw,
                    rel_R=rel_R, n_inliers=n_inl,
                    stamp_new=float(dbw.stamp[j_new]),
                    match_ids=match_ids,
                    match_un_old=obs_old[win_lanes],
                    t_old=dbw.t_opt[i_old].copy(),
                    q_old=dbw.q_opt[i_old].copy())

    # --------------------------------------------------------- map fusion
    def _apply_sequence_shift(self, j_new, i_old, info, sequence):
        """First loop from an unfused sequence: yaw + translation shift of
        the whole sequence into the world frame (pose_graph.cpp:124-145,
        new_sequence pose_graph_node.cpp:79-103)."""
        db = self.db
        R_old = lie_np.quat_to_rot(db.q_vio[i_old])
        w_R_cur = R_old @ info["rel_R"]
        w_P_cur = R_old @ info["rel_t"] + db.t_vio[i_old]
        vio_R_cur = lie_np.quat_to_rot(db.q_vio[j_new])
        yaw_w = float(lie_np.rot_to_ypr(w_R_cur)[0])
        yaw_v = float(lie_np.rot_to_ypr(vio_R_cur)[0])
        shift_r = lie_np.ypr_to_rot([yaw_w - yaw_v, 0.0, 0.0])
        shift_t = w_P_cur - shift_r @ db.t_vio[j_new]
        self.w_r_vio = shift_r
        self.w_t_vio = shift_t
        for j in np.nonzero(db.sequence[:db.count] == sequence)[0]:
            db.t_vio[j] = shift_r @ db.t_vio[j] + shift_t
            db.q_vio[j] = lie_np.rot_to_quat(
                shift_r @ lie_np.quat_to_rot(db.q_vio[j]))
            db.t_opt[j] = db.t_vio[j]
            db.q_opt[j] = db.q_vio[j]
            db.win_pts[j] = db.win_pts[j] @ shift_r.T + shift_t
        self._fused_sequences.add(sequence)

    # ------------------------------------------------------------ persistence
    def save(self, path):
        """Persist the whole pose-graph state: keyframe arrays + loops,
        drift, fusion shift, feature ids (savePoseGraph,
        pose_graph.cpp:705-760)."""
        self.db.save(path)
        meta = dict(
            loops=self.loops, r_drift=self.r_drift, t_drift=self.t_drift,
            first_loop_idx=self.first_loop_idx, w_r_vio=self.w_r_vio,
            w_t_vio=self.w_t_vio,
            fused_sequences=sorted(self._fused_sequences),
            kf_ids=self.kf_ids)
        with open(str(path) + ".meta.pkl", "wb") as f:
            pickle.dump(meta, f)

    @classmethod
    def load(cls, path, cfg: LoopConfig = LoopConfig(), cam=None,
             device="cuda") -> "LoopCloser":
        """Reload a saved pose graph for multi-session reuse (loadPoseGraph
        + load_previous_pose_graph, pose_graph_node.cpp:589-597): later
        sequences fuse into it on their first loop."""
        lc = cls(cfg=cfg, cam=cam, device=device)
        lc.db = keyframe_db.KeyFrameDB.load(path, skip_recent=cfg.skip_recent)
        with open(str(path) + ".meta.pkl", "rb") as f:
            meta = pickle.load(f)
        lc.loops = meta["loops"]
        lc.r_drift = meta["r_drift"]
        lc.t_drift = meta["t_drift"]
        lc.first_loop_idx = meta["first_loop_idx"]
        lc.w_r_vio = meta["w_r_vio"]
        lc.w_t_vio = meta["w_t_vio"]
        lc._fused_sequences = set(meta["fused_sequences"])
        lc.kf_ids = meta["kf_ids"]
        return lc

    # ------------------------------------------------------------- 4-DoF opt
    def _optimize(self):
        """The 4-DoF solve over all keyframes, in float32 as the JAX
        package runs it (its float64 host arrays become float32 arrays
        without x64)."""
        db = self.db
        n = db.count
        # node count padded to the next power of two (fixed shapes)
        K = max(64, 1 << (n - 1).bit_length())
        # measurements and initial values both come from the VIO poses, as
        # in optimize4DoF (pose_graph.cpp:463-495 uses getVioPose)
        ypr = np.stack([lie_np.rot_to_ypr(lie_np.quat_to_rot(q))
                        for q in db.q_vio[:n]])
        yaw = np.zeros(K)
        pitch = np.zeros(K)
        roll = np.zeros(K)
        t = np.zeros((K, 3))
        yaw[:n], pitch[:n], roll[:n] = ypr[:, 0], ypr[:, 1], ypr[:, 2]
        t[:n] = db.t_vio[:n]

        # loop-edge padding grows with the trajectory (power-of-two shapes)
        E = max(self.cfg.loop_capacity,
                1 << max(len(self.loops) - 1, 0).bit_length())
        li = np.zeros(E, np.int64)
        lj = np.zeros(E, np.int64)
        lt = np.zeros((E, 3))
        ly = np.zeros(E)
        lv = np.zeros(E, bool)
        for k, info in enumerate(self.loops):
            li[k], lj[k] = info["i_old"], info["j_new"]
            lt[k], ly[k] = info["rel_t"], info["rel_yaw"]
            lv[k] = True

        # dense solve for small graphs; matrix-free PCG (O(K + E) memory)
        # once the trajectory outgrows it
        solve = pose_graph.optimize_4dof if K <= self.cfg.dense_solve_max \
            else functools.partial(pose_graph.optimize_4dof_cg,
                                   cg_iters=self.cfg.cg_iters)
        i64 = torch.int64
        yaw_o, t_o = solve(
            self._t(yaw), self._t(t), self._t(pitch), self._t(roll),
            self._t(np.arange(K) < n, torch.bool),
            self._t(self.first_loop_idx or 0, i64), self._t(li, i64),
            self._t(lj, i64), self._t(lt), self._t(ly), self._t(lv, torch.bool),
            iters=self.cfg.graph_iters)
        yaw_o = yaw_o.cpu().numpy().astype(float)[:n]
        t_o = t_o.cpu().numpy().astype(float)[:n]
        self.n_optimize += 1

        # write back the optimized poses; pitch/roll stay from VIO
        for i in range(n):
            db.q_opt[i] = lie_np.rot_to_quat(
                lie_np.ypr_to_rot([yaw_o[i], pitch[i], roll[i]]))
            db.t_opt[i] = t_o[i]

        # drift of the newest optimized keyframe vs its VIO pose
        # (pose_graph.cpp:541-578)
        last = n - 1
        ypr_vio = lie_np.rot_to_ypr(lie_np.quat_to_rot(db.q_vio[last]))
        self.r_drift = lie_np.ypr_to_rot([yaw_o[last] - ypr_vio[0], 0.0, 0.0])
        self.t_drift = db.t_opt[last] - self.r_drift @ db.t_vio[last]
        # reset the cadence schedule
        self._opt_pending = False
        self._kfs_since_opt = 0

    def correct_odometry(self, t_w, q_w):
        """Apply the sequence shift and the loop drift to an incoming VIO
        pose (vio_callback, pose_graph_node.cpp:241-318: w_r_vio/w_t_vio
        first, then r_drift/t_drift)."""
        R = lie_np.quat_to_rot(q_w)
        t_v = self.w_r_vio @ np.asarray(t_w) + self.w_t_vio
        t_c = self.r_drift @ t_v + self.t_drift
        return t_c, lie_np.rot_to_quat(self.r_drift @ (self.w_r_vio @ R))
