"""ESIO / ESVIO pipeline: stereo events (+ stereo frames) + IMU →
trajectory (port of esvio_tpu/apps/pipeline.py).

The in-process replacement for the reference's ROS graph (event tracker ‖
image tracker → estimator → loop closure) with the measurement-sync
semantics of getMeasurements_event_image_imu
(stereo_estimator_node.cpp:115-170) and the stream watchdog → restart
(stereo_event_tracker_node.cpp:163-173, restart_callback :231-252).
Everything numeric runs on the pipeline's `device` (the card unless the
caller asks for the CPU); frames are converted and resized there too.

Options of the configuration: IMU-aided motion correction of the event
chunks (`do_motion_correction`), loop closure with the 4-DoF pose graph
(`loop_closure`, the loop-corrected trajectory in P_loop/Q_loop) and fast
relocalization (`fast_relocalization`: every closed loop is fed back
through the estimator's in-window relo solve).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import esvio_tpu_torch
from esvio_tpu_torch.events.motion import motion_correct_chunk
from esvio_tpu_torch.frontend import tracker as trk
from esvio_tpu_torch.imu.preintegration import make_imu_params
from esvio_tpu_torch.io import datasets as ds
from esvio_tpu_torch.io import trajectory as traj_io
from esvio_tpu_torch.io.config import SystemConfig, extrinsic_arrays
from esvio_tpu_torch.loop.loop_closure import LoopCloser
from esvio_tpu_torch.utils.metrics import Metrics, StageTimer
from esvio_tpu_torch.vio import estimator as est_mod


@dataclasses.dataclass
class PipelineResult:
    stamps: List[float]
    P: List[np.ndarray]
    Q: List[np.ndarray]
    V: List[np.ndarray]
    n_restarts: int = 0
    metrics: Optional[dict] = None
    stage_times: Optional[dict] = None
    # loop-closure corrected trajectory (pose_graph updatePath analog)
    P_loop: Optional[List[np.ndarray]] = None
    Q_loop: Optional[List[np.ndarray]] = None
    n_loops: int = 0
    # IMU-rate low-latency odometry (pubLatestOdometry analog): one sample
    # per IMU message once the estimator is NON_LINEAR
    stamps_hf: Optional[List[float]] = None
    P_hf: Optional[List[np.ndarray]] = None
    Q_hf: Optional[List[np.ndarray]] = None
    V_hf: Optional[List[np.ndarray]] = None

    def ate(self, gt_t, gt_P, alignment="yaw"):
        return traj_io.ate_rmse(np.asarray(self.stamps), np.asarray(self.P),
                                gt_t, gt_P, alignment=alignment)

    def write(self, out_dir):
        """The reference's result files: esvio_result_no_loop.csv/.tum, and
        esvio_result_loop.txt when loop closure ran."""
        os.makedirs(out_dir, exist_ok=True)
        traj_io.write_vio_csv(os.path.join(out_dir, "esvio_result_no_loop.csv"),
                              self.stamps, self.P, self.Q, self.V)
        traj_io.write_tum(os.path.join(out_dir, "esvio_result_no_loop.tum"),
                          self.stamps, self.P, self.Q)
        if self.P_loop:
            traj_io.write_tum(os.path.join(out_dir, "esvio_result_loop.txt"),
                              self.stamps, self.P_loop, self.Q_loop)


def _sync_pairs(it_l, it_r, tol):
    """Pair L/R chunk streams by stamp, dropping unmatched ticks
    (sync_process, stereo_event_tracker_node.cpp:372-419)."""
    l = next(it_l, None)
    r = next(it_r, None)
    while l is not None and r is not None:
        if abs(l[0] - r[0]) <= tol:
            yield l, r
            l = next(it_l, None)
            r = next(it_r, None)
        elif l[0] < r[0]:
            l = next(it_l, None)
        else:
            r = next(it_r, None)


_GRAY = (0.299, 0.587, 0.114)


def prep_frame(frame, height: int, width: int, device):
    """A frame as the image tracker takes it (getImageFromMsg,
    stereo_image_tracker_node.cpp:257-319): float32 on `device`, RGB
    converted to gray, resized bilinearly to (height, width) with
    antialiasing as jax.image.resize(..., "linear") does."""
    f = torch.as_tensor(np.asarray(frame), dtype=torch.float32, device=device)
    if f.ndim == 3:
        f = f @ torch.tensor(_GRAY, dtype=torch.float32, device=device)
    if tuple(f.shape) != (height, width):
        f = F.interpolate(f[None, None], size=(height, width), mode="bilinear",
                          align_corners=False, antialias=True)[0, 0]
    return f


class Pipeline:
    """Host orchestrator of the ESIO (system_mode 0) or ESVIO (1) pipeline
    on one device."""

    def __init__(self, sys_cfg: SystemConfig, cams: dict, device="cuda",
                 tracker_cfg: Optional[trk.TrackerConfig] = None,
                 est_cfg: Optional[est_mod.EstimatorConfig] = None,
                 event_capacity: int = 1 << 16,
                 img_tracker_cfg: Optional[trk.TrackerConfig] = None):
        if sys_cfg.system_mode not in (0, 1):
            raise NotImplementedError(
                f"system_mode {sys_cfg.system_mode} is not a pipeline mode")
        esvio_tpu_torch.disable_tf32()
        self.device = torch.device(device)
        self.sys_cfg = sys_cfg
        self.cams = {k: c.to(self.device) for k, c in cams.items()}
        self.event_capacity = event_capacity
        self.tracker_cfg = tracker_cfg or trk.TrackerConfig(
            width=sys_cfg.event_width, height=sys_cfg.event_height,
            max_cnt=sys_cfg.max_cnt, min_dist=sys_cfg.min_dist,
            f_threshold=sys_cfg.f_threshold, decay_ms=sys_cfg.decay_ms,
            ignore_polarity=sys_cfg.ignore_polarity,
            filter_threshold=sys_cfg.feature_filter_threshold,
            equalize=bool(sys_cfg.equalize),
            median_blur_ksize=int(sys_cfg.median_blur_kernel_size))
        # the image path runs at its own geometry and budgets (image_width/
        # height, max_cnt_img, min_dist_img — parameters.cpp:100,202)
        self.img_tracker_cfg = img_tracker_cfg or trk.TrackerConfig(
            width=sys_cfg.image_width, height=sys_cfg.image_height,
            max_cnt=sys_cfg.max_cnt_img, min_dist=sys_cfg.min_dist_img,
            f_threshold=sys_cfg.f_threshold, equalize=bool(sys_cfg.equalize))
        self.est_cfg = est_cfg or est_mod.EstimatorConfig(
            mode="esio" if sys_cfg.system_mode == 0 else "esvio",
            min_parallax=sys_cfg.keyframe_parallax / 460.0,
            g_norm=sys_cfg.g_norm, solver_iters=sys_cfg.max_num_iterations,
            estimate_extrinsic=sys_cfg.estimate_extrinsic,
            estimate_td=sys_cfg.estimate_td,
            use_stereo_correction=bool(sys_cfg.use_stereo_correction))
        self._imu_params = make_imu_params(
            sys_cfg.acc_n, sys_cfg.gyr_n, sys_cfg.acc_w, sys_cfg.gyr_w,
            sys_cfg.g_norm, dtype=self.est_cfg.dtype, device=self.device)
        self._ex = extrinsic_arrays(sys_cfg)
        self._tick = 0
        self.loop_closer = None
        self.sequence = 0   # incremented on restart (new_sequence analog)
        # loop keyframes come from the left frame (ESVIO) or the left event
        # camera's time surface (ESIO)
        self._loop_cam = self.cams.get("cam0" if sys_cfg.system_mode == 1
                                       else "event0")
        if sys_cfg.loop_closure:
            self.loop_closer = LoopCloser(cam=self._loop_cam, device=self.device)
        self._reset(new_sequence=False)

    def load_pose_graph(self, path):
        """Resume a saved pose graph (load_previous_pose_graph,
        pose_graph_node.cpp:589-597): this session continues as a new
        sequence that fuses into the loaded map on its first loop."""
        if self.loop_closer is None:
            raise ValueError("loop closure is off in this configuration")
        self.loop_closer = LoopCloser.load(path, cfg=self.loop_closer.cfg,
                                           cam=self._loop_cam, device=self.device)
        db = self.loop_closer.db
        self.sequence = int(db.sequence[:db.count].max(initial=0)) + 1

    def save_pose_graph(self, path):
        if self.loop_closer is None:
            raise ValueError("loop closure is off in this configuration")
        self.loop_closer.save(path)

    def _reset(self, new_sequence=True):
        if new_sequence:
            self.sequence += 1   # restart ⇒ new map sequence (pose_graph_node:79)
        self.tracker_state = trk.init_state(self.tracker_cfg, self.device)
        if self.sys_cfg.system_mode == 1:
            self.img_tracker_state = trk.init_image_state(self.img_tracker_cfg,
                                                          self.device)
        self.estimator = est_mod.Estimator(self.est_cfg, *self._ex, self.device,
                                           imu_params=self._imu_params)
        self._last_event_time = None
        self._last_img_idx = -1
        self._last_v = None
        self._prev_v = None
        self._pending_kf = None   # loop keyframe begun, not yet committed

    def run(self, seq: ds.SequenceData,
            max_frames: Optional[int] = None) -> PipelineResult:
        """Drive the pipeline over a sequence.  The front end runs one tick
        ahead of the estimator (tick k+1's tracker work is queued before
        tick k's estimator stage), as in the JAX pipeline; motion
        correction therefore takes the estimator's velocity of an earlier
        tick, as the reference's asynchronous odometry feedback
        (stereo_event_tracker_node.cpp:102-107)."""
        cfg = self.sys_cfg
        freq = cfg.freq
        res = PipelineResult([], [], [], [])
        tim = StageTimer(self.device)
        met = Metrics()
        chunks_l = ds.iterate_chunks(seq.events_left, freq, self.event_capacity,
                                     self.device)
        chunks_r = ds.iterate_chunks(seq.events_right, freq, self.event_capacity,
                                     self.device)
        cam_el = self.cams["event0"]
        cam_er = self.cams["event1"]
        self._img_idx = 0
        prev_t = None
        n = 0
        pending = None
        for (t_l, ch_l), (t_r, ch_r) in _sync_pairs(iter(chunks_l),
                                                    iter(chunks_r), 0.5 / freq):
            t = t_l
            # stream watchdog: gap > 1 s or time going backwards → restart
            if self._last_event_time is not None and \
                    (t - self._last_event_time > 1.0
                     or t < self._last_event_time - 1e-9):
                if pending is not None:
                    self._estimator_stage(pending, seq, res, tim, met)
                    pending = None
                if self._pending_kf is not None:
                    # the pre-gap keyframe is still valid map data
                    self.loop_closer.commit_keyframe(self._pending_kf)
                res.n_restarts += 1
                self._reset()
                prev_t = None
            self._last_event_time = t
            met.count("events", float(ch_l.n_host) + float(ch_r.n_host))

            # IMU-aided motion compensation (Do_motion_correction) with the
            # mean IMU sample of the last 1/freq s
            if cfg.do_motion_correction and seq.imu is not None \
                    and self._last_v is not None:
                ts_i, accs_i, gyrs_i = ds.imu_between(seq.imu, t - 1.0 / freq, t)
                if len(ts_i):
                    ch_l, ch_r = (motion_correct_chunk(
                        ch, cc.fx, cc.fy, cc.cx, cc.cy, gyrs_i.mean(0),
                        self._last_v, self._prev_v, accs_i.mean(0),
                        t - 1.0 / freq, width=cfg.event_width,
                        height=cfg.event_height)
                        for ch, cc in ((ch_l, cam_el), (ch_r, cam_er)))

            with tim("frontend_event"):
                self.tracker_state, pkt_evt = trk.track_event_stereo(
                    self.tracker_cfg, cam_el, cam_er, self.tracker_state,
                    ch_l, ch_r, t)
            pkt_img = self._image_frontend(seq, t, tim)
            if pending is not None:
                self._estimator_stage(pending, seq, res, tim, met)
            pending = (prev_t, t, pkt_evt, pkt_img, self._img_idx)
            prev_t = t
            n += 1
            if max_frames and n >= max_frames:
                break
        if pending is not None:
            self._estimator_stage(pending, seq, res, tim, met)
        if self.loop_closer is not None:
            if self._pending_kf is not None:
                self._commit_keyframe(res, met)
            self.loop_closer.flush()   # run any cadence-pending 4-DoF solve
            self._rebuild_loop_path(res)
        res.metrics = met.summary()
        res.stage_times = tim.report()
        return res

    def _commit_keyframe(self, res, met):
        """Commit the pending loop keyframe; returns the loop info when it
        closed a loop."""
        info = self.loop_closer.commit_keyframe(self._pending_kf)
        self._pending_kf = None
        if info is not None:
            met.count("loops")
            res.n_loops += 1
        return info

    def _rebuild_loop_path(self, res):
        """Rewrite the loop-corrected trajectory from the final pose-graph
        state (updatePath, pose_graph.cpp:588-702): ticks that are
        keyframes take their optimized pose, the others the final drift
        applied to their VIO pose."""
        lc = self.loop_closer
        if res.P_loop is None or not res.stamps or not lc.loops:
            return   # no loop ⇒ the drift is identity, corrected == raw
        db = lc.db
        kf_of = {float(db.stamp[i]): i for i in range(db.count)}
        for k, t in enumerate(res.stamps):
            i = kf_of.get(float(t))
            if i is not None:
                res.P_loop[k] = db.t_opt[i].copy()
                res.Q_loop[k] = db.q_opt[i].copy()
            else:
                res.P_loop[k], res.Q_loop[k] = lc.correct_odometry(res.P[k],
                                                                   res.Q[k])

    def _image_frontend(self, seq, t, tim):
        """Pair the tick with the latest frame ≤ t and track it
        (sync_process semantics): each frame is consumed once and stamped
        with its own time.  None when the tick brings no new frame."""
        imgs = seq.images_left
        if self.sys_cfg.system_mode != 1 or imgs is None:
            return None
        stamps = imgs[0]
        while self._img_idx + 1 < len(stamps) and stamps[self._img_idx + 1] <= t:
            self._img_idx += 1
        if not (stamps[self._img_idx] <= t
                and self._img_idx != self._last_img_idx):
            return None
        self._last_img_idx = k = self._img_idx
        cfg = self.img_tracker_cfg
        with tim("frontend_image"):
            frame_l = prep_frame(imgs[1][k], cfg.height, cfg.width, self.device)
            frame_r = prep_frame(seq.images_right[1][k], cfg.height, cfg.width,
                                 self.device)
            self.img_tracker_state, pkt_img = trk.track_image_stereo(
                cfg, self.cams["cam0"], self.cams["cam1"],
                self.img_tracker_state, frame_l, frame_r, float(stamps[k]))
        return pkt_img

    def _estimator_stage(self, stage, seq, res, tim, met):
        """Back end for one tick: IMU feed + IMU-rate prediction, window
        solve, loop closure, output recording."""
        cfg = self.sys_cfg
        prev_t, t, pkt_evt, pkt_img, img_idx = stage
        if prev_t is not None and seq.imu is not None:
            ts, accs, gyrs = ds.imu_between(seq.imu, prev_t, t)
            if len(ts):
                P_hf, Q_hf, V_hf = self.estimator.process_imu_and_predict(
                    ts, accs, gyrs, prev_t)
                if self.estimator.solver_flag == "NON_LINEAR":
                    if res.stamps_hf is None:
                        res.stamps_hf, res.P_hf, res.Q_hf, res.V_hf = [], [], [], []
                    res.stamps_hf.extend(float(x) for x in ts)
                    res.P_hf.extend(P_hf)
                    res.Q_hf.extend(Q_hf)
                    res.V_hf.extend(V_hf)
        with tim("estimator"):
            out = self.estimator.process_packets(t, pkt_evt, pkt_img)
        self.estimator.update_latest()

        # ---- loop closure (pose_graph node analog) -------------------------
        # commit last tick's keyframe first: its device work and its copy to
        # the host overlapped the tick in between
        lc = self.loop_closer
        if lc is not None and self._pending_kf is not None:
            with tim("loop_closure"):
                info = self._commit_keyframe(res, met)
            if info is not None and cfg.fast_relocalization:
                self.estimator.set_relo_frame(
                    info["stamp_new"], info["match_ids"], info["match_un_old"],
                    info["t_old"], info["q_old"])
        if lc is not None and out.keyframe is not None \
                and out.solver_flag == "NON_LINEAR":
            kf = out.keyframe
            # BRIEF source image: the raw left frame in ESVIO, the left time
            # surface in ESIO (pose_graph subscribes the left image topic)
            if cfg.system_mode == 1 and seq.images_left is not None:
                icfg = self.img_tracker_cfg
                loop_img = prep_frame(seq.images_left[1][img_idx], icfg.height,
                                      icfg.width, self.device)
            else:
                loop_img = self.tracker_state.prev_pyr[0][0]
            with tim("loop_closure"):
                self._pending_kf = lc.begin_keyframe(
                    kf["stamp"], kf["P"], kf["Q"], kf["pts_w"], kf["un"],
                    np.ones(len(kf["un"]), bool), loop_img, ids=kf["ids"],
                    sequence=self.sequence, uv_is_normalized=True)
        # fast-reloc drift feedback: the window-refined loop edge replaces
        # the PnP edge and updates the drift at once (relo_relative_pose →
        # updateKeyFrameLoop, pose_graph.cpp:887-933)
        if lc is not None and out.relo is not None and cfg.fast_relocalization:
            lc.update_loop(out.relo["stamp"], out.relo["relative_t"],
                           out.relo["relative_q"], out.relo["relative_yaw"])
        met.count("ticks")
        if out.n_tracked is not None:
            met.observe("tracked_features", float(out.n_tracked))
        met.gauge("lanes_dropped", float(self.estimator.lanes_dropped))
        met.gauge("solver_flag_nonlinear",
                  1.0 if out.solver_flag == "NON_LINEAR" else 0.0)
        self._tick += 1
        self._prev_v = self._last_v if self._last_v is not None else out.V
        self._last_v = out.V
        if out.solver_flag == "NON_LINEAR":
            res.stamps.append(t)
            res.P.append(out.P)
            res.Q.append(out.Q)
            res.V.append(out.V)
            if lc is not None:
                if res.P_loop is None:
                    res.P_loop, res.Q_loop = [], []
                t_c, q_c = lc.correct_odometry(out.P, out.Q)
                res.P_loop.append(t_c)
                res.Q_loop.append(q_c)
