"""ESIO / ESVIO pipeline: stereo events (+ stereo frames) + IMU →
trajectory (port of esvio_tpu/apps/pipeline.py).

The in-process replacement for the reference's ROS graph (event tracker ‖
image tracker → estimator) with the measurement-sync semantics of
getMeasurements_event_image_imu (stereo_estimator_node.cpp:115-170) and
the stream watchdog → restart (stereo_event_tracker_node.cpp:163-173,
restart_callback :231-252).  Everything numeric runs on the pipeline's
`device` (the card unless the caller asks for the CPU); frames are
converted and resized there too.

Not ported yet: IMU-aided motion correction and loop closure — a
configuration that asks for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import esvio_tpu_torch
from esvio_tpu_torch.frontend import tracker as trk
from esvio_tpu_torch.imu.preintegration import make_imu_params
from esvio_tpu_torch.io import datasets as ds
from esvio_tpu_torch.io import trajectory as traj_io
from esvio_tpu_torch.io.config import SystemConfig, extrinsic_arrays
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
    # IMU-rate low-latency odometry (pubLatestOdometry analog): one sample
    # per IMU message once the estimator is NON_LINEAR
    stamps_hf: Optional[List[float]] = None
    P_hf: Optional[List[np.ndarray]] = None
    Q_hf: Optional[List[np.ndarray]] = None
    V_hf: Optional[List[np.ndarray]] = None

    def ate(self, gt_t, gt_P, alignment="yaw"):
        return traj_io.ate_rmse(np.asarray(self.stamps), np.asarray(self.P),
                                gt_t, gt_P, alignment=alignment)


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
        if sys_cfg.loop_closure:
            raise NotImplementedError("loop closure is not ported")
        if sys_cfg.do_motion_correction:
            raise NotImplementedError("motion correction is not ported")
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
        self._reset()

    def _reset(self):
        self.tracker_state = trk.init_state(self.tracker_cfg, self.device)
        if self.sys_cfg.system_mode == 1:
            self.img_tracker_state = trk.init_image_state(self.img_tracker_cfg,
                                                          self.device)
        self.estimator = est_mod.Estimator(self.est_cfg, *self._ex, self.device,
                                           imu_params=self._imu_params)
        self._last_event_time = None
        self._last_img_idx = -1

    def run(self, seq: ds.SequenceData,
            max_frames: Optional[int] = None) -> PipelineResult:
        """Drive the pipeline over a sequence.  The front end runs one tick
        ahead of the estimator (tick k+1's tracker work is queued before
        tick k's estimator stage), as in the JAX pipeline."""
        freq = self.sys_cfg.freq
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
                res.n_restarts += 1
                self._reset()
                prev_t = None
            self._last_event_time = t
            met.count("events", float(ch_l.n_host) + float(ch_r.n_host))

            with tim("frontend_event"):
                self.tracker_state, pkt_evt = trk.track_event_stereo(
                    self.tracker_cfg, cam_el, cam_er, self.tracker_state,
                    ch_l, ch_r, t)
            pkt_img = self._image_frontend(seq, t, tim)
            if pending is not None:
                self._estimator_stage(pending, seq, res, tim, met)
            pending = (prev_t, t, pkt_evt, pkt_img)
            prev_t = t
            n += 1
            if max_frames and n >= max_frames:
                break
        if pending is not None:
            self._estimator_stage(pending, seq, res, tim, met)
        res.metrics = met.summary()
        res.stage_times = tim.report()
        return res

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
        solve, output recording."""
        prev_t, t, pkt_evt, pkt_img = stage
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
        met.count("ticks")
        if out.n_tracked is not None:
            met.observe("tracked_features", float(out.n_tracked))
        met.gauge("lanes_dropped", float(self.estimator.lanes_dropped))
        met.gauge("solver_flag_nonlinear",
                  1.0 if out.solver_flag == "NON_LINEAR" else 0.0)
        self._tick += 1
        if out.solver_flag == "NON_LINEAR":
            res.stamps.append(t)
            res.P.append(out.P)
            res.Q.append(out.Q)
            res.V.append(out.V)
