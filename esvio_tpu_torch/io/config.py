"""System configuration (port of `SystemConfig` and `extrinsic_arrays`,
esvio_tpu/io/config.py).  Keys mirror the reference YAML
(feature_tracker/src/parameters.cpp:81-282,
esvio_estimator/src/parameters.cpp:70-131).  The YAML loader is not ported
yet."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SystemConfig:
    """Mirror of the per-dataset YAML (config/esvio/esvio.yaml keys)."""

    system_mode: int = 1            # 0 = ESIO, 1 = ESVIO
    output_path: str = "/tmp/esvio_tpu"
    image_width: int = 346
    image_height: int = 260
    event_width: int = 346
    event_height: int = 260
    R_body_cam0: np.ndarray = None
    t_body_cam0: np.ndarray = None
    R_body_cam1: np.ndarray = None
    t_body_cam1: np.ndarray = None
    R_body_event0: np.ndarray = None
    t_body_event0: np.ndarray = None
    R_body_event1: np.ndarray = None
    t_body_event1: np.ndarray = None
    estimate_extrinsic: int = 0
    max_cnt: int = 150
    max_cnt_img: int = 150
    min_dist: int = 10
    min_dist_img: int = 10
    freq: int = 15
    f_threshold: float = 1.0
    equalize: int = 0
    fisheye: int = 0
    decay_ms: float = 20.0
    ignore_polarity: bool = False
    median_blur_kernel_size: int = 0
    feature_filter_threshold: float = 0.01
    do_motion_correction: bool = False
    use_stereo_correction: int = 1
    max_solver_time: float = 0.04
    max_num_iterations: int = 8
    keyframe_parallax: float = 10.0
    acc_n: float = 0.2
    gyr_n: float = 0.05
    acc_w: float = 0.002
    gyr_w: float = 4e-5
    g_norm: float = 9.80766
    estimate_td: int = 0
    td: float = 0.0
    loop_closure: int = 1
    fast_relocalization: int = 0
    cam_left_calib: str = ""
    cam_right_calib: str = ""
    event_left_calib: str = ""
    event_right_calib: str = ""
    cameras: dict = dataclasses.field(default_factory=dict)


def extrinsic_arrays(cfg: SystemConfig):
    """(ex_p (4,3), ex_q (4,4)) numpy float64 in solver slot order
    [img_l, evt_l, img_r, evt_r]."""
    from esvio_tpu_torch.core import lie

    Rs = [cfg.R_body_cam0, cfg.R_body_event0, cfg.R_body_cam1, cfg.R_body_event1]
    ts = [cfg.t_body_cam0, cfg.t_body_event0, cfg.t_body_cam1, cfg.t_body_event1]
    ex_p = np.stack([t if t is not None else np.zeros(3) for t in ts])
    ex_q = np.stack([
        lie.rot_to_quat(torch.as_tensor(
            np.asarray(R if R is not None else np.eye(3), np.float64))).numpy()
        for R in Rs])
    return ex_p, ex_q
