"""Config system: one YAML file drives the whole pipeline (port of
esvio_tpu/io/config.py).

Reads the reference's OpenCV-FileStorage-style YAML configs unchanged
(config/*/esvio.yaml + per-camera yaml files): `%YAML:1.0` headers and
`!!opencv-matrix` nodes are handled; all keys mirror
feature_tracker/src/parameters.cpp:81-282 and
esvio_estimator/src/parameters.cpp:70-131.
"""
from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch
import yaml


def _load_opencv_yaml(path):
    """Parse OpenCV FileStorage YAML (headers + opencv-matrix tags); the
    top-level matrices become (rows, cols) float arrays."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    data = yaml.safe_load(text)

    def conv(v):
        if isinstance(v, dict) and {"rows", "cols", "data"} <= set(v):
            return np.asarray(v["data"], float).reshape(v["rows"], v["cols"])
        return v

    return {k: conv(v) for k, v in (data or {}).items()}


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


def _body_T(d, key4x4, keyR, keyT, invert_flag):
    """Extract (R, t) body_T_x from either a 4×4 or R+T pair."""
    if key4x4 in d:
        T = np.asarray(d[key4x4])
        R, t = T[:3, :3], T[:3, 3]
    elif keyR in d:
        R = np.asarray(d[keyR]).reshape(3, 3)
        t = np.asarray(d[keyT]).reshape(3)
    else:
        return np.eye(3), np.zeros(3)
    if invert_flag:  # input was x_T_body (T_camera_imu: 1, parameters.cpp)
        R, t = R.T, -R.T @ t
    return R, t


def load_camera_yaml(path, device=None):
    """Per-camera intrinsic YAML → CameraModel (camodocal formats) on
    `device` (the CPU by default; `Pipeline` moves its cameras)."""
    from esvio_tpu_torch.core import camera as cam_mod

    d = _load_opencv_yaml(path)
    model = d.get("model_type", "PINHOLE").upper()
    W = int(d.get("image_width", 346))
    H = int(d.get("image_height", 260))
    if model == "PINHOLE":
        pp = d["projection_parameters"]
        dp = d.get("distortion_parameters", {})
        return cam_mod.make_pinhole(
            fx=pp["fx"], fy=pp["fy"], cx=pp["cx"], cy=pp["cy"],
            dist=(dp.get("k1", 0.0), dp.get("k2", 0.0),
                  dp.get("p1", 0.0), dp.get("p2", 0.0)),
            width=W, height=H, device=device)
    if model == "KANNALA_BRANDT":
        pp = d["projection_parameters"]
        return cam_mod.make_equidistant(
            fx=pp["mu"], fy=pp["mv"], cx=pp["u0"], cy=pp["v0"],
            ks=(pp.get("k2", 0.0), pp.get("k3", 0.0), pp.get("k4", 0.0),
                pp.get("k5", 0.0)), width=W, height=H, device=device)
    if model == "MEI":
        pp = d["projection_parameters"]
        mp = d.get("mirror_parameters", {})
        dp = d.get("distortion_parameters", {})
        return cam_mod.make_mei(
            xi=mp.get("xi", 1.0), fx=pp["gamma1"], fy=pp["gamma2"],
            cx=pp["u0"], cy=pp["v0"],
            dist=(dp.get("k1", 0.0), dp.get("k2", 0.0),
                  dp.get("p1", 0.0), dp.get("p2", 0.0)), width=W, height=H,
            device=device)
    if model == "SCARAMUZZA":
        # OCam YAML layout (ScaramuzzaCamera.cc:89-103): poly_parameters
        # p0..p4, inv_poly_parameters p0..p19, affine_parameters ac/ad/ae +
        # the center cx/cy
        pp = d.get("poly_parameters", {})
        ip = d.get("inv_poly_parameters", {})
        ap = d.get("affine_parameters", {})
        poly = [pp.get(f"p{i}", 0.0) for i in range(5)]
        inv_poly = [ip.get(f"p{i}", 0.0) for i in range(20)]
        return cam_mod.make_scaramuzza(
            poly, inv_poly, cx=ap.get("cx", W / 2), cy=ap.get("cy", H / 2),
            affine=(ap.get("ac", 1.0), ap.get("ad", 0.0), ap.get("ae", 0.0)),
            width=W, height=H, device=device)
    raise ValueError(f"unsupported camera model {model}")


_SIMPLE_KEYS = {
    "system_mode": int, "output_path": str, "image_width": int,
    "image_height": int, "event_width": int, "event_height": int,
    "estimate_extrinsic": int, "max_cnt": int, "max_cnt_img": int,
    "min_dist": int, "min_dist_img": int, "freq": int,
    "F_threshold": ("f_threshold", float), "equalize": int, "fisheye": int,
    "decay_ms": float,
    "ignore_polarity": ("ignore_polarity", lambda v: bool(int(v))),
    "median_blur_kernel_size": int,
    "feature_filter_threshold": float,
    "Do_motion_correction": ("do_motion_correction", lambda v: bool(int(v))),
    "use_stereo_correction": int,
    "max_solver_time": float, "max_num_iterations": int,
    "keyframe_parallax": float, "acc_n": float, "gyr_n": float,
    "acc_w": float, "gyr_w": float, "g_norm": float, "estimate_td": int,
    "td": float, "loop_closure": int, "fast_relocalization": int,
    "cam_left_calib": str, "cam_right_calib": str,
    "event_left_calib": str, "event_right_calib": str,
}


def load_config(path) -> SystemConfig:
    """The system YAML → SystemConfig, its camera YAMLs (resolved relative
    to the config's directory, parameters.cpp:139) loaded into `cameras`
    as cam0 / cam1 / event0 / event1."""
    d = _load_opencv_yaml(path)
    cfg = SystemConfig()
    for key, spec in _SIMPLE_KEYS.items():
        if key not in d:
            continue
        name, conv = spec if isinstance(spec, tuple) else (key, spec)
        setattr(cfg, name, conv(d[key]))

    inv_cam = bool(d.get("T_camera_imu", 0))
    inv_evt = bool(d.get("T_event_imu", 0))
    cfg.R_body_cam0, cfg.t_body_cam0 = _body_T(
        d, "body_T_cam0", "extrinsicRotation", "extrinsicTranslation", inv_cam)
    cfg.R_body_event0, cfg.t_body_event0 = _body_T(
        d, "body_T_event0", "extrinsicRotation_event",
        "extrinsicTranslation_event", inv_evt)
    cfg.R_body_cam1, cfg.t_body_cam1 = _body_T(
        d, "body_T_cam1", "__none__", "__none__", False)
    cfg.R_body_event1, cfg.t_body_event1 = _body_T(
        d, "body_T_event1", "__none__", "__none__", False)
    # right extrinsics from Rrl/Trl when the 4×4 blocks are absent:
    # x_r = Rrl x_l + Trl  ⇒  left_T_right = (Rrlᵀ, −Rrlᵀ Trl)
    for right, left, rrl, trl in (("cam1", "cam0", "Rrl", "Trl"),
                                  ("event1", "event0", "Rrl_event",
                                   "Trl_event")):
        if f"body_T_{right}" not in d and rrl in d:
            Rrl = np.asarray(d[rrl]).reshape(3, 3)
            Trl = np.asarray(d[trl]).reshape(3)
            R_l, t_l = getattr(cfg, f"R_body_{left}"), getattr(cfg, f"t_body_{left}")
            setattr(cfg, f"R_body_{right}", R_l @ Rrl.T)
            setattr(cfg, f"t_body_{right}", t_l - R_l @ (Rrl.T @ Trl))

    base = os.path.dirname(os.path.abspath(path))
    for name, attr in (("cam_left_calib", "cam0"), ("cam_right_calib", "cam1"),
                       ("event_left_calib", "event0"),
                       ("event_right_calib", "event1")):
        fn = getattr(cfg, name)
        if fn:
            fp = os.path.join(base, fn)
            if os.path.exists(fp):
                cfg.cameras[attr] = load_camera_yaml(fp)
    return cfg


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
