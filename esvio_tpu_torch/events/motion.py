"""IMU-aided event motion compensation: warp events to the window start
(port of esvio_tpu/events/motion.py, EventDetector::motioncorrection,
event_detector.cc:547-591).

Each event (x, y) at time t is warped to the window start t₀ with the
rotation exp([ω]× dt) and the translation ½dt(v + v_prev), only when
‖accel‖ exceeds the threshold (a_motion_compensation_threshold, 5 m/s²).
The whole chunk warps in one pass; the switch is decided on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.events.sae import EventChunk

ACCEL_THRESHOLD = 5.0   # a_motion_compensation_threshold
_BORDER = 6             # kBorder (event_detector.cc:550)


def motion_correct_chunk(chunk: EventChunk, fx, fy, cx, cy, omega, v_cur,
                         v_prev, accel, t0, width: int, height: int
                         ) -> EventChunk:
    """Warp the chunk's events to time t0 (returns a new chunk).

    fx, fy, cx, cy: intrinsics (numbers or 0-d tensors); omega: (3,) mean
    gyro over the window; v_cur/v_prev: (3,) back-end velocity feedback;
    accel: (3,) mean accelerometer; t0: window start time.  Identity when
    ‖accel‖ ≤ 5 m/s², as in the reference."""
    dtype, dev = chunk.t.dtype, chunk.t.device
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    fx, fy, cx, cy = f(fx), f(fy), f(cx), f(cy)
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    K = torch.stack([fx, zero, cx, zero, fy, cy, zero, zero, one]).reshape(3, 3)
    K_inv = torch.stack([1.0 / fx, zero, -cx / fx, zero, 1.0 / fy, -cy / fy,
                         zero, zero, one]).reshape(3, 3)
    omega, v_cur, v_prev, accel = f(omega), f(v_cur), f(v_prev), f(accel)

    dt = chunk.t - t0
    enabled = torch.linalg.vector_norm(accel) > ACCEL_THRESHOLD

    # per-event rotation exp([ω dt]×); translation from the mean velocity
    rot = lie.so3_exp(omega[None, :] * dt[:, None])              # (E, 3, 3)
    rot_K = K @ rot.transpose(1, 2) @ K_inv
    trans = 0.5 * dt[:, None] * (v_cur + v_prev)[None, :]         # (E, 3)
    # reference: trans_K = -rot_K @ (K⁻¹ @ trans)  (event_detector.cc:561)
    trans_K = -(rot_K @ (trans @ K_inv.T)[:, :, None])[:, :, 0]

    vec = torch.stack([chunk.x.to(dtype), chunk.y.to(dtype),
                       torch.ones_like(dt)], dim=-1)
    warped = (rot_K @ vec[:, :, None])[:, :, 0] + trans_K
    wx = torch.floor(warped[:, 0] / warped[:, 2]).to(torch.int32)
    wy = torch.floor(warped[:, 1] / warped[:, 2]).to(torch.int32)

    x, y = chunk.x, chunk.y
    in_src = ((x > _BORDER) & (x <= width - _BORDER)
              & (y > _BORDER) & (y <= height - _BORDER))
    in_dst = (wx > 0) & (wx < width - 1) & (wy > 0) & (wy < height - 1)
    use = enabled & in_src & in_dst
    return dataclasses.replace(chunk, x=torch.where(use, wx, x),
                               y=torch.where(use, wy, y))
