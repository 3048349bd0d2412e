"""Tiny numpy quaternion helpers for the host-side IMU-rate propagation
(port of the helpers of esvio_tpu/core/lie_np.py that the estimator uses;
predict(), stereo_estimator_node.cpp:44-93).  Quaternions are wxyz."""
from __future__ import annotations

import numpy as np


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_normalize(q):
    return q / np.linalg.norm(q)


def quat_rotate(q, v):
    """Rotate v by unit quaternion q (wxyz)."""
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def delta_q(theta):
    """Small-angle quaternion [1, θ/2], normalized (Utility::deltaQ)."""
    half = 0.5 * np.asarray(theta)
    return quat_normalize(np.array([1.0, half[0], half[1], half[2]]))
