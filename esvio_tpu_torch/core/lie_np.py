"""Tiny numpy quaternion and Euler helpers for host-side paths (a copy of
esvio_tpu/core/lie_np.py): the IMU-rate propagation (predict(),
stereo_estimator_node.cpp:44-93) and the pose-graph bookkeeping of loop
closure.  Quaternions are wxyz, ypr in degrees."""
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


def quat_to_rot(q):
    """Unit quaternion (wxyz) → 3×3 rotation matrix."""
    w, x, y, z = np.asarray(q, float)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def rot_to_quat(R):
    """3×3 rotation → unit quaternion (wxyz, w ≥ 0), Shepperd max-diagonal."""
    R = np.asarray(R, float)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(max(tr + 1.0, 1e-12)) * 2.0
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 1e-12)) * 2.0
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(max(1.0 - R[0, 0] + R[1, 1] - R[2, 2], 1e-12)) * 2.0
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(max(1.0 - R[0, 0] - R[1, 1] + R[2, 2], 1e-12)) * 2.0
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def rot_to_ypr(R):
    """Rotation matrix → (yaw, pitch, roll) degrees (Utility::R2ypr)."""
    R = np.asarray(R, float)
    n, o, a = R[:, 0], R[:, 1], R[:, 2]
    y = np.arctan2(n[1], n[0])
    p = np.arctan2(-n[2], n[0] * np.cos(y) + n[1] * np.sin(y))
    r = np.arctan2(a[0] * np.sin(y) - a[1] * np.cos(y),
                   -o[0] * np.sin(y) + o[1] * np.cos(y))
    return np.array([y, p, r]) * (180.0 / np.pi)


def ypr_to_rot(ypr):
    """(yaw, pitch, roll) degrees → Rz Ry Rx (Utility::ypr2R)."""
    y, p, r = np.asarray(ypr, float) * (np.pi / 180.0)
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])
