"""Quaternion / SO(3) / Euler utilities on torch tensors (port of
esvio_tpu/core/lie.py).

Conventions as in the reference: Hamilton quaternions stored (w, x, y, z)
in the last axis; ypr is (yaw, pitch, roll) in DEGREES with
R = Rz(y) Ry(p) Rx(r); delta_q(θ) = (1, θ/2) unnormalized.  All functions
broadcast over leading axes and keep the input dtype and device.
"""
from __future__ import annotations

import math

import torch


def scale(x, s: float):
    """x · s for a Python number s.  Written as aten's Scalar overload: the
    plain `s * x` wraps s into a tensor, which under forward-mode
    differentiation (the factor Jacobians) gets a lazy zero tangent whose
    arithmetic runs a slow Python path."""
    return torch.ops.aten.mul.Scalar(x, s)


def _cross(a, b):
    """a × b over the last axis, written out: the factor Jacobians take
    forward-mode derivatives through it, and torch.linalg.cross's
    forward-mode rule is far slower than six products."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


# ---------------------------------------------------------------------------
# quaternion basics
# ---------------------------------------------------------------------------

def quat_mul(q, p):
    """Hamilton product q ⊗ p, (..., 4) × (..., 4) → (..., 4)."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q):
    """Inverse for (possibly) non-unit quaternions."""
    return quat_conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate vector(s) v by UNIT quaternion(s) q: R(q) v."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + scale(w * uv + _cross(u, uv), 2.0)


def quat_to_rot(q):
    """Unit quaternion → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """Rotation matrix → unit quaternion (w, x, y, z), branch-free
    (Shepperd / max-diagonal method written with selects)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(t):
        return torch.sqrt(torch.clamp(t, min=1e-12)) * 2.0

    s0 = s_of(1.0 + tr)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = s_of(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = s_of(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = s_of(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None], q0,
        torch.where(cond1[..., None], q1,
                    torch.where(cond2[..., None], q2, q3)),
    )
    return quat_normalize(q)


def quat_from_two_vectors(a, b):
    """Unit quaternion rotating a → b (Eigen FromTwoVectors semantics)."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    w = 1.0 + d
    ex, ey, _ = torch.eye(3, dtype=a.dtype, device=a.device)
    perp = _cross(a, ex.expand(a.shape))
    small = torch.linalg.vector_norm(perp, dim=-1, keepdim=True) < 1e-6
    perp = torch.where(small, _cross(a, ey.expand(a.shape)), perp)
    q = torch.cat([w, c], dim=-1)
    q_anti = torch.cat([torch.zeros_like(w), perp], dim=-1)
    q = torch.where(w < 1e-8, q_anti, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# small-angle helpers (Utility::deltaQ, skewSymmetric, Qleft/Qright)
# ---------------------------------------------------------------------------

def delta_q(theta):
    """First-order quaternion (1, θ/2); NOT normalized (Utility::deltaQ)."""
    half = scale(theta, 0.5)
    # 1 + 0·θ rather than a constant, for the reason given at `scale`
    one = torch.ops.aten.add.Scalar(scale(half[..., :1], 0.0), 1.0)
    return torch.cat([one, half], dim=-1)


def skew(v):
    """(..., 3) → (..., 3, 3) skew-symmetric matrix [v]×."""
    z = torch.zeros_like(v[..., 0])
    r = torch.stack(
        [z, -v[..., 2], v[..., 1],
         v[..., 2], z, -v[..., 0],
         -v[..., 1], v[..., 0], z],
        dim=-1,
    )
    return r.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------

def so3_exp(w):
    """Exponential map (..., 3) → rotation matrix, Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    W = skew(w)
    W2 = W @ W
    s = torch.where(theta2 < 1e-12, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(theta2 < 1e-12, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + s[..., None, None] * W + c[..., None, None] * W2


def so3_log(R):
    """Log map rotation matrix → (..., 3), Taylor-safe near identity and π."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    factor = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                         theta / torch.clamp(2.0 * sin_t, min=1e-12))
    w = factor[..., None] * vee
    q = rot_to_quat(R)
    axis = q[..., 1:] / torch.clamp(
        torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True), min=1e-12)
    w_pi = axis * theta[..., None]
    return torch.where((math.pi - theta < 1e-3)[..., None], w_pi, w)


def quat_exp(w):
    """so(3) vector → unit quaternion (exact exponential)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    s = torch.where(theta2 < 1e-12, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([torch.cos(half), s * w], dim=-1)


# ---------------------------------------------------------------------------
# Euler (degrees) — Utility::R2ypr / ypr2R / g2R
# ---------------------------------------------------------------------------

def rot_to_ypr(R):
    """Rotation matrix → (yaw, pitch, roll) in degrees (Utility::R2ypr)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.arctan2(n[..., 1], n[..., 0])
    p = torch.arctan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.arctan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr_to_rot(ypr):
    """(yaw, pitch, roll) degrees → rotation matrix Rz Ry Rx (Utility::ypr2R)."""
    rad = ypr * (math.pi / 180.0)
    y, p, r = rad[..., 0], rad[..., 1], rad[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    row = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return row.reshape(rad.shape[:-1] + (3, 3))


def g2R(g):
    """World-from-IMU rotation aligning measured gravity g with +z, yaw
    removed (Utility::g2R)."""
    ez = torch.eye(3, dtype=g.dtype, device=g.device)[2]
    R0 = quat_to_rot(quat_from_two_vectors(g, ez.expand(g.shape)))
    yaw = rot_to_ypr(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    fix = ypr_to_rot(torch.stack([-yaw, zero, zero], dim=-1))
    return fix @ R0


def normalize_angle_deg(a):
    """Wrap degrees into (-180, 180] (Utility::normalizeAngle)."""
    return a - 360.0 * torch.floor((a + 180.0) / 360.0)
