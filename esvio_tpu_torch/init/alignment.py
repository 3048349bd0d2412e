"""Visual-inertial initialization alignment (port of
esvio_tpu/init/alignment.py; initial_aligment.cpp):

  * solve_gyroscope_bias        (:3-37)    LS gyro bias from visual vs
    preintegrated ΔR
  * linear_alignment_with_depth (:280-344) {v_k, g} with the metric scale
    of stereo depth, refine_gravity_with_depth (:211-278)
  * linear_alignment            (:125-198) the mono {v_k, g, s} with the
    scale unknown, refine_gravity (:55-123)

The per-pair 6×k blocks are built as one batch and accumulated into the
normal equations (`_accumulate`, the JAX package's `_scatter_pair` loop).
"""
from __future__ import annotations

import torch

from esvio_tpu_torch.core import lie


def solve_gyroscope_bias(Rs, dq_dbg, delta_q):
    """LS Δbg from relative visual rotations vs preintegrated Δq.
    Rs (F, 3, 3) body rotations; dq_dbg (F-1, 3, 3); delta_q (F-1, 4)."""
    q_ij = lie.rot_to_quat(torch.einsum("fji,fjk->fik", Rs[:-1], Rs[1:]))
    resid = 2.0 * lie.quat_mul(lie.quat_inv(delta_q), q_ij)[:, 1:]
    A = torch.einsum("fji,fjk->ik", dq_dbg, dq_dbg)
    b = torch.einsum("fji,fj->i", dq_dbg, resid)
    return torch.linalg.solve(A + 1e-12 * torch.eye(3, dtype=A.dtype,
                                                    device=A.device), b)


def _tangent_basis(g0):
    a = g0 / torch.linalg.vector_norm(g0)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=g0.dtype, device=g0.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=g0.dtype, device=g0.device)
    tmp = torch.where(torch.abs(a[2]) > 0.999, ex, ez)
    b = tmp - a * torch.dot(a, tmp)
    b = b / torch.linalg.vector_norm(b)
    c = torch.linalg.cross(a, b)
    return torch.stack([b, c], dim=1)  # (3, 2)


def _accumulate(A_blocks, b_blocks, n, tail):
    """Normal equations of the per-pair blocks: v_i/v_j rows at 3i, the
    last `tail` unknowns at the end."""
    dtype, dev = A_blocks.dtype, A_blocks.device
    A = torch.zeros((n, n), dtype=dtype, device=dev)
    b = torch.zeros((n,), dtype=dtype, device=dev)
    rA = A_blocks.transpose(1, 2) @ A_blocks
    rb = torch.einsum("kji,kj->ki", A_blocks, b_blocks)
    for i in range(A_blocks.shape[0]):
        i3 = i * 3
        A[i3:i3 + 6, i3:i3 + 6] += rA[i, 0:6, 0:6]
        b[i3:i3 + 6] += rb[i, 0:6]
        A[n - tail:, n - tail:] += rA[i, 6:, 6:]
        b[n - tail:] += rb[i, 6:]
        A[i3:i3 + 6, n - tail:] += rA[i, 0:6, 6:]
        A[n - tail:, i3:i3 + 6] += rA[i, 6:, 0:6]
    return A, b


def _solve(A, b):
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A * 1000.0 + 1e-9 * eye, b * 1000.0)


def _pair_terms(Rs, T_cam, tic):
    Ri, Rj = Rs[:-1], Rs[1:]
    Rit = Ri.transpose(1, 2)
    Rij = Rit @ Rj
    dT = torch.einsum("kij,kj->ki", Rit, T_cam[1:] - T_cam[:-1])
    rot_tic = torch.einsum("kij,j->ki", Rij, tic)
    return Rit, Rij, dT, rot_tic


def _pair_A(Rij, d, width):
    """(K, 6, width) pair blocks with the velocity columns filled (rows
    0:3 the position term, 3:6 the velocity term); Rij (K, 3, 3) the
    pairs' relative rotations, d (K, 1, 1) their intervals."""
    K, dtype, dev = Rij.shape[0], Rij.dtype, Rij.device
    eye = torch.eye(3, dtype=dtype, device=dev).expand(K, 3, 3)
    A = torch.zeros((K, 6, width), dtype=dtype, device=dev)
    A[:, 0:3, 0:3] = -d * eye
    A[:, 3:6, 0:3] = -eye
    A[:, 3:6, 3:6] = Rij
    return A


def linear_alignment_with_depth(Rs, T_cam, dp, dv, dts, tic, g_norm):
    """Solve {v_0..v_{F-1} (body frames), g (world-b0)} with metric scale.
    Returns (ok, g (3,), v (F, 3)); ok fails if ‖g‖ is > 1 m/s² off."""
    F = Rs.shape[0]
    n = 3 * F + 3
    Rit, Rij, dT, rot_tic = _pair_terms(Rs, T_cam, tic)
    d = dts[:, None, None]
    A = _pair_A(Rij, d, 9)
    A[:, 0:3, 6:9] = Rit * (d * d / 2)
    A[:, 3:6, 6:9] = Rit * d
    b = torch.cat([dp + rot_tic - tic - dT, dv], -1)
    An, bn = _accumulate(A, b, n, 3)
    x = _solve(An, bn)
    g = x[n - 3:]
    ok = torch.abs(torch.linalg.vector_norm(g) - g_norm) <= 1.0
    g_ref, v = refine_gravity_with_depth(Rs, T_cam, dp, dv, dts, tic, g, g_norm)
    return ok, g_ref, v


def refine_gravity_with_depth(Rs, T_cam, dp, dv, dts, tic, g, g_norm):
    """4 iterations on the 2-DoF gravity tangent (RefineGravityWithDepth)."""
    F = Rs.shape[0]
    n = 3 * F + 2
    dtype, dev = Rs.dtype, Rs.device
    g0 = g / torch.linalg.vector_norm(g) * g_norm
    Rit, Rij, dT, rot_tic = _pair_terms(Rs, T_cam, tic)
    d = dts[:, None, None]
    v = torch.zeros((F, 3), dtype=dtype, device=dev)
    for _ in range(4):
        lxly = _tangent_basis(g0)
        A = _pair_A(Rij, d, 8)
        A[:, 0:3, 6:8] = (Rit * (d * d / 2)) @ lxly
        A[:, 3:6, 6:8] = (Rit * d) @ lxly
        b0 = dp + rot_tic - tic - torch.einsum("kij,j->ki", Rit * (d * d / 2), g0) - dT
        b1 = dv - torch.einsum("kij,j->ki", Rit * d, g0)
        An, bn = _accumulate(A, torch.cat([b0, b1], -1), n, 2)
        x = _solve(An, bn)
        g_new = g0 + lxly @ x[n - 2:]
        g0 = g_new / torch.linalg.vector_norm(g_new) * g_norm
        v = x[: 3 * F].reshape(F, 3)
    return g0, v


def linear_alignment(Rs, T_cam, dp, dv, dts, tic, g_norm):
    """Mono LinearAlignment (initial_aligment.cpp:125-198): solve
    {v_0..v_{F-1}, g, s}; the monocular SfM is up to scale, so the scale s
    is an unknown (stored as s·100 for conditioning, as the reference does).
    Returns (ok, g (3,), v (F, 3), s); ok fails on s < 0 or ‖g‖ > 1 m/s²
    off."""
    F = Rs.shape[0]
    n = 3 * F + 4
    Rit, Rij, dT, rot_tic = _pair_terms(Rs, T_cam, tic)
    d = dts[:, None, None]
    A = _pair_A(Rij, d, 10)
    A[:, 0:3, 6:9] = Rit * (d * d / 2)
    A[:, 0:3, 9] = dT / 100.0
    A[:, 3:6, 6:9] = Rit * d
    b = torch.cat([dp + rot_tic - tic, dv], -1)
    x = _solve(*_accumulate(A, b, n, 4))
    s = x[n - 1] / 100.0
    g = x[n - 4:n - 1]
    ok = (torch.abs(torch.linalg.vector_norm(g) - g_norm) <= 1.0) & (s >= 0)
    g_ref, v, s_ref = refine_gravity(Rs, T_cam, dp, dv, dts, tic, g, g_norm)
    return ok & (s_ref >= 0), g_ref, v, s_ref


def refine_gravity(Rs, T_cam, dp, dv, dts, tic, g, g_norm):
    """Mono RefineGravity (initial_aligment.cpp:55-123): 4 iterations on
    the 2-DoF gravity tangent with the scale kept as an unknown."""
    F = Rs.shape[0]
    n = 3 * F + 3
    dtype, dev = Rs.dtype, Rs.device
    g0 = g / torch.linalg.vector_norm(g) * g_norm
    Rit, Rij, dT, rot_tic = _pair_terms(Rs, T_cam, tic)
    d = dts[:, None, None]
    v = torch.zeros((F, 3), dtype=dtype, device=dev)
    s = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(4):
        lxly = _tangent_basis(g0)
        A = _pair_A(Rij, d, 9)
        A[:, 0:3, 6:8] = (Rit * (d * d / 2)) @ lxly
        A[:, 0:3, 8] = dT / 100.0
        A[:, 3:6, 6:8] = (Rit * d) @ lxly
        b0 = dp + rot_tic - tic - torch.einsum("kij,j->ki", Rit * (d * d / 2), g0)
        b1 = dv - torch.einsum("kij,j->ki", Rit * d, g0)
        x = _solve(*_accumulate(A, torch.cat([b0, b1], -1), n, 3))
        g_new = g0 + lxly @ x[n - 3:n - 1]
        g0 = g_new / torch.linalg.vector_norm(g_new) * g_norm
        v = x[: 3 * F].reshape(F, 3)
        s = x[n - 1] / 100.0
    return g0, v, s
