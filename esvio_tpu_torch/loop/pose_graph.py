"""4-DoF pose-graph optimization (yaw + position), batched Gauss-Newton
(port of esvio_tpu/loop/pose_graph.py; PoseGraph::optimize4DoF +
FourDOFError/FourDOFWeightError, pose_graph.cpp:423-586,
pose_graph.h:160-249):

  residual(i, j) = [ R(yaw_i, pitch_i, roll_i)ᵀ (t_j − t_i) − t_ij ;
                     wrap(yaw_j − yaw_i − yaw_ij) (/10 for loop edges) ]

  * sequential edges to each of the 4 previous keyframes, loop edges with
    a Huber(0.1) loss, the first keyframe fixed, 5 GN iterations
    (pose_graph.cpp:455-531);
  * pitch/roll are constants from VIO, only yaw + t are optimized.

Static capacity: K keyframes, E loop edges; masked lanes are zero rows.
`optimize_4dof` solves the dense (4K)² system; `optimize_4dof_cg` never
forms it (matrix-free Jacobi-preconditioned CG, the unbounded-trajectory
path).  Neither reads the device from the host: the CG runs `cg_iters`
masked iterations that freeze once the residual is small, where the JAX
version's while_loop stops.
"""
from __future__ import annotations

import torch

from esvio_tpu_torch.core import lie
from esvio_tpu_torch.solver.factors import jacobian_fwd

SEQ_NEIGHBORS = 4   # pose_graph.cpp:497
HUBER_DELTA = 0.1
YAW_LOOP_WEIGHT = 0.1  # loop-edge yaw residual divided by 10


def _edge_residual(yaw_i, t_i, yaw_j, t_j, pitch_i, roll_i, t_ij, yaw_ij,
                   yaw_scale):
    """(..., 4) residual of edges i → j (all arguments broadcast)."""
    Ri = lie.ypr_to_rot(torch.stack(torch.broadcast_tensors(yaw_i, pitch_i,
                                                            roll_i), dim=-1))
    t_loc = torch.einsum("...ji,...j->...i", Ri, t_j - t_i)
    r_y = lie.normalize_angle_deg(yaw_j - yaw_i - yaw_ij) * yaw_scale
    return torch.cat([t_loc - t_ij, r_y[..., None]], dim=-1)


def _edges_jac(yaw, t, pitch, roll, ei, ej, t_ij, yaw_ij, yaw_scale):
    """Residuals (E, 4) and Jacobians (E, 4, 8) w.r.t. [δyaw_i, δt_i,
    δyaw_j, δt_j] of the edges ei → ej at the poses (yaw, t)."""

    def f(d, yi, ti, yj, tj, pi, ri, tij, yij, ys):
        return _edge_residual(yi + d[..., 0], ti + d[..., 1:4],
                              yj + d[..., 4], tj + d[..., 5:8],
                              pi, ri, tij, yij, ys)

    consts = (yaw[ei], t[ei], yaw[ej], t[ej], pitch[ei], roll[ei], t_ij,
              yaw_ij, yaw_scale)
    return jacobian_fwd(f, consts, ei.shape, 8, t.dtype, t.device)


def _huber_weight(r2, delta):
    """sqrt of Huber ρ'(s) for Ceres HuberLoss(delta), s = ‖r‖²."""
    s = torch.sqrt(torch.clamp(r2, min=1e-24))
    return torch.where(s <= delta, torch.ones_like(s), torch.sqrt(delta / s))


def _sequential_edges(yaw, t, pitch, roll, kf_valid, first_idx):
    """Edges (k−s → k), s = 1..4, measured from the input (VIO) poses
    (pose_graph.cpp:497-512): (seq_i, seq_j, seq_ok, seq_t_ij, seq_yaw_ij)."""
    K = yaw.shape[0]
    j_idx = torch.arange(K, device=yaw.device)
    seq_j = j_idx.repeat(SEQ_NEIGHBORS)
    seq_i = torch.cat([torch.clamp(j_idx - s, min=0)
                       for s in range(1, SEQ_NEIGHBORS + 1)])
    seq_ok = ((seq_j - seq_i >= 1) & (seq_i >= first_idx) & kf_valid[seq_i]
              & kf_valid[seq_j] & (seq_j > first_idx))
    Ri0 = lie.ypr_to_rot(torch.stack([yaw[seq_i], pitch[seq_i], roll[seq_i]], -1))
    seq_t_ij = torch.einsum("eji,ej->ei", Ri0, t[seq_j] - t[seq_i])
    return seq_i, seq_j, seq_ok, seq_t_ij, yaw[seq_j] - yaw[seq_i]


def _free_mask(kf_valid, first_idx):
    K = kf_valid.shape[0]
    k = torch.arange(K, device=kf_valid.device)
    return kf_valid & (k >= first_idx) & (k != first_idx)


def _finish(yaw, t, yaw_o, t_o, free):
    yaw_o = lie.normalize_angle_deg(yaw_o)
    return torch.where(free, yaw_o, yaw), torch.where(free[:, None], t_o, t)


def optimize_4dof(yaw, t, pitch, roll, kf_valid, first_idx,
                  loop_i, loop_j, loop_t_ij, loop_yaw_ij, loop_valid,
                  iters: int = 5):
    """Optimize yaw (degrees) + position of all keyframes, dense solve.

    yaw/pitch/roll: (K,) degrees from VIO; t: (K, 3); kf_valid: (K,) bool
    occupied slots; first_idx: earliest optimized keyframe (held fixed);
    loop_*: (E,) loop-edge endpoints and measured relative pose.
    Returns (yaw', t')."""
    K = yaw.shape[0]
    dtype, dev = t.dtype, t.device
    seq_i, seq_j, seq_ok, seq_t_ij, seq_yaw_ij = _sequential_edges(
        yaw, t, pitch, roll, kf_valid, first_idx)
    free = _free_mask(kf_valid, first_idx)
    free4 = free.repeat_interleave(4)
    n = 4 * K
    one = torch.ones((), dtype=dtype, device=dev)
    quad = torch.arange(4, device=dev)

    def accumulate(H, b, idx_i, idx_j, r, J):
        cols = torch.cat([(idx_i * 4)[:, None] + quad, (idx_j * 4)[:, None] + quad],
                         dim=1)                                  # (E, 8)
        Ht = torch.einsum("eri,erj->eij", J, J)
        bt = torch.einsum("eri,er->ei", J, r)
        flat = (cols[:, :, None] * n + cols[:, None, :]).reshape(-1)
        H = H.reshape(-1).index_add(0, flat, Ht.reshape(-1)).reshape(n, n)
        return H, b.index_add(0, cols.reshape(-1), bt.reshape(-1))

    yaw_c, t_c = yaw, t
    for _ in range(iters):
        r_s, J_s = _edges_jac(yaw_c, t_c, pitch, roll, seq_i, seq_j, seq_t_ij,
                              seq_yaw_ij, one)
        r_l, J_l = _edges_jac(yaw_c, t_c, pitch, roll, loop_i, loop_j,
                              loop_t_ij, loop_yaw_ij, one * YAW_LOOP_WEIGHT)
        w_s = seq_ok.to(dtype)[:, None]
        hub = _huber_weight(torch.sum(r_l * r_l, dim=-1), HUBER_DELTA)
        w_l = (loop_valid.to(dtype) * hub)[:, None]
        H = torch.zeros((n, n), dtype=dtype, device=dev)
        b = torch.zeros((n,), dtype=dtype, device=dev)
        H, b = accumulate(H, b, seq_i, seq_j, r_s * w_s, J_s * w_s[:, :, None])
        H, b = accumulate(H, b, loop_i, loop_j, r_l * w_l, J_l * w_l[:, :, None])
        # fix non-free nodes: zero their rows/cols, unit diagonal
        H = torch.where(free4[:, None] & free4[None, :], H, torch.zeros_like(H))
        H = H + torch.diag(torch.where(free4, 1e-8 * one, one))
        b = torch.where(free4, b, torch.zeros_like(b))
        # solve_ex: no host read of LAPACK's info
        dx = -torch.linalg.solve_ex(H, b)[0]
        yaw_c = yaw_c + dx.reshape(K, 4)[:, 0]
        t_c = t_c + dx.reshape(K, 4)[:, 1:4]
    return _finish(yaw, t, yaw_c, t_c, free)


def optimize_4dof_cg(yaw, t, pitch, roll, kf_valid, first_idx,
                     loop_i, loop_j, loop_t_ij, loop_yaw_ij, loop_valid,
                     iters: int = 5, cg_iters: int = 100):
    """The problem of `optimize_4dof` with a matrix-free Jacobi-PCG solve:
    H·v is computed edge-wise (gather v at the edge endpoints, apply the
    (4, 8) edge Jacobian, scatter back), so memory and work per CG
    iteration are O(K + E).  The reference keeps its keyframe list
    unbounded and solves SPARSE_NORMAL_CHOLESKY (pose_graph.cpp:423-586).

    Each GN step runs exactly `cg_iters` CG iterations; once r·r ≤ 1e-16
    the iterate is frozen (where the JAX version's while_loop exits), so
    the solve makes no host read."""
    K = yaw.shape[0]
    dtype, dev = t.dtype, t.device
    seq_i, seq_j, seq_ok, seq_t_ij, seq_yaw_ij = _sequential_edges(
        yaw, t, pitch, roll, kf_valid, first_idx)
    free = _free_mask(kf_valid, first_idx)
    free4 = free[:, None].expand(K, 4)

    ei = torch.cat([seq_i, loop_i])
    ej = torch.cat([seq_j, loop_j])
    e_tij = torch.cat([seq_t_ij, loop_t_ij])
    e_yij = torch.cat([seq_yaw_ij, loop_yaw_ij])
    e_scale = torch.cat([torch.ones_like(seq_yaw_ij),
                         torch.full_like(loop_yaw_ij, YAW_LOOP_WEIGHT)])
    is_loop = torch.cat([torch.zeros_like(seq_ok), torch.ones_like(loop_valid)])
    base_ok = torch.cat([seq_ok, loop_valid])
    zero4 = torch.zeros((K, 4), dtype=dtype, device=dev)

    def scatter(e8, base=zero4):
        """(E, 8) edge values → base + their (K, 4) node sums."""
        return base.index_add(0, ei, e8[:, :4]).index_add(0, ej, e8[:, 4:])

    yaw_c, t_c = yaw, t
    for _ in range(iters):
        r_e, J_e = _edges_jac(yaw_c, t_c, pitch, roll, ei, ej, e_tij, e_yij,
                              e_scale)                           # (E,4),(E,4,8)
        hub = _huber_weight(torch.sum(r_e * r_e, dim=-1), HUBER_DELTA)
        w = base_ok.to(dtype) * torch.where(is_loop, hub, torch.ones_like(hub))
        r_e = r_e * w[:, None]
        J_e = J_e * w[:, None, None]

        # b = Jᵀ r scattered to nodes; x layout (K, 4) = [yaw, t]
        b = torch.where(free4, scatter(torch.einsum("era,er->ea", J_e, r_e)),
                        zero4)
        # Jacobi preconditioner: diag(H)
        diag = scatter(torch.einsum("era,era->ea", J_e, J_e),
                       torch.full_like(zero4, 1e-8))
        Minv = torch.where(free4, 1.0 / diag, zero4)

        def hvp(v):
            ve = torch.cat([v[ei], v[ej]], dim=1)                 # (E, 8)
            u = torch.einsum("era,ea->er", J_e, ve)               # (E, 4)
            return torch.where(free4, scatter(torch.einsum("era,er->ea", J_e, u)),
                               zero4)

        # PCG for H dx = −b
        x, r = zero4, -b
        z = Minv * r
        p, rz = z, torch.sum(r * z)
        for _k in range(cg_iters):
            live = torch.sum(r * r) > 1e-16
            Ap = hvp(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x_n = x + alpha * p
            r_n = r - alpha * Ap
            z_n = Minv * r_n
            rz_n = torch.sum(r_n * z_n)
            p_n = z_n + rz_n / torch.clamp(rz, min=1e-30) * p
            x, r, z, p = (torch.where(live, a, b_) for a, b_ in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p)))
            rz = torch.where(live, rz_n, rz)
        yaw_c = yaw_c + x[:, 0]
        t_c = t_c + x[:, 1:4]
    return _finish(yaw, t, yaw_c, t_c, free)
