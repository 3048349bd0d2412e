"""Sliding-window state, feature books and the error-state layout (port of
esvio_tpu/solver/window.py).

    [ poses 11×6 | speed-bias 11×9 | extrinsics 4×6 | td 1 ]  = 190 dims
      δpose = (δp ∈ R³, δθ ∈ so(3): q ← q ⊗ dq(δθ)),  δsb = (δv, δba, δbg)

Landmark inverse depths live outside this vector (Schur-eliminated).
Extrinsic slots: 0 = image-left, 1 = event-left, 2 = image-right,
3 = event-right.

States, books and deltas may carry leading batch axes (a batch of windows,
solver/gauss_newton.solve_window_batched); the functions here broadcast
over them.
"""
from __future__ import annotations

import dataclasses

import torch

from esvio_tpu_torch.core import lie

WINDOW = 10
N_STATES = WINDOW + 1
N_EX = 4
DIM_POSE = 6
DIM_SB = 9
OFF_POSE = 0
OFF_SB = N_STATES * DIM_POSE                   # 66
OFF_EX = OFF_SB + N_STATES * DIM_SB            # 165
OFF_TD = OFF_EX + N_EX * DIM_POSE              # 189
DIM_ALL = OFF_TD + 1                           # 190

FOCAL = 460.0


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass
class WindowState:
    P: torch.Tensor    # (11, 3)
    Q: torch.Tensor    # (11, 4) wxyz
    V: torch.Tensor    # (11, 3)
    Ba: torch.Tensor   # (11, 3)
    Bg: torch.Tensor   # (11, 3)
    ex_p: torch.Tensor  # (4, 3)
    ex_q: torch.Tensor  # (4, 4)
    td: torch.Tensor   # ()

    def clone(self):
        return WindowState(*(getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)))


def init_window(device, dtype=torch.float32) -> WindowState:
    q = torch.eye(1, 4, dtype=dtype, device=device)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return WindowState(P=z(N_STATES, 3), Q=q.repeat(N_STATES, 1),
                       V=z(N_STATES, 3), Ba=z(N_STATES, 3), Bg=z(N_STATES, 3),
                       ex_p=z(N_EX, 3), ex_q=q.repeat(N_EX, 1), td=z())


def tree_map(fn, *objs):
    """fn applied field by field over dataclasses of tensors (recursing
    into nested ones, e.g. a Prior's `lin` window)."""
    first = objs[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: tree_map(fn, *(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(first)})
    return fn(*objs)


def apply_delta(state: WindowState, dx) -> WindowState:
    """x ⊞ δ with the layout above (quaternions right-multiplied)."""
    lead = dx.shape[:-1]
    dp = dx[..., OFF_POSE:OFF_SB].reshape(lead + (N_STATES, 6))
    dsb = dx[..., OFF_SB:OFF_EX].reshape(lead + (N_STATES, 9))
    dex = dx[..., OFF_EX:OFF_TD].reshape(lead + (N_EX, 6))
    Q = lie.quat_normalize(lie.quat_mul(state.Q, lie.delta_q(dp[..., 3:6])))
    ex_q = lie.quat_normalize(lie.quat_mul(state.ex_q, lie.delta_q(dex[..., 3:6])))
    return WindowState(
        P=state.P + dp[..., 0:3], Q=Q, V=state.V + dsb[..., 0:3],
        Ba=state.Ba + dsb[..., 3:6], Bg=state.Bg + dsb[..., 6:9],
        ex_p=state.ex_p + dex[..., 0:3], ex_q=ex_q, td=state.td + dx[..., OFF_TD])


def state_minus(state: WindowState, lin: WindowState):
    """x ⊟ x₀ → (190,), δθ = 2 vec(q₀⁻¹ ⊗ q) with the w ≥ 0 hemisphere
    (MarginalizationFactor::Evaluate, marginalization_factor.cpp:283-323)."""
    dq = lie.quat_mul(lie.quat_conj(lin.Q), state.Q)
    dq = torch.where(dq[..., :1] >= 0, dq, -dq)
    dex_q = lie.quat_mul(lie.quat_conj(lin.ex_q), state.ex_q)
    dex_q = torch.where(dex_q[..., :1] >= 0, dex_q, -dex_q)
    lead = state.td.shape
    dpose = torch.cat([state.P - lin.P, 2.0 * dq[..., 1:]], -1).reshape(lead + (-1,))
    dsb = torch.cat([state.V - lin.V, state.Ba - lin.Ba, state.Bg - lin.Bg],
                    -1).reshape(lead + (-1,))
    dex = torch.cat([state.ex_p - lin.ex_p, 2.0 * dex_q[..., 1:]],
                    -1).reshape(lead + (-1,))
    return torch.cat([dpose, dsb, dex, (state.td - lin.td)[..., None]], -1)


@dataclasses.dataclass
class FeatureBook:
    """Per-modality feature observations over the window; lane l ↔ one
    feature id (the reference's per-id lists in capacity+mask form)."""

    un: torch.Tensor        # (L, 11, 2) normalized left obs
    vel: torch.Tensor       # (L, 11, 2)
    un_r: torch.Tensor      # (L, 11, 2) right obs
    vel_r: torch.Tensor     # (L, 11, 2)
    obs: torch.Tensor       # (L, 11) bool
    stereo: torch.Tensor    # (L, 11) bool
    td_obs: torch.Tensor    # (L, 11)
    inv_depth: torch.Tensor   # (L,)
    depth_valid: torch.Tensor  # (L,) bool
    active: torch.Tensor    # (L,) bool
    ids: torch.Tensor       # (L,) int32


def empty_book(capacity: int, device, dtype=torch.float32) -> FeatureBook:
    L, F = capacity, N_STATES
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return FeatureBook(
        un=z(L, F, 2), vel=z(L, F, 2), un_r=z(L, F, 2), vel_r=z(L, F, 2),
        obs=z(L, F, dt=torch.bool), stereo=z(L, F, dt=torch.bool),
        td_obs=z(L, F), inv_depth=z(L), depth_valid=z(L, dt=torch.bool),
        active=z(L, dt=torch.bool),
        ids=torch.full((L,), -1, dtype=torch.int32, device=device))


def start_frame(book: FeatureBook):
    """(L,) index of the first observed frame (0 if never observed)."""
    return torch.argmax(book.obs.to(torch.uint8), dim=-1)


def used_num(book: FeatureBook):
    return torch.sum(book.obs, dim=-1)


def gauge_transform(state: WindowState, ref_p0, ref_q0):
    """(rot, q_rot, p0) of the gauge correction: P' = rot (P − p0) + ref_p0,
    Q' = q_rot ⊗ Q (estimator.cpp:1652-1695)."""
    ypr_ref = lie.rot_to_ypr(lie.quat_to_rot(ref_q0))
    ypr_cur = lie.rot_to_ypr(lie.quat_to_rot(state.Q[0]))
    ydiff = ypr_ref[0] - ypr_cur[0]
    zero = torch.zeros_like(ydiff)
    rot = lie.ypr_to_rot(torch.stack([ydiff, zero, zero]))
    # Euler-singularity fallback (|pitch| ≈ 90°): full R_ref R_cur⁻¹
    singular = (torch.abs(ypr_cur[1]) > 89.0) | (torch.abs(ypr_ref[1]) > 89.0)
    rot_full = lie.quat_to_rot(ref_q0) @ lie.quat_to_rot(state.Q[0]).T
    rot = torch.where(singular, rot_full, rot)
    return rot, lie.rot_to_quat(rot), state.P[0]


def gauge_fix(state: WindowState, ref_p0, ref_q0) -> WindowState:
    """Rotate/translate the window so frame 0 keeps its pre-solve yaw and
    position (stereo_double2vector3, estimator.cpp:1600-1697)."""
    rot, q_rot, p0 = gauge_transform(state, ref_p0, ref_q0)
    P = (state.P - p0) @ rot.T + ref_p0
    Q = lie.quat_normalize(lie.quat_mul(q_rot[None, :], state.Q))
    V = state.V @ rot.T
    return _replace(state, P=P, Q=Q, V=V)
