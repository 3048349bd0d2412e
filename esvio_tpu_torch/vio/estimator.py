"""Sliding-window VIO estimator — the state machine around the solver (port
of esvio_tpu/vio/estimator.py).

  packets → book insertion + parallax keyframe test → (INITIAL: stereo-PnP
  bootstrap + gyro-bias/gravity alignment) → triangulation → LM window
  solve → gauge fix → failure detection → marginalization → window slide.

Host Python runs the control flow on a few fetched scalars per tick; the
numeric state (window, books, prior) lives on the estimator's device.

Every steady NON_LINEAR tick takes the fused path (`_fused_tick`, the
default `fused=True`): segment A, the tick up to its keyframe decision,
runs with no host synchronisation (one CUDA graph replay on the card,
`vio/fused_graph.py`), the host then makes the tick's one fetch and runs
segment B, the marginalize-and-slide branch the decision picked.
`fused=False` keeps the general multi-dispatch path, the oracle.

Both estimator paths take image packets (ESVIO) beside the event ones.
A tick with a pending relocalization (`set_relo_frame`, fed by loop
closure) takes the general path and its in-window relo solve
(`gn.solve_window_relo`), as the JAX package does; the next steady tick
replays the captured graphs again.
Not ported yet (ROADMAP queue 1): the monocular initialization fallback
and online extrinsic calibration (`estimate_extrinsic == 2`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from esvio_tpu_torch.core import lie, lie_np, prng
from esvio_tpu_torch.imu import preintegration as pre
from esvio_tpu_torch.init import alignment, pnp, relative_pose
from esvio_tpu_torch.solver import factors
from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver import marginalization as marg
from esvio_tpu_torch.solver import window as win
from esvio_tpu_torch.vio import feature_manager as fm
from esvio_tpu_torch.vio.fused_graph import TickGraphs, fetch_post, pack_post

WINDOW = win.WINDOW

MARGIN_OLD = 0
MARGIN_SECOND_NEW = 1

# init PnP-chain rotation gate vs the gyro prediction (deg per interval)
_GYRO_GATE_DEG = 5.0


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    mode: str = "esvio"            # "esvio" (events+images) or "esio"
    evt_capacity: int = 128
    img_capacity: int = 128
    imu_capacity: int = 512        # IMU samples per window interval
    min_parallax: float = 10.0 / win.FOCAL
    g_norm: float = 9.80766
    solver_iters: int = 8
    cauchy_c: float = 1.0
    min_track_for_kf: int = 20
    estimate_extrinsic: int = 0    # 0 fixed, 1 refine (2 is not ported)
    estimate_td: int = 0
    use_stereo_correction: bool = True
    dtype: torch.dtype = torch.float32
    # steady ticks through `_fused_tick` with one host fetch; False forces
    # the general multi-dispatch path (the oracle of the fused one)
    fused: bool = True


@dataclasses.dataclass
class Output:
    t: float
    P: np.ndarray
    Q: np.ndarray
    V: np.ndarray
    solver_flag: str
    marg_flag: int
    # fast-relocalization drift feedback (relo_relative_pose,
    # stereo_double2vector3 :1652-1695): set on the tick where a registered
    # loop match was resolved against the window
    relo: Optional[dict] = None
    # keyframe snapshot for the pose graph (pubKeyframe, MARGIN_OLD ticks
    # only): dict(stamp, P, Q, ids, pts_w, un)
    keyframe: Optional[dict] = None
    n_tracked: Optional[int] = None


# the packet fields the estimator takes, in insert_packet's order
_PKT_FIELDS = ("ids", "valid", "un", "vel", "right_valid", "un_right",
               "vel_right")


def _input_dtypes(dt, has_img: bool):
    """dtypes of the fused tick's per-tick inputs, in the order of
    `Estimator._process_packets_fused`: the event packet's _PKT_FIELDS,
    the image packet's when has_img, then imu_dt, imu_acc, imu_gyr, a0s,
    g0s, imu_mask, imu_valid, frozen, min_parallax."""
    b = torch.bool
    pkt = (torch.int32, b, dt, dt, b, dt, dt)
    return pkt * (2 if has_img else 1) + (dt, dt, dt, dt, dt, b, b, b, dt)


def _np(x):
    return x.detach().cpu().numpy()


def _replace_rows(ws, k, src):
    """Window state with rows k of P/Q/V/Ba/Bg set from `src` dict."""
    out = {}
    for name in ("P", "Q", "V", "Ba", "Bg"):
        a = getattr(ws, name).clone()
        a[k] = src[name]
        out[name] = a
    return dataclasses.replace(ws, **out)


def _slide_old_state(ws):
    roll = lambda x: torch.cat([x[1:], x[-1:]], dim=0)
    return dataclasses.replace(ws, P=roll(ws.P), Q=roll(ws.Q), V=roll(ws.V),
                               Ba=roll(ws.Ba), Bg=roll(ws.Bg))


def _slide_second_state(ws):
    return _replace_rows(ws, WINDOW - 1, {n: getattr(ws, n)[WINDOW]
                                          for n in ("P", "Q", "V", "Ba", "Bg")})


def _stereo_ext_device(ws, l, r):
    """Left→right stereo transform from the window extrinsics, on the
    device: the fused tick derives it from the current ws.ex_q/ex_p, not
    from the host cache of the general path."""
    Rl = lie.quat_to_rot(ws.ex_q[l])
    Rr = lie.quat_to_rot(ws.ex_q[r])
    return Rr.T @ Rl, Rr.T @ (ws.ex_p[l] - ws.ex_p[r])


def _fused_segment_a(ws, book_img, book_evt, prior, pkt_evt, pkt_img,
                     imu_dt, imu_acc, imu_gyr, a0s, g0s, imu_mask, imu_valid,
                     g, frozen, imu_params, min_parallax, *, has_img: bool,
                     iters: int, cauchy_c: float, sc: bool, kf_ex_idx: int,
                     min_track: int, n_steps: int):
    """Segment A of the steady tick, with no host synchronisation: dead
    reckoning of slot W → packet insertion → parallax keyframe decision on
    the device → stereo + multiview triangulation → preintegration → LM
    window solve → gauge fix → failure soft reset → the `post` snapshot.
    Returns (ws, book_img, book_evt, preints, post)."""
    W = WINDOW
    preints = pre.preintegrate_batch(
        imu_dt, imu_acc, imu_gyr, a0s, g0s, ws.Ba[:W], ws.Bg[:W],
        imu_params, imu_mask, n_steps=n_steps)

    # dead-reckon the incoming frame from interval W (slot W-1); a tick
    # without IMU copies the previous state (_propagate_new_frame)
    p9 = preints.index(W - 1)
    Qk = lie.quat_normalize(lie.quat_mul(ws.Q[W - 1], p9.delta_q))
    Vk = ws.V[W - 1] + lie.quat_rotate(ws.Q[W - 1], p9.delta_v) - g * p9.sum_dt
    Pk = ws.P[W - 1] + ws.V[W - 1] * p9.sum_dt \
        + lie.quat_rotate(ws.Q[W - 1], p9.delta_p) - 0.5 * g * p9.sum_dt ** 2
    ok_prop = torch.any(imu_mask[W - 1])
    ws = _replace_rows(ws, W, dict(
        P=torch.where(ok_prop, Pk, ws.P[W - 1]),
        Q=torch.where(ok_prop, Qk, ws.Q[W - 1]),
        V=torch.where(ok_prop, Vk, ws.V[W - 1]),
        Ba=ws.Ba[W - 1], Bg=ws.Bg[W - 1]))

    # packet insertion + keyframe test (stereo_addFeatureCheckParallax):
    # the image book decides when the tick has a frame
    td0 = torch.zeros_like(ws.td)
    book_evt, n_trk, n_drop_e = fm.insert_packet(book_evt, *pkt_evt, td0, W)
    n_drop_i, par_book = torch.zeros_like(n_drop_e), book_evt
    if has_img:
        book_img, n_trk, n_drop_i = fm.insert_packet(book_img, *pkt_img, td0, W)
        par_book = book_img
    mean_par, num = fm.mean_parallax(par_book, W)
    is_old = (n_trk < min_track) | (num == 0) | (mean_par >= min_parallax)

    # triangulation with the stereo extrinsics taken on the device
    rrl_i, trl_i = _stereo_ext_device(ws, 0, 2)
    rrl_e, trl_e = _stereo_ext_device(ws, 1, 3)
    book_img = fm.triangulate_multiview(fm.triangulate_stereo_instant(
        book_img, rrl_i, trl_i, stereo_correction=sc), ws, 0)
    book_evt = fm.triangulate_multiview(fm.triangulate_stereo_instant(
        book_evt, rrl_e, trl_e, stereo_correction=sc), ws, 1)

    # window solve + gauge fix + track-failure pruning
    ref_p0, ref_q0 = ws.P[0], ws.Q[0]
    ws, book_img, book_evt, _costs = gn.solve_window(
        ws, book_img, book_evt, preints, imu_valid, prior, g,
        iters=iters, cauchy_c=cauchy_c, frozen=frozen)
    ws = win.gauge_fix(ws, ref_p0, ref_q0)
    book_img = fm.remove_failures(book_img)
    book_evt = fm.remove_failures(book_evt)

    # failure detection: soft bias/velocity reset (estimator.cpp:1793-1825)
    fail = (torch.linalg.vector_norm(ws.Ba[W]) > 2.5) \
        | (torch.linalg.vector_norm(ws.Bg[W]) > 1.0)
    reset = lambda x: torch.where(fail, torch.zeros_like(x), x)
    ws = dataclasses.replace(ws, Ba=reset(ws.Ba), Bg=reset(ws.Bg),
                             V=reset(ws.V))

    # post snapshot (pre-slide) + keyframe arrays for the pose graph
    kf_book = book_img if kf_ex_idx == 0 else book_evt
    kf_pts, kf_valid = fm.world_points(kf_book, ws, kf_ex_idx)
    kf = W - 2
    post = dict(P=ws.P, Q=ws.Q, V=ws.V, Ba=ws.Ba, Bg=ws.Bg,
                kf_obs=kf_book.obs[:, kf], kf_valid=kf_valid,
                kf_ids=kf_book.ids, kf_pts=kf_pts, kf_un=kf_book.un[:, kf],
                marg_old=is_old, n_trk=n_trk, n_drop_e=n_drop_e,
                n_drop_i=n_drop_i, fail=fail,
                mean_par=mean_par, num=num, prior_valid=prior.valid)
    return ws, book_img, book_evt, preints, post


def _fused_segment_b(marg_old: bool, prior_valid: bool, ws, book_img,
                     book_evt, prior, preints, imu_valid, g, cauchy_c: float):
    """Segment B: marginalize + slide under the keyframe decision that the
    host read from segment A's post.  Both branches take the
    marginalization's float64 eigendecompositions, which check convergence
    on the host, so this segment runs eagerly after the fetch.  Returns
    (ws, book_img, book_evt, prior)."""
    if marg_old:
        prior = marg.marginalize_old(ws, book_img, book_evt, preints,
                                     imu_valid, prior, g, cauchy_c)
        marg_P, marg_Q = ws.P[0], ws.Q[0]
        ws2 = _slide_old_state(ws)
        book_img = fm.slide_old(book_img, marg_P, marg_Q, ws2.P[0], ws2.Q[0],
                                ws.ex_p[0], ws.ex_q[0])
        book_evt = fm.slide_old(book_evt, marg_P, marg_Q, ws2.P[0], ws2.Q[0],
                                ws.ex_p[1], ws.ex_q[1])
        return ws2, book_img, book_evt, prior
    if prior_valid:
        prior = marg.marginalize_second_new(prior)
    return (_slide_second_state(ws),
            fm.slide_second_new(book_img, win.N_STATES - 1),
            fm.slide_second_new(book_evt, win.N_STATES - 1), prior)


def _fused_tick(ws, book_img, book_evt, prior, pkt_evt, pkt_img,
                imu_dt, imu_acc, imu_gyr, a0s, g0s, imu_mask, imu_valid,
                g, frozen, imu_params, min_parallax, *, has_img: bool,
                iters: int, cauchy_c: float, sc: bool, kf_ex_idx: int,
                min_track: int, n_steps: int):
    """The whole steady NON_LINEAR tick (esvio_tpu/vio/estimator.py
    `_fused_tick`, same arguments plus the preintegration's step count):
    segment A, the one host fetch of `post`, segment B.

    pkt_evt / pkt_img: (ids, valid, un, vel, right_valid, un_r, vel_r)
    tuples of tensors; pkt_img is ignored when has_img=False.  Returns
    (ws', book_img', book_evt', prior', post) with post in numpy."""
    ws, book_img, book_evt, preints, post = _fused_segment_a(
        ws, book_img, book_evt, prior, pkt_evt, pkt_img, imu_dt, imu_acc,
        imu_gyr, a0s, g0s, imu_mask, imu_valid, g, frozen, imu_params,
        min_parallax, has_img=has_img, iters=iters, cauchy_c=cauchy_c, sc=sc,
        kf_ex_idx=kf_ex_idx, min_track=min_track, n_steps=n_steps)
    post = fetch_post(*pack_post(post))
    ws, book_img, book_evt, prior = _fused_segment_b(
        bool(post["marg_old"]), bool(post["prior_valid"]), ws, book_img,
        book_evt, prior, preints, imu_valid, g, cauchy_c)
    return ws, book_img, book_evt, prior, post


def _steps_bucket(n: int, capacity: int) -> int:
    """The preintegration's step count for a longest interval of n samples:
    the next power of two from 16, at most the capacity, so a few CUDA
    graphs cover every tick (the masked steps past n are no-ops)."""
    return min(capacity, max(16, 1 << (max(n, 1) - 1).bit_length()))


class Estimator:
    """Host-side estimator holding device tensors + numpy IMU buffers."""

    def __init__(self, cfg: EstimatorConfig, ex_p, ex_q, device="cuda",
                 imu_params: Optional[pre.ImuParams] = None):
        if cfg.estimate_extrinsic == 2:
            raise NotImplementedError(
                "online extrinsic calibration is not ported (ROADMAP 1.10)")
        self.cfg = cfg
        self.device = torch.device(device)
        dt = cfg.dtype
        self.ws = dataclasses.replace(
            win.init_window(self.device, dt),
            ex_p=torch.as_tensor(np.asarray(ex_p), dtype=dt, device=self.device),
            ex_q=torch.as_tensor(np.asarray(ex_q), dtype=dt, device=self.device))
        self.book_img = win.empty_book(cfg.img_capacity, self.device, dt)
        self.book_evt = win.empty_book(cfg.evt_capacity, self.device, dt)
        self.prior = gn.empty_prior(self.device, dt)
        self.imu_params = imu_params or pre.make_imu_params(
            g_norm=cfg.g_norm, dtype=dt, device=self.device)
        self.g = torch.tensor([0.0, 0.0, cfg.g_norm], dtype=dt, device=self.device)

        self.frame_count = 0
        self.solver_flag = "INITIAL"
        self.timestamps = np.zeros(win.N_STATES)
        C = cfg.imu_capacity
        self.imu_dt = np.zeros((win.N_STATES, C))
        self.imu_acc = np.zeros((win.N_STATES, C, 3))
        self.imu_gyr = np.zeros((win.N_STATES, C, 3))
        self.imu_n = np.zeros(win.N_STATES, np.int32)
        self.acc0 = np.zeros(3)
        self.gyr0 = np.zeros(3)
        self.first_imu = False
        self.last_marg = MARGIN_OLD
        self.failures = 0
        self._prior_valid = False
        self._seen_img = False
        self._post = None
        self.n_solves = 0
        self.n_relo_solves = 0
        self.lanes_dropped = 0
        self._latest = None
        self._imu_replay = []
        self._relo = None
        self._update_stereo_extrinsics()
        # segment A of the fused tick as CUDA graphs on the card
        self._graphs = TickGraphs(self.device) \
            if self.device.type == "cuda" else None

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.cfg.dtype,
                               device=self.device)

    def _update_stereo_extrinsics(self):
        """Cached left→right transforms from the window extrinsics (float64
        on the host, as the JAX package computes them)."""
        self._rrl, self._trl = {}, {}
        ex_q = _np(self.ws.ex_q).astype(np.float64)
        ex_p = _np(self.ws.ex_p).astype(np.float64)
        for name, (l, r) in (("img", (0, 2)), ("evt", (1, 3))):
            Rl = _np(lie.quat_to_rot(torch.from_numpy(ex_q[l])))
            Rr = _np(lie.quat_to_rot(torch.from_numpy(ex_q[r])))
            self._rrl[name] = self._t(Rr.T @ Rl)
            self._trl[name] = self._t(Rr.T @ (ex_p[l] - ex_p[r]))

    # ------------------------------------------------------------------ IMU
    def process_imu(self, dt: float, acc, gyr):
        """Buffer one IMU sample into the current interval (processIMU)."""
        if not self.first_imu:
            self.first_imu = True
            self.acc0 = np.asarray(acc, float)
            self.gyr0 = np.asarray(gyr, float)
            return
        k = self.frame_count
        n = self.imu_n[k]
        if n < self.cfg.imu_capacity:
            self.imu_dt[k, n] = dt
            self.imu_acc[k, n] = acc
            self.imu_gyr[k, n] = gyr
            self.imu_n[k] = n + 1
        self.acc0 = np.asarray(acc, float)
        self.gyr0 = np.asarray(gyr, float)

    def _predict_step(self, s, t_k, acc, gyr, g):
        dt = t_k - s["t"]
        if 0 < dt <= 1.0:
            un_acc_0 = lie_np.quat_rotate(s["Q"], s["acc"] - s["Ba"]) - g
            un_gyr = 0.5 * (s["gyr"] + gyr) - s["Bg"]
            s["Q"] = lie_np.quat_normalize(
                lie_np.quat_mul(s["Q"], lie_np.delta_q(un_gyr * dt)))
            un_acc_1 = lie_np.quat_rotate(s["Q"], acc - s["Ba"]) - g
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            s["P"] = s["P"] + dt * s["V"] + 0.5 * dt * dt * un_acc
            s["V"] = s["V"] + dt * un_acc
        s["t"], s["acc"], s["gyr"] = t_k, acc, gyr

    def _init_latest(self, t, acc, gyr):
        self._latest = dict(t=float(t), P=np.zeros(3), Q=np.array([1.0, 0, 0, 0]),
                            V=np.zeros(3), Ba=np.zeros(3), Bg=np.zeros(3),
                            acc=acc, gyr=gyr)
        if self.solver_flag == "NON_LINEAR":
            self._seed_latest_from_window(float(t))

    def predict(self, t: float, acc, gyr):
        """IMU-rate low-latency state propagation (predict()): midpoint
        integration of the latest state by one sample, in numpy."""
        acc = np.asarray(acc, float)
        gyr = np.asarray(gyr, float)
        self._imu_replay.append((float(t), acc, gyr))
        if self._latest is None:
            self._init_latest(t, acc, gyr)
        s = self._latest
        self._predict_step(s, float(t), acc, gyr,
                           np.array([0.0, 0.0, self.cfg.g_norm]))
        return s["P"].copy(), s["Q"].copy(), s["V"].copy()

    def process_imu_and_predict(self, ts, accs, gyrs, prev_t):
        """Buffer every sample of (prev_t, t] into the current interval AND
        propagate the IMU-rate state through them (imu_callback, batched).
        Returns (P (n,3), Q (n,4), V (n,3)) numpy."""
        ts = np.asarray(ts, float)
        accs = np.asarray(accs, float)
        gyrs = np.asarray(gyrs, float)
        n = len(ts)
        if n == 0:
            return np.zeros((0, 3)), np.zeros((0, 4)), np.zeros((0, 3))
        dts = np.diff(np.concatenate([[prev_t], ts]))
        i0 = 0
        if not self.first_imu:
            self.first_imu = True
            i0 = 1
        m = n - i0
        if m > 0:
            k = self.frame_count
            cur = int(self.imu_n[k])
            take = min(m, self.cfg.imu_capacity - cur)
            if take > 0:
                self.imu_dt[k, cur:cur + take] = dts[i0:i0 + take]
                self.imu_acc[k, cur:cur + take] = accs[i0:i0 + take]
                self.imu_gyr[k, cur:cur + take] = gyrs[i0:i0 + take]
                self.imu_n[k] = cur + take
        self.acc0 = accs[-1].copy()
        self.gyr0 = gyrs[-1].copy()

        P_out = np.empty((n, 3))
        Q_out = np.empty((n, 4))
        V_out = np.empty((n, 3))
        g = np.array([0.0, 0.0, self.cfg.g_norm])
        self._imu_replay.extend((float(ts[k]), accs[k], gyrs[k]) for k in range(n))
        if self._latest is None:
            self._init_latest(ts[0], accs[0], gyrs[0])
        s = self._latest
        for k in range(n):
            self._predict_step(s, float(ts[k]), accs[k], gyrs[k], g)
            P_out[k], Q_out[k], V_out[k] = s["P"], s["Q"], s["V"]
        return P_out, Q_out, V_out

    def _seed_latest_from_window(self, t):
        k = min(self.frame_count, WINDOW)
        src = self._post if self._post is not None else {
            n: _np(getattr(self.ws, n)) for n in ("P", "Q", "V", "Ba", "Bg")}
        self._latest.update(t=t, **{n: np.asarray(src[n][k], float)
                                    for n in ("P", "Q", "V", "Ba", "Bg")})

    def update_latest(self):
        """Re-seed the IMU-rate state from the newest solved frame and replay
        the buffered samples since its stamp (update())."""
        if self._latest is None or self.solver_flag != "NON_LINEAR":
            return
        k = min(self.frame_count, WINDOW)
        t_frame = float(self.timestamps[k])
        replay = [(t, a, w) for (t, a, w) in self._imu_replay if t > t_frame]
        self._seed_latest_from_window(t_frame)
        self._imu_replay = []
        for (t, a, w) in replay:
            self.predict(t, a, w)

    def _interval_first_sample(self, k):
        """acc_0/gyr_0 linearization sample of interval k: last of k-1."""
        if k == 0 or self.imu_n[k - 1] == 0:
            if self.imu_n[k] > 0:
                return self.imu_acc[k, 0], self.imu_gyr[k, 0]
            return np.zeros(3), np.zeros(3)
        m = self.imu_n[k - 1] - 1
        return self.imu_acc[k - 1, m], self.imu_gyr[k - 1, m]

    def _window_imu(self):
        """(a0s, g0s, mask) of the 10 window intervals (k=1..10 → slots
        0..9), numpy."""
        a0s = np.zeros((WINDOW, 3))
        g0s = np.zeros((WINDOW, 3))
        for k in range(1, win.N_STATES):
            a0s[k - 1], g0s[k - 1] = self._interval_first_sample(k)
        mask = np.arange(self.cfg.imu_capacity)[None, :] < self.imu_n[1:, None]
        return a0s, g0s, mask

    def _preintegrate_all(self, ba=None, bg=None):
        """Preintegrate all 10 window intervals (k=1..10 → slots 0..9)."""
        a0s, g0s, mask = self._window_imu()
        ba_all = self.ws.Ba[:WINDOW] if ba is None \
            else self._t(ba)[None].repeat(WINDOW, 1)
        bg_all = self.ws.Bg[:WINDOW] if bg is None \
            else self._t(bg)[None].repeat(WINDOW, 1)
        return pre.preintegrate_batch(
            self._t(self.imu_dt[1:]), self._t(self.imu_acc[1:]),
            self._t(self.imu_gyr[1:]), self._t(a0s), self._t(g0s),
            ba_all, bg_all, self.imu_params, self._t(mask, torch.bool),
            n_steps=int(self.imu_n[1:].max()))

    def _propagate_new_frame(self, k):
        """Dead-reckon the pose of frame k from frame k-1 via interval k."""
        ws = self.ws
        if k == 0 or self.imu_n[k] == 0:
            if k > 0:
                self.ws = _replace_rows(ws, k, {n: getattr(ws, n)[k - 1]
                                                for n in ("P", "Q", "V", "Ba", "Bg")})
            return
        a0, g0 = self._interval_first_sample(k)
        mask = np.arange(self.cfg.imu_capacity) < int(self.imu_n[k])
        p = pre.preintegrate_batch(
            self._t(self.imu_dt[k][None]), self._t(self.imu_acc[k][None]),
            self._t(self.imu_gyr[k][None]), self._t(a0[None]),
            self._t(g0[None]), ws.Ba[k - 1][None], ws.Bg[k - 1][None],
            self.imu_params, self._t(mask[None], torch.bool),
            n_steps=int(self.imu_n[k])).index(0)
        Qk = lie.quat_normalize(lie.quat_mul(ws.Q[k - 1], p.delta_q))
        Vk = ws.V[k - 1] + lie.quat_rotate(ws.Q[k - 1], p.delta_v) \
            - self.g * p.sum_dt
        Pk = ws.P[k - 1] + ws.V[k - 1] * p.sum_dt \
            + lie.quat_rotate(ws.Q[k - 1], p.delta_p) \
            - 0.5 * self.g * p.sum_dt ** 2
        self.ws = _replace_rows(ws, k, dict(P=Pk, Q=Qk, V=Vk, Ba=ws.Ba[k - 1],
                                            Bg=ws.Bg[k - 1]))

    # ------------------------------------------------------------- features
    def _insert(self, book, packet, frame_idx):
        """td_obs ≡ 0: frames stay anchored at their claimed stamps (see the
        JAX estimator's _insert for the convention)."""
        dev = self.device
        t = lambda a, dt=self.cfg.dtype: torch.as_tensor(a, device=dev).to(dt)
        return fm.insert_packet(
            book, t(packet.ids, torch.int32), t(packet.valid, torch.bool),
            t(packet.un), t(packet.vel), t(packet.right_valid, torch.bool),
            t(packet.un_right), t(packet.vel_right),
            torch.zeros_like(self.ws.td), frame_idx)

    def _segment_a(self, state, x, **kw):
        """`_fused_segment_a` on state (ws, book_img, book_evt, prior) and
        the per-tick input tensors x (order of `_input_dtypes`)."""
        n = 14 if kw["has_img"] else 7
        pe = tuple(x[:7])
        pi = tuple(x[7:n]) if kw["has_img"] else pe
        r = x[n:]
        return _fused_segment_a(*state, pe, pi, *r[:6], r[6], self.g, r[7],
                                self.imu_params, r[8], **kw)

    def _process_packets_fused(self, t: float, pkt_evt, pkt_img) -> Output:
        """Steady NON_LINEAR tick through `_fused_tick`: segment A (a CUDA
        graph replay on the card, eager on the CPU), the one fetch, segment
        B.  The host work is numpy: IMU rings, stamps, output packing."""
        cfg = self.cfg
        self.timestamps[WINDOW] = t
        a0s, g0s, mask = self._window_imu()
        has_img = pkt_img is not None
        if has_img:
            self._seen_img = True
        kw = dict(has_img=has_img, iters=cfg.solver_iters, cauchy_c=cfg.cauchy_c,
                  sc=cfg.use_stereo_correction,
                  kf_ex_idx=1 if (cfg.mode == "esio" or not self._seen_img) else 0,
                  min_track=cfg.min_track_for_kf,
                  n_steps=_steps_bucket(int(self.imu_n[1:].max()),
                                        cfg.imu_capacity))
        pkts = (pkt_evt, pkt_img) if has_img else (pkt_evt,)
        inputs = tuple(getattr(p, f) for p in pkts for f in _PKT_FIELDS) + (
            self.imu_dt[1:], self.imu_acc[1:], self.imu_gyr[1:], a0s, g0s,
            mask, self._imu_valid(), self._frozen_mask(),
            np.asarray(cfg.min_parallax))
        dtypes = _input_dtypes(cfg.dtype, has_img)
        state = (self.ws, self.book_img, self.book_evt, self.prior)
        if self._graphs is None:
            x = [torch.as_tensor(v, device=self.device).to(d)
                 for v, d in zip(inputs, dtypes)]
            ws, bi, be, preints, post_d = self._segment_a(state, x, **kw)
            packed, layout = pack_post(post_d)
        else:
            x, (ws, bi, be), preints, packed, layout = self._graphs.run(
                tuple(sorted(kw.items())), functools.partial(self._segment_a, **kw),
                state, inputs, dtypes)
        post = fetch_post(packed, layout)          # the ONE fetch of this tick
        marg_flag = MARGIN_OLD if bool(post["marg_old"]) else MARGIN_SECOND_NEW
        state = _fused_segment_b(
            marg_flag == MARGIN_OLD, bool(post["prior_valid"]), ws, bi, be,
            self.prior, preints, x[7 * len(pkts) + 6], self.g, cfg.cauchy_c)
        if self._graphs is not None:
            state = self._graphs.adopt(state)
        self.ws, self.book_img, self.book_evt, self.prior = state
        self.last_marg = marg_flag
        self.failures += int(post["fail"])
        self.lanes_dropped += int(post["n_drop_e"]) + int(post["n_drop_i"])
        post["n_tracked"] = int(post["n_trk"])
        keyframe = self._keyframe_snapshot(post) \
            if marg_flag == MARGIN_OLD else None
        if marg_flag == MARGIN_OLD:
            self._prior_valid = True
        self._slide_host(marg_flag)
        self._post = post
        return self._output(t, marg_flag, post=post, keyframe=keyframe)

    def process_packets(self, t: float, pkt_evt, pkt_img=None) -> Output:
        """Main measurement step (Stereo_processVisual, estimator.cpp:204-308):
        the fused tick once the window is full and NON_LINEAR, else the
        general multi-dispatch path.  pkt_img: the tick's image packet
        (ESVIO), None when no frame came with it."""
        cfg = self.cfg
        # a tick with a pending relocalization takes the general path
        if (cfg.fused and self.solver_flag == "NON_LINEAR"
                and self._relo is None and self.frame_count == WINDOW):
            return self._process_packets_fused(t, pkt_evt, pkt_img)
        if cfg.estimate_extrinsic:
            self._update_stereo_extrinsics()
        fc = self.frame_count
        self.timestamps[fc] = t
        if fc > 0:
            self._propagate_new_frame(fc)

        self.book_evt, n_trk_e, n_drop_e = self._insert(self.book_evt, pkt_evt, fc)
        fetch = dict(n_trk=n_trk_e, n_drop_e=n_drop_e)
        par_book = self.book_evt
        if pkt_img is not None:
            self._seen_img = True
            self.book_img, fetch["n_trk"], fetch["n_drop_i"] = self._insert(
                self.book_img, pkt_img, fc)
            par_book = self.book_img
        if fc >= 2:
            fetch["mean_par"], fetch["num"] = fm.mean_parallax(par_book, fc)
        vals = {k: v.item() for k, v in fetch.items()}  # one round of fetches
        self.lanes_dropped += int(vals["n_drop_e"]) + int(vals.get("n_drop_i", 0))
        n_tracked = int(vals["n_trk"])

        # keyframe test (stereo_addFeatureCheckParallax :416-425)
        if fc < 2 or n_tracked < cfg.min_track_for_kf:
            marg_flag = MARGIN_OLD
        elif int(vals["num"]) == 0 or float(vals["mean_par"]) >= cfg.min_parallax:
            marg_flag = MARGIN_OLD
        else:
            marg_flag = MARGIN_SECOND_NEW
        self.last_marg = marg_flag

        if self.solver_flag == "INITIAL":
            if fc < WINDOW:
                self.frame_count += 1
                return self._output(t, marg_flag)
            # Only the stereo bootstrap is ported: when it fails the window
            # slides and the next tick retries; the monocular GlobalSFM
            # fallback of the JAX estimator is ROADMAP 1.10.
            if not self._try_initialize():
                self._slide(MARGIN_OLD)
                return self._output(t, marg_flag)
            self.solver_flag = "NON_LINEAR"

        self._triangulate()
        preints = self._preintegrate_all()
        imu_valid = self._t(self._imu_valid(), torch.bool)
        ref_p0, ref_q0 = self.ws.P[0], self.ws.Q[0]
        frozen = self._t(self._frozen_mask(), torch.bool)
        relo_prep = self._prepare_relo()
        if relo_prep is not None and relo_prep["n"] >= 8:
            # in-window relocalization: the old keyframe's pose is a block
            # refined jointly with the window (estimator.cpp:1988-2022),
            # seeded from the matched window frame's own pose (setReloFrame,
            # estimator.cpp:2789): the payload's pose is in the
            # loop-corrected world, not the VIO frame of the solve
            ri = relo_prep["i"]
            (self.ws, self.book_img, self.book_evt, _costs, rP, rQ) = \
                gn.solve_window_relo(
                    self.ws, self.book_img, self.book_evt, preints, imu_valid,
                    self.prior, self.g, self.ws.P[ri], self.ws.Q[ri],
                    self._t(relo_prep["obs"]),
                    self._t(relo_prep["lanes"], torch.int64),
                    self._t(relo_prep["valid"], torch.bool),
                    relo_book=relo_prep["book"], iters=cfg.solver_iters,
                    cauchy_c=cfg.cauchy_c, frozen=frozen)
            # the gauge correction applies to the relo pose too (:1652-1695)
            rot, q_rot, p0 = win.gauge_transform(self.ws, ref_p0, ref_q0)
            relo_prep["refined"] = (
                rot @ (rP - p0) + ref_p0,
                lie.quat_normalize(lie.quat_mul(q_rot, rQ)))
            self.n_relo_solves += 1
        else:
            self.ws, self.book_img, self.book_evt, _costs = gn.solve_window(
                self.ws, self.book_img, self.book_evt, preints, imu_valid,
                self.prior, self.g, iters=cfg.solver_iters,
                cauchy_c=cfg.cauchy_c, frozen=frozen)
        self.ws = win.gauge_fix(self.ws, ref_p0, ref_q0)
        if cfg.estimate_extrinsic:
            self._update_stereo_extrinsics()
        self.book_img = fm.remove_failures(self.book_img)
        self.book_evt = fm.remove_failures(self.book_evt)
        post = self._post_fetch(marg_flag, n_tracked)
        self._failure_detection(post)
        relo = self._finish_relo(relo_prep)
        keyframe = self._keyframe_snapshot(post) \
            if marg_flag == MARGIN_OLD else None

        if marg_flag == MARGIN_OLD:
            self.prior = marg.marginalize_old(
                self.ws, self.book_img, self.book_evt, preints, imu_valid,
                self.prior, self.g, cfg.cauchy_c)
            self._prior_valid = True
        elif self._prior_valid:
            self.prior = marg.marginalize_second_new(self.prior)
        self._slide(marg_flag)
        self._post = post
        return self._output(t, marg_flag, post=post, keyframe=keyframe,
                            relo=relo)

    # ------------------------------------------------------- initialization
    def _try_initialize(self) -> bool:
        """Stereo-depth PnP-chain bootstrap + visual-IMU alignment
        (initialStructureStereo, estimator.cpp:706-856 + :1170-1264)."""
        cfg = self.cfg
        dt = cfg.dtype
        # the image book once it holds features (ESVIO), else the event one
        book, ex_idx, name = (self.book_img, 0, "img") \
            if cfg.mode == "esvio" and bool(torch.any(self.book_img.active)) \
            else (self.book_evt, 1, "evt")
        Rex_np = _np(lie.quat_to_rot(self.ws.ex_q[ex_idx]))
        tex_n = _np(self.ws.ex_p[ex_idx])

        preints = self._preintegrate_all(ba=np.zeros(3), bg=np.zeros(3))
        un = _np(book.un)
        obs = _np(book.obs)
        stereo = _np(book.stereo)
        active = _np(book.active)

        Z = _np(fm.stereo_depth_table(book.un, book.un_r, book.stereo,
                                      self._rrl[name], self._trl[name]))
        anc = np.where(obs & stereo, np.arange(win.N_STATES)[None, :], -1)
        anchor_upto = np.maximum.accumulate(anc, axis=1)

        R_wc = [np.eye(3)]
        t_wc = [np.zeros(3)]
        dq = _np(lie.quat_to_rot(preints.delta_q))
        dR_cam = [Rex_np.T @ dq[k] @ Rex_np for k in range(win.N_STATES - 1)]

        def rot_angle_deg(Ra, Rb):
            c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
            return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))

        def translation_only(R_cw, pts_w, obs2):
            """Linear LS for t given a fixed rotation."""
            P3 = np.asarray(pts_w)
            O2 = np.asarray(obs2)
            rp = P3 @ R_cw.T
            A = np.zeros((2 * len(P3), 3))
            b = np.zeros(2 * len(P3))
            A[0::2, 0] = 1.0
            A[0::2, 2] = -O2[:, 0]
            b[0::2] = O2[:, 0] * rp[:, 2] - rp[:, 0]
            A[1::2, 1] = 1.0
            A[1::2, 2] = -O2[:, 1]
            b[1::2] = O2[:, 1] * rp[:, 2] - rp[:, 1]
            return np.linalg.lstsq(A, b, rcond=None)[0]

        def hybrid_step(f):
            """E-matrix rotation + depth-anchored metric translation f-1 → f
            (solveRelativeHybrid, solve_5pts.cpp:247-302)."""
            corr = active & obs[:, f - 1] & obs[:, f]
            if corr.sum() < 12:
                return None
            depth1 = np.where(corr, Z[:, f - 1], -1.0)
            key = prng.PRNGKey((f * 9973 + 17) & 0x7FFFFFFF, self.device)
            ok, R12, t12, _ = relative_pose.solve_relative_hybrid(
                key, self._t(un[:, f - 1]), self._t(un[:, f]), self._t(depth1),
                self._t(corr, torch.bool))
            if not bool(ok):
                return None
            R12, t12 = _np(R12), _np(t12)
            return R_wc[f - 1] @ R12, R_wc[f - 1] @ t12 + t_wc[f - 1]

        for f in range(1, win.N_STATES):
            a = anchor_upto[:, f - 1]
            sel = active & obs[:, f] & (a >= 0) \
                & (Z[np.arange(len(a)), np.maximum(a, 0)] > 0)
            idxs = np.nonzero(sel)[0]
            if len(idxs):
                zs = Z[idxs, a[idxs]]
                pc = np.stack([un[idxs, a[idxs], 0] * zs,
                               un[idxs, a[idxs], 1] * zs, zs], -1)
                Rw = np.stack([R_wc[e] for e in a[idxs]])
                tw = np.stack([t_wc[e] for e in a[idxs]])
                pts_w = list(np.einsum("nij,nj->ni", Rw, pc) + tw)
                obs2 = list(un[idxs, f])
            else:
                pts_w, obs2 = [], []
            R_pred = R_wc[f - 1] @ dR_cam[f - 1]

            def rot_gated(R_new, t_new, pts_w=pts_w, obs2=obs2, R_pred=R_pred):
                """Keep the visual rotation only when it agrees with the gyro;
                otherwise the gyro rotation + a linear translation."""
                if rot_angle_deg(R_new, R_pred) <= _GYRO_GATE_DEG:
                    return R_new, t_new
                if len(pts_w) >= 6:
                    t_cam = translation_only(R_pred.T, pts_w, obs2)
                    return R_pred, -R_pred @ t_cam
                return R_pred, t_new

            if len(pts_w) < 6:
                alt = hybrid_step(f)
                if alt is None:
                    return False
                Rg, tg = rot_gated(alt[0], alt[1])
                R_wc.append(Rg)
                t_wc.append(tg)
                continue
            pts_p, obs_p, val_p = pnp.pad_points(pts_w, obs2,
                                                 min_size=int(un.shape[0]))
            t0 = t_wc[f - 1]
            best = None
            for R0 in (R_pred.T, R_wc[f - 1].T):
                R_c, tt_c, err_c = pnp.pnp_gn(
                    self._t(pts_p), self._t(obs_p), self._t(val_p, torch.bool),
                    self._t(R0), self._t(t0), iters=15)
                err_c = float(err_c)
                if best is None or err_c < best[2]:
                    best = (R_c, tt_c, err_c)
            R, tt, err = best
            if err > 5.0 / win.FOCAL:
                alt = hybrid_step(f)
                if alt is None:
                    return False
                Rg, tg = rot_gated(alt[0], alt[1])
                R_wc.append(Rg)
                t_wc.append(tg)
                continue
            Rg, tg = rot_gated(_np(R).T, _np(tt))
            R_wc.append(Rg)
            t_wc.append(tg)

        Rs_body = np.stack([Rc @ Rex_np.T for Rc in R_wc])
        T_cam = np.stack(t_wc)
        dbg = alignment.solve_gyroscope_bias(
            self._t(Rs_body),
            preints.jacobian[:, pre.O_R:pre.O_R + 3, pre.O_BG:pre.O_BG + 3],
            preints.delta_q)
        bg = _np(dbg)
        # a solved bias ≫ any real MEMS gyro bias means corrupt visual
        # rotations — fail init and retry on the next window
        if np.linalg.norm(bg) > 0.15:
            return False
        preints = self._preintegrate_all(ba=np.zeros(3), bg=bg)
        ok, g_b0, v_body = alignment.linear_alignment_with_depth(
            self._t(Rs_body), self._t(T_cam), preints.delta_p, preints.delta_v,
            preints.sum_dt, self._t(tex_n), cfg.g_norm)
        if not bool(ok):
            return False
        return self._apply_alignment(Rs_body, T_cam, _np(v_body), g_b0, bg, tex_n)

    def _apply_alignment(self, Rs_body, T_cam, v_body, g_b0, bg, tex_n) -> bool:
        """Gravity-align the world frame and write the window state
        (visualInitialAlign{,WithDepth}, estimator.cpp:1197-1262)."""
        dt = self.cfg.dtype
        R0 = _np(lie.g2R(g_b0))
        yaw = _np(lie.rot_to_ypr(self._t(R0 @ Rs_body[0])))[0]
        R0 = _np(lie.ypr_to_rot(self._t([-yaw, 0.0, 0.0]))) @ R0
        Rs_w = np.einsum("ij,fjk->fik", R0, Rs_body)
        P_w = (T_cam @ R0.T) - np.einsum("fij,j->fi", Rs_w, tex_n)
        P_w = P_w - P_w[0]
        V_w = np.einsum("fij,fj->fi", Rs_w, v_body)
        Q_w = lie.rot_to_quat(self._t(Rs_w))
        self.ws = dataclasses.replace(
            self.ws, P=self._t(P_w), Q=Q_w, V=self._t(V_w),
            Ba=torch.zeros((win.N_STATES, 3), dtype=dt, device=self.device),
            Bg=self._t(bg)[None].repeat(win.N_STATES, 1))
        # depths are re-triangulated with the aligned poses
        for name in ("book_img", "book_evt"):
            b = getattr(self, name)
            setattr(self, name, dataclasses.replace(
                b, depth_valid=torch.zeros_like(b.depth_valid),
                inv_depth=torch.zeros_like(b.inv_depth)))
        return True

    # ------------------------------------------------------------- helpers
    def _triangulate(self):
        sc = self.cfg.use_stereo_correction
        for name, key, ex_idx in (("book_img", "img", 0), ("book_evt", "evt", 1)):
            b = fm.triangulate_stereo_instant(getattr(self, name), self._rrl[key],
                                              self._trl[key], stereo_correction=sc)
            setattr(self, name, fm.triangulate_multiview(b, self.ws, ex_idx))

    def _frozen_mask(self):
        """Ceres SetParameterBlockConstant analog (estimator.cpp:1848-1884),
        numpy (DIM_ALL,) bool."""
        cfg = self.cfg
        frozen = np.zeros(win.DIM_ALL, bool)
        if not cfg.estimate_extrinsic:
            frozen[win.OFF_EX:win.OFF_TD] = True
        elif self.n_solves < 30:
            frozen[win.OFF_EX + 12:win.OFF_TD] = True
        if not cfg.estimate_td:
            frozen[win.OFF_TD] = True
        self.n_solves += 1
        return frozen

    def _imu_valid(self):
        """numpy (WINDOW,) bool: intervals whose IMU factor enters."""
        sums = np.array([self.imu_dt[k, :self.imu_n[k]].sum()
                         for k in range(1, win.N_STATES)])
        return (sums > 0) & (sums <= 10.0)

    def _failure_detection(self, post):
        """Soft bias/velocity reset (failureDetection :1793-1825)."""
        if np.linalg.norm(post["Ba"][WINDOW]) > 2.5 \
                or np.linalg.norm(post["Bg"][WINDOW]) > 1.0:
            self.failures += 1
            self.ws = dataclasses.replace(
                self.ws, Ba=torch.zeros_like(self.ws.Ba),
                Bg=torch.zeros_like(self.ws.Bg), V=torch.zeros_like(self.ws.V))
            post.update(V=_np(self.ws.V), Ba=_np(self.ws.Ba), Bg=_np(self.ws.Bg))

    def _slide_host(self, marg_flag):
        """Host (numpy) part of the slide: timestamps + IMU rings."""
        if marg_flag == MARGIN_OLD:
            self.timestamps[:-1] = self.timestamps[1:]
            self.imu_dt[:-1] = self.imu_dt[1:]
            self.imu_acc[:-1] = self.imu_acc[1:]
            self.imu_gyr[:-1] = self.imu_gyr[1:]
            self.imu_n[:-1] = self.imu_n[1:]
            self.imu_n[-1] = 0
        else:
            k = WINDOW
            n9, n10 = self.imu_n[k - 1], self.imu_n[k]
            take = min(int(n10), self.cfg.imu_capacity - int(n9))
            self.imu_dt[k - 1, n9:n9 + take] = self.imu_dt[k, :take]
            self.imu_acc[k - 1, n9:n9 + take] = self.imu_acc[k, :take]
            self.imu_gyr[k - 1, n9:n9 + take] = self.imu_gyr[k, :take]
            self.imu_n[k - 1] = n9 + take
            self.imu_n[k] = 0
            self.timestamps[k - 1] = self.timestamps[k]

    def _slide(self, marg_flag):
        """Window slide (slideWindow, estimator.cpp:2650-2771)."""
        self._slide_host(marg_flag)
        if marg_flag == MARGIN_OLD:
            marg_P, marg_Q = self.ws.P[0], self.ws.Q[0]
            self.ws = _slide_old_state(self.ws)
            ws = self.ws
            self.book_img = fm.slide_old(self.book_img, marg_P, marg_Q, ws.P[0],
                                         ws.Q[0], ws.ex_p[0], ws.ex_q[0])
            self.book_evt = fm.slide_old(self.book_evt, marg_P, marg_Q, ws.P[0],
                                         ws.Q[0], ws.ex_p[1], ws.ex_q[1])
        else:
            self.ws = _slide_second_state(self.ws)
            self.book_img = fm.slide_second_new(self.book_img, win.N_STATES - 1)
            self.book_evt = fm.slide_second_new(self.book_evt, win.N_STATES - 1)

    def _output(self, t, marg_flag, post=None, keyframe=None,
                relo=None) -> Output:
        k = min(self.frame_count, WINDOW)
        if post is not None:
            return Output(t=t, P=post["P"][k].copy(), Q=post["Q"][k].copy(),
                          V=post["V"][k].copy(), solver_flag=self.solver_flag,
                          marg_flag=marg_flag, relo=relo, keyframe=keyframe,
                          n_tracked=post.get("n_tracked"))
        return Output(t=t, P=_np(self.ws.P[k]), Q=_np(self.ws.Q[k]),
                      V=_np(self.ws.V[k]), solver_flag=self.solver_flag,
                      marg_flag=marg_flag, relo=relo)

    def _post_fetch(self, marg_flag, n_tracked):
        """Device→host fetch of what the post-solve host logic needs this
        tick (failure gates, output pose, IMU-rate seed, the keyframe
        snapshot on MARGIN_OLD)."""
        ws = self.ws
        post = {n: _np(getattr(ws, n)) for n in ("P", "Q", "V", "Ba", "Bg")}
        if marg_flag == MARGIN_OLD:
            kf = WINDOW - 2
            book, ex_idx = (self.book_evt, 1) \
                if self.cfg.mode == "esio" or not self._seen_img \
                else (self.book_img, 0)
            pts_w, valid = fm.world_points(book, ws, ex_idx)
            post.update(kf_obs=_np(book.obs[:, kf]), kf_valid=_np(valid),
                        kf_ids=_np(book.ids), kf_pts=_np(pts_w),
                        kf_un=_np(book.un[:, kf]))
        post["n_tracked"] = n_tracked
        return post

    def _keyframe_snapshot(self, post) -> Optional[dict]:
        """Keyframe packet for the pose graph (pubKeyframe semantics: the
        2nd-newest frame, published only on MARGIN_OLD,
        visualization.cpp:408-463): pose + world landmarks observed there."""
        kf = WINDOW - 2
        if "kf_obs" not in post:
            return None
        seen = post["kf_obs"] & post["kf_valid"]
        if seen.sum() == 0:
            return None
        lanes = np.nonzero(seen)[0]
        return dict(stamp=float(self.timestamps[kf]),
                    P=post["P"][kf].copy(), Q=post["Q"][kf].copy(),
                    ids=post["kf_ids"][lanes], pts_w=post["kf_pts"][lanes],
                    un=post["kf_un"][lanes])

    # ----------------------------------------------------- loop closure I/O
    def _loop_book(self):
        """Book of the loop-closure features: the image book in ESVIO once
        it holds features, else the event book.  Returns (book, ex_idx)."""
        if self.cfg.mode == "esio" or not bool(torch.any(self.book_img.active)):
            return self.book_evt, 1
        return self.book_img, 0

    def set_relo_frame(self, stamp, match_ids, match_un, relo_P, relo_Q):
        """Register a fast-relocalization match (setReloFrame,
        estimator.cpp:2773-2792): an old keyframe at pose (relo_P, relo_Q)
        observed the features match_ids at normalized coords match_un."""
        self._relo = dict(
            stamp=float(stamp), ids=np.asarray(match_ids, np.int32),
            un=np.asarray(match_un, float),
            P=np.asarray(relo_P, float), Q=np.asarray(relo_Q, float))

    RELO_CAP = 64   # relo-row capacity of solve_window_relo

    def _prepare_relo(self) -> Optional[dict]:
        """Host-side match of a pending relo frame against the window: stamp
        alignment and feature-id → lane mapping, padded to RELO_CAP.  None
        when no relo is ready; consumes the relo frame once its stamp has
        matched a window frame (single-shot, as setReloFrame)."""
        relo = self._relo
        if relo is None or self.solver_flag != "NON_LINEAR":
            return None
        stamps = self.timestamps[: min(self.frame_count, WINDOW) + 1]
        if relo["stamp"] < stamps[0] - 1e-6:      # slid out of the window
            self._relo = None
            return None
        i = int(np.argmin(np.abs(stamps - relo["stamp"])))
        if abs(stamps[i] - relo["stamp"]) > 1e-4:
            return None                            # not arrived yet
        self._relo = None

        book, ex_idx = self._loop_book()
        ids = _np(book.ids)
        active = _np(book.active)
        lane_of = {int(f): l for l, f in enumerate(ids) if active[l]}
        CAP = self.RELO_CAP
        lanes = np.full(CAP, -1, np.int64)
        obs = np.zeros((CAP, 2))
        n = 0
        for m, fid in enumerate(relo["ids"]):
            l = lane_of.get(int(fid))
            if l is not None and n < CAP:
                lanes[n] = l
                obs[n] = relo["un"][m]
                n += 1
        return dict(i=i, n=n, lanes=lanes, obs=obs,
                    valid=np.arange(CAP) < n, ex_idx=ex_idx,
                    book="img" if ex_idx == 0 else "evt", relo=relo,
                    frame_stamp=float(stamps[i]))

    def _finish_relo(self, prep) -> Optional[dict]:
        """Drift feedback (relative t / q / yaw) from the resolved relo pose.

        Joint path: the pose was refined inside the window solve, and is
        gated by the count of reprojection inliers of the relo rows at the
        refined pose.  Fallback (too few in-window matches): PnP-RANSAC of
        the old keyframe against the window landmarks (`_relo_pnp`)."""
        if prep is None:
            return None
        i = prep["i"]
        if "refined" in prep:
            rP, rQ = prep["refined"]
            book = self.book_img if prep["book"] == "img" else self.book_evt
            r = _np(gn.relo_residuals(
                self.ws, book, prep["ex_idx"], rP, rQ, self._t(prep["obs"]),
                self._t(prep["lanes"], torch.int64),
                self._t(prep["valid"], torch.bool)))
            err = np.linalg.norm(r, axis=1) / float(factors.PROJ_SQRT_INFO)
            if int(((err < 10.0 / 460.0) & prep["valid"]).sum()) < 15:
                return None                   # MIN_LOOP_NUM (keyframe.h:18)
            P_w_old = _np(rP).astype(float)
            R_w_old = _np(lie.quat_to_rot(rQ)).astype(float)
        else:
            pose = self._relo_pnp(prep)
            if pose is None:
                return None
            P_w_old, R_w_old = pose
        P_i = _np(self.ws.P[i]).astype(float)
        R_i = _np(lie.quat_to_rot(self.ws.Q[i])).astype(float)
        rel_t = R_w_old.T @ (P_i - P_w_old)
        rel_R = R_w_old.T @ R_i
        ypr = lambda R: lie_np.rot_to_ypr(R)[0]
        return dict(stamp=prep["relo"]["stamp"], frame_stamp=prep["frame_stamp"],
                    relative_t=rel_t, relative_q=lie_np.rot_to_quat(rel_R),
                    relative_yaw=ypr(R_i) - ypr(R_w_old),
                    P_old=P_w_old, Q_old=lie_np.rot_to_quat(R_w_old))

    def _relo_pnp(self, prep):
        """PnP-RANSAC of the relo pose against the window landmarks (the
        fallback path).  Returns (P_w_old, R_w_old) or None."""
        book, _ = self._loop_book()
        pts_w, valid = fm.world_points(book, self.ws, prep["ex_idx"])
        pts_w, valid = _np(pts_w), _np(valid)
        sel_p, sel_o = [], []
        for m in range(prep["n"]):
            l = int(prep["lanes"][m])
            if valid[l]:
                sel_p.append(pts_w[l])
                sel_o.append(prep["obs"][m])
        if len(sel_p) < 6:
            return None
        ex_idx = prep["ex_idx"]
        Rex = _np(lie.quat_to_rot(self.ws.ex_q[ex_idx])).astype(float)
        tex = _np(self.ws.ex_p[ex_idx]).astype(float)
        # seed: the matched window frame's pose (the loop revisits it; the
        # payload's pose is in the loop-corrected world, not this one)
        i = prep["i"]
        R_old_b = _np(lie.quat_to_rot(self.ws.Q[i])).astype(float)
        R_seed_wc = R_old_b @ Rex
        c_seed = _np(self.ws.P[i]) + R_old_b @ tex
        key = prng.PRNGKey(int(prep["relo"]["stamp"] * 1e3) & 0x7FFFFFFF,
                           self.device)
        sel_pp, sel_op, sel_vp = pnp.pad_points(sel_p, sel_o,
                                                min_size=self.RELO_CAP)
        R_cw, c, inl = pnp.pnp_ransac(
            key, self._t(sel_pp), self._t(sel_op), self._t(sel_vp, torch.bool),
            self._t(R_seed_wc.T), self._t(c_seed))
        if int(torch.sum(inl)) < 15:          # MIN_LOOP_NUM (keyframe.h:18)
            return None
        R_w_old = _np(R_cw).astype(float).T @ Rex.T   # old KF body→world
        return _np(c).astype(float) - R_w_old @ tex, R_w_old
