"""Numpy-only copy of the part of tests/synth.py that the port's sequences
need (`planar_vio_sequence_rot` with the blob or the smooth texture, IMU
biases and noise, optional stereo frames; `sample_texture`), returning the
PyTorch port's `SequenceData`.  It imports neither jax nor esvio_tpu, so it
also runs where JAX is not installed; tests/test_torch_pipeline.py,
tests/test_torch_esvio.py and tests/test_torch_no_jax.py check it against
tests/synth.py bit for bit.
"""
import numpy as np


# exp(-z) is exactly 0.0 in float64 beyond z = 745.14
_EXP_ZERO = 746.0


def blob_texture(rng, H, W, n_blobs=120, margin=80):
    """Binary-ish blob texture with sharp edges, padded by `margin`
    (tests/synth.blob_texture, bit for bit).  Each blob's Gaussian is
    evaluated only where it is not exactly zero in float64; the pixels
    outside would add 0.0, so every sum is the same."""
    HH, WW = H + 2 * margin, W + 2 * margin
    img = np.zeros((HH, WW))
    y, x = np.mgrid[0:HH, 0:WW]
    for _ in range(n_blobs):
        cx = rng.uniform(0, WW)
        cy = rng.uniform(0, HH)
        s = rng.uniform(2, 5)
        r = s * np.sqrt(2.0 * _EXP_ZERO) + 2.0
        x0, x1 = max(0, int(cx - r)), min(WW, int(cx + r) + 2)
        y0, y1 = max(0, int(cy - r)), min(HH, int(cy + r) + 2)
        xs, ys = x[y0:y1, x0:x1], y[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2)
                                    / (2 * s * s))
    img = (img > np.percentile(img, 88)).astype(np.float64) * 200.0 + 20.0
    return img, margin


def sample_texture(tex, margin, H, W, off_x, off_y):
    """View of the texture at sub-pixel offset (bilinear)."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    xs = x + margin + off_x
    ys = y + margin + off_y
    x0 = np.clip(xs.astype(int), 0, tex.shape[1] - 2)
    y0 = np.clip(ys.astype(int), 0, tex.shape[0] - 2)
    fx = xs - x0
    fy = ys - y0
    return (
        tex[y0, x0] * (1 - fy) * (1 - fx) + tex[y0, x0 + 1] * (1 - fy) * fx
        + tex[y0 + 1, x0] * fy * (1 - fx) + tex[y0 + 1, x0 + 1] * fy * fx
    )


def _keys_cubic(x):
    """Keys cubic kernel, a = -0.5 (jax.image.resize's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _bicubic_weights(m, n):
    """(m, n) float32 weights of a bicubic upsampling m → n, computed in
    float64 and rounded as jax.image.resize computes them with x64 on."""
    inv = m / n
    sample_f = (np.arange(n, dtype=np.float64) + 0.5) * inv - 0.5
    w = _keys_cubic(np.abs(sample_f[None, :] - np.arange(m, dtype=np.float64)[:, None]))
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0)
    w = np.where(((sample_f >= -0.5) & (sample_f <= m - 0.5))[None, :], w, 0)
    return w.astype(np.float32)


def _matmul_fma32(A, B):
    """float32 A @ B accumulated in order of the inner index with one
    fused multiply-add per step, as XLA's CPU dot accumulates it (each
    product of two float32 values is exact in float64)."""
    acc = np.zeros((A.shape[0], B.shape[1]), np.float32)
    for k in range(A.shape[1]):
        acc = (A[:, k, None].astype(np.float64) * B[None, k].astype(np.float64)
               + acc).astype(np.float32)
    return acc


def bicubic_upsample(g, H, W):
    """jax.image.resize(g float32, (H, W), "bicubic") bit for bit: the
    columns contracted first, then the rows, each a float32 FMA chain."""
    wy = _bicubic_weights(g.shape[0], H)
    wx = _bicubic_weights(g.shape[1], W)
    return _matmul_fma32(wy.T, _matmul_fma32(g.astype(np.float32), wx))


def bandlimited_texture(rng, H, W, margin=250, cell=6, octaves=3):
    """Smooth band-limited random texture (multi-octave value noise,
    bicubic-upsampled): no step edges (tests/synth.bandlimited_texture)."""
    HH, WW = H + 2 * margin, W + 2 * margin
    img = np.zeros((HH, WW))
    amp = 1.0
    for o in range(octaves):
        c = cell * (2 ** o)
        gh, gw = HH // c + 2, WW // c + 2
        g = rng.normal(size=(gh, gw))
        up = bicubic_upsample(g, gh * c, gw * c)
        img += amp * up[:HH, :WW]
        amp *= 0.6
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return img * 200.0 + 20.0, margin


class ContrastEventModel:
    """ESIM-style per-pixel contrast-threshold event camera
    (tests/synth.ContrastEventModel)."""

    def __init__(self, img0, C=8.0):
        self.ref = img0.astype(np.float64).copy()
        self.C = float(C)

    def step(self, img, t, rng=None):
        d = img - self.ref
        n = np.floor(np.abs(d) / self.C)
        yy, xx = np.nonzero(n >= 1)
        if not len(yy):
            return (np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(0, np.int32), np.zeros(0, np.int32))
        sgn = np.sign(d[yy, xx])
        self.ref[yy, xx] += sgn * n[yy, xx] * self.C
        tt = np.full(len(yy), t)
        if rng is not None:
            tt = tt + rng.uniform(-1e-4, 1e-4, len(yy))
        return tt, xx.astype(np.int32), yy.astype(np.int32), \
            (sgn > 0).astype(np.int32)


def _skew(v):
    z = np.zeros_like(v[..., 0])
    r = np.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                  -v[..., 1], v[..., 0], z], axis=-1)
    return r.reshape(v.shape[:-1] + (3, 3))


def so3_exp(w):
    """Exponential map (..., 3) → rotation matrix (float64, the formula of
    esvio_tpu.core.lie.so3_exp)."""
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(np.maximum(theta2, 1e-24))
    W = _skew(w)
    W2 = W @ W
    s = np.where(theta2 < 1e-12, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    c = np.where(theta2 < 1e-12, 0.5 - theta2 / 24.0,
                 (1.0 - np.cos(theta)) / theta2)
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + s[..., None, None] * W + c[..., None, None] * W2


def _rot_to_quat(R):
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    s0 = np.sqrt(np.maximum(1.0 + tr, 1e-12)) * 2.0
    q0 = np.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                   (m10 - m01) / s0], axis=-1)
    s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
    q1 = np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                   (m02 + m20) / s1], axis=-1)
    s2 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 2.0
    q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                   (m12 + m21) / s2], axis=-1)
    s3 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 2.0
    q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                   0.25 * s3], axis=-1)
    q = np.where((tr > 0.0)[..., None], q0,
                 np.where(((m00 >= m11) & (m00 >= m22))[..., None], q1,
                          np.where((m11 >= m22)[..., None], q2, q3)))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def so3_log(R):
    """Log map rotation matrix → (..., 3) (esvio_tpu.core.lie.so3_log)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    vee = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                    R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    factor = np.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                      theta / np.maximum(2.0 * np.sin(theta), 1e-12))
    w = factor[..., None] * vee
    q = _rot_to_quat(R)
    axis = q[..., 1:] / np.maximum(
        np.linalg.norm(q[..., 1:], axis=-1, keepdims=True), 1e-12)
    w_pi = axis * theta[..., None]
    return np.where((np.pi - theta < 1e-3)[..., None], w_pi, w)


def render_plane(tex, margin, H, W, focal, cx, cy, R_wc, t_wc, plane_z,
                 tex_scale, tex_cx, tex_cy):
    """Render the textured plane z = plane_z seen from pose (R_wc, t_wc)."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(u - cx) / focal, (v - cy) / focal, np.ones_like(u)], -1)
    rays_w = rays @ R_wc.T
    lam = (plane_z - t_wc[2]) / rays_w[..., 2]
    X = t_wc[0] + lam * rays_w[..., 0]
    Y = t_wc[1] + lam * rays_w[..., 1]
    tx = X * tex_scale + tex_cx
    ty = Y * tex_scale + tex_cy
    x0 = np.clip(tx.astype(int), 0, tex.shape[1] - 2)
    y0 = np.clip(ty.astype(int), 0, tex.shape[0] - 2)
    fx = np.clip(tx - x0, 0, 1)
    fy = np.clip(ty - y0, 0, 1)
    return (tex[y0, x0] * (1 - fy) * (1 - fx) + tex[y0, x0 + 1] * (1 - fy) * fx
            + tex[y0 + 1, x0] * fy * (1 - fx) + tex[y0 + 1, x0 + 1] * fy * fx)


# the rig's path in planar_vio_sequence_rot: a circle of PLANAR_RADIUS m at
# PLANAR_HZ, and a roll / pitch wobble at PLANAR_WOBBLE_HZ and 0.77 of it
PLANAR_RADIUS, PLANAR_HZ, PLANAR_WOBBLE_HZ = 0.4, 0.5, 0.9


def planar_rot_position(t):
    """p_wb (N, 3) of planar_vio_sequence_rot's rig t seconds after its
    start."""
    th = 2 * np.pi * PLANAR_HZ * t
    return np.stack([PLANAR_RADIUS * np.sin(th),
                     PLANAR_RADIUS * (np.cos(th) - 1.0), np.zeros_like(t)], -1)


def planar_rot_rotation(t, rot_amp_deg=4.0):
    """R_wb (N, 3, 3) of planar_vio_sequence_rot's rig (its camera axes) t
    seconds after its start."""
    t = np.atleast_1d(t)
    amp = np.deg2rad(rot_amp_deg)
    wr = PLANAR_WOBBLE_HZ
    return so3_exp(np.stack([amp * np.sin(2 * np.pi * wr * t),
                             amp * np.sin(2 * np.pi * wr * 0.77 * t + 1.0),
                             np.zeros_like(t)], -1))


def planar_vio_sequence_rot(rng, H=120, W=160, focal=200.0, plane_z=4.0,
                            baseline=0.10, duration=2.0, imu_hz=200,
                            event_hz=400, g_norm=9.80766, rot_amp_deg=4.0,
                            frame_hz=0, img_H=None, img_W=None, img_focal=None,
                            texture="blob", gyr_bias=None, acc_bias=None,
                            imu_noise_rng=None, gyr_n=0.0, acc_n=0.0):
    """Stereo events + IMU from a camera over a textured plane with a
    pitch/roll wobble (tests/synth.planar_vio_sequence_rot, drawing from
    the rngs as it does), and with frame_hz > 0 stereo frames of
    (img_H, img_W) at focal img_focal (default: the event size and field of
    view).  texture "blob": binary blobs and frame-difference events (the
    goldens); "smooth": the band-limited texture and the contrast event
    model.  gyr_bias/acc_bias: constant IMU biases; gyr_n/acc_n: white
    noise from imu_noise_rng.  Frames draw nothing from rng.  Returns
    (SequenceData, gt_t, gt_P) with the port's SequenceData."""
    from esvio_tpu_torch.io import datasets as ds

    if texture == "smooth":
        tex, margin = bandlimited_texture(rng, H * 2, W * 2, margin=250)
    else:
        tex, margin = blob_texture(rng, H * 2, W * 2, n_blobs=int(H * W / 25),
                                   margin=250)
    tex_scale = focal / plane_z
    tex_cx = tex.shape[1] / 2
    tex_cy = tex.shape[0] / 2
    cx, cy = W / 2, H / 2
    wc, radius = PLANAR_HZ, PLANAR_RADIUS
    pos = planar_rot_position

    def accel_w(t):
        th = 2 * np.pi * wc * t
        k = (2 * np.pi * wc) ** 2
        return np.stack([-k * radius * np.sin(th), -k * radius * np.cos(th),
                         np.zeros_like(t)], -1)

    def rot(t):
        return planar_rot_rotation(t, rot_amp_deg)

    t0 = 1.0
    imu_t = np.arange(t0, t0 + duration, 1.0 / imu_hz)
    Rs = rot(imu_t - t0)
    acc = np.einsum("kij,kj->ki", Rs.transpose(0, 2, 1),
                    accel_w(imu_t - t0) + np.array([0, 0, g_norm]))
    gyr = np.zeros((len(imu_t), 3))
    dt_imu = 1.0 / imu_hz
    for k in range(len(imu_t) - 1):
        gyr[k] = so3_log(Rs[k].T @ Rs[k + 1]) / dt_imu
    gyr[-1] = gyr[-2]
    if gyr_bias is not None:
        gyr = gyr + np.asarray(gyr_bias)[None, :]
    if acc_bias is not None:
        acc = acc + np.asarray(acc_bias)[None, :]
    if imu_noise_rng is not None:
        if gyr_n:
            gyr = gyr + imu_noise_rng.normal(0, gyr_n, gyr.shape)
        if acc_n:
            acc = acc + imu_noise_rng.normal(0, acc_n, acc.shape)

    ev_t = np.arange(t0, t0 + duration, 1.0 / event_hz)

    def gen_events(cam_offset):
        ts, xs, ys, ps = [], [], [], []
        model = None
        prev = None
        for t in ev_t:
            tt = t - t0
            R = rot(tt)[0]
            p = pos(np.atleast_1d(tt))[0] + R @ cam_offset
            img = render_plane(tex, margin, H, W, focal, cx, cy, R, p,
                               plane_z, tex_scale, tex_cx, tex_cy)
            if texture == "smooth":
                # contrast model: sub-threshold motion accumulates
                if model is None:
                    model = ContrastEventModel(img, C=8.0)
                else:
                    et, ex, ey, ep = model.step(img, t, rng)
                    if len(et):
                        ts.append(et)
                        xs.append(ex)
                        ys.append(ey)
                        ps.append(ep)
            elif prev is not None:
                diff = img - prev
                yy, xx = np.nonzero(np.abs(diff) > 8.0)
                if len(yy):
                    ts.append(np.full(len(yy), t)
                              + rng.uniform(-1e-4, 1e-4, len(yy)))
                    xs.append(xx)
                    ys.append(yy)
                    ps.append((diff[yy, xx] > 0).astype(np.int32))
            prev = img
        t_all = np.concatenate(ts)
        order = np.argsort(t_all, kind="stable")
        return (t_all[order], np.concatenate(xs).astype(np.int32)[order],
                np.concatenate(ys).astype(np.int32)[order],
                np.concatenate(ps)[order])

    tl, xl, yl, pl = gen_events(np.zeros(3))
    tr, xr, yr, pr = gen_events(np.array([baseline, 0.0, 0.0]))

    images_l = images_r = None
    if frame_hz:
        fH = img_H or H
        fW = img_W or W
        ff = img_focal or focal * (fW / W)
        f_t = np.arange(t0 + 0.5 / frame_hz, t0 + duration, 1.0 / frame_hz)

        def render_frames(cam_offset):
            frames = np.zeros((len(f_t), fH, fW), np.float32)
            for k, t in enumerate(f_t):
                tt = t - t0
                R = rot(tt)[0]
                p = pos(np.atleast_1d(tt))[0] + R @ cam_offset
                frames[k] = render_plane(tex, margin, fH, fW, ff, fW / 2, fH / 2,
                                         R, p, plane_z, tex_scale, tex_cx,
                                         tex_cy)
            return frames

        images_l = (f_t, render_frames(np.zeros(3)))
        images_r = (f_t, render_frames(np.array([baseline, 0.0, 0.0])))

    seq = ds.SequenceData(
        events_left=ds.EventStream(tl, xl, yl, pl),
        events_right=ds.EventStream(tr, xr, yr, pr),
        imu=ds.ImuStream(imu_t, acc, gyr),
        images_left=images_l, images_right=images_r,
        ground_truth=(imu_t, pos(imu_t - t0)))
    return seq, imu_t, pos(imu_t - t0)


# The golden ESIO configuration (tests/test_golden_trace.py) and the
# pipeline configuration of bench.py, in the port's types.
GOLDEN = dict(H=120, W=160, focal=200.0, duration=1.6)
BENCH = dict(H=240, W=320, focal=320.0, duration=2.4)
FRAME_HZ = 15          # the ESVIO golden's frames (tests/test_golden_trace.py:33)


def vio_sequence(H, W, focal, duration, mode="esio", baseline=0.10,
                 plane_z=4.0, img_H=None, img_W=None):
    """(seq, gt_t, gt_P): the sequence `vio_pipeline` renders for these
    settings (picklable, so another process can render it)."""
    return planar_vio_sequence_rot(
        np.random.default_rng(0), H=H, W=W, focal=focal, plane_z=plane_z,
        baseline=baseline, duration=duration,
        frame_hz=FRAME_HZ if mode == "esvio" else 0, img_H=img_H, img_W=img_W)


def vio_pipeline(device, H, W, focal, duration, mode="esio", baseline=0.10,
                 plane_z=4.0, fused=True, img_H=None, img_W=None,
                 loop_closure=0, sequence=None, config_dir=None):
    """(make_pipeline, seq, gt_t, gt_P): a factory of fresh port pipelines
    on `device` with the settings of the golden trace
    (tests/test_golden_trace.py:31-64, loop closure off unless
    loop_closure=1, as bench.py's pipeline_run has it), and its synthetic
    sequence.  mode "esio" (system_mode 0) or "esvio" (1: stereo frames at
    FRAME_HZ rendered at (img_H, img_W) with the events' field of view,
    default the event size, which the pipeline resizes to the image
    tracker's (H, W)); `fused` picks the estimator's steady tick;
    `sequence`: a (seq, gt_t, gt_P) made earlier with the same settings,
    reused instead of rendered again; `config_dir`: the configuration and
    cameras are written there as reference-style YAML files and the
    pipeline is built from what `io.config.load_config` reads back."""
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    from esvio_tpu_torch.io.config import SystemConfig
    from esvio_tpu_torch.vio import estimator as est_mod

    esvio = mode == "esvio"
    seq, gt_t, gt_P = sequence or vio_sequence(
        H, W, focal, duration, mode, baseline, plane_z, img_H, img_W)
    cam = camera.make_pinhole(focal, focal, W / 2, H / 2, width=W, height=H)
    R = np.eye(3)
    sys_cfg = SystemConfig(
        system_mode=int(esvio), event_width=W, event_height=H, image_width=W,
        image_height=H, R_body_cam0=R, t_body_cam0=np.zeros(3),
        R_body_cam1=R, t_body_cam1=np.array([baseline, 0, 0]),
        R_body_event0=R, t_body_event0=np.zeros(3),
        R_body_event1=R, t_body_event1=np.array([baseline, 0, 0]),
        freq=15, max_cnt=60, min_dist=10, max_cnt_img=60, min_dist_img=10,
        loop_closure=loop_closure)
    tracker_cfg = trk.TrackerConfig(width=W, height=H, capacity=128,
                                    cand_capacity=512, max_cnt=60,
                                    min_dist=10, lk_iters=15)
    est_cfg = est_mod.EstimatorConfig(mode=mode, evt_capacity=256,
                                      img_capacity=256 if esvio else 8,
                                      min_track_for_kf=15, fused=fused)
    cams = {"event0": cam, "event1": cam}
    if esvio:
        cams.update(cam0=cam, cam1=cam)
    if config_dir is not None:
        from esvio_tpu_torch.io.config import load_config
        sys_cfg = load_config(write_config_yamls(config_dir, sys_cfg, cams))
        cams = sys_cfg.cameras

    def make_pipeline():
        return Pipeline(sys_cfg, cams, device, tracker_cfg=tracker_cfg,
                        est_cfg=est_cfg, event_capacity=1 << 15,
                        img_tracker_cfg=tracker_cfg if esvio else None)

    return make_pipeline, seq, gt_t, gt_P


def golden_gates(res, gt_t, gt_P, golden_npz):
    """The gates of tests/test_golden_trace.py against a golden npz:
    returns dict(stamps_ok, n_stamps, max_dev, ate, ate_golden, ate_ok),
    and the deviation once the gauge is removed: `max_dev_4dof` after the
    yaw + translation alignment of the run onto the golden (the four
    degrees of freedom VIO cannot observe, which the yaw-aligned ATE also
    removes), with that alignment's `yaw_deg` and `shift_m`."""
    from esvio_tpu_torch.io.trajectory import _yaw_alignment
    z = np.load(golden_npz)
    stamps = np.asarray(res.stamps)
    out = dict(n_stamps=len(stamps), n_golden=len(z["stamps"]))
    out["stamps_ok"] = bool(len(stamps) == len(z["stamps"]) and np.allclose(
        stamps, z["stamps"], rtol=0.0, atol=1e-6))
    out["max_dev"] = out["max_dev_4dof"] = float("inf")
    out["yaw_deg"] = out["shift_m"] = float("nan")
    if out["stamps_ok"]:
        P = np.asarray(res.P)
        out["max_dev"] = float(np.linalg.norm(P - z["P"], axis=1).max())
        _, R, t = _yaw_alignment(P, z["P"])
        out["max_dev_4dof"] = float(np.linalg.norm(
            P @ R.T + t - z["P"], axis=1).max())
        out["yaw_deg"] = float(np.degrees(np.arctan2(R[1, 0], R[0, 0])))
        out["shift_m"] = float(np.linalg.norm(t))
    out["ate"] = float(res.ate(gt_t, gt_P, alignment="yaw"))
    out["ate_golden"] = float(z["ate"])
    out["ate_ok"] = out["ate"] <= out["ate_golden"] * 1.5 + 0.01
    return out


# The loop-closure sequence of tests/test_e2e_loops.py: the golden geometry
# for 3.6 s (a full revisit of the 2 s circle), smooth texture, IMU biases.
LOOPS = dict(H=120, W=160, focal=200.0, duration=3.6)
LOOP_GYR_BIAS = np.array([0.01, -0.015, 0.008])
LOOP_ACC_BIAS = np.array([0.05, 0.03, -0.08])


def loop_sequence(H=120, W=160, focal=200.0, duration=3.6, baseline=0.10,
                  plane_z=4.0, mode="esio"):
    """(seq, gt_t, gt_P): the sequence `loop_pipeline` renders."""
    return planar_vio_sequence_rot(
        np.random.default_rng(0), H=H, W=W, focal=focal, plane_z=plane_z,
        baseline=baseline, duration=duration, texture="smooth",
        gyr_bias=LOOP_GYR_BIAS, acc_bias=LOOP_ACC_BIAS,
        frame_hz=FRAME_HZ if mode == "esvio" else 0)


def loop_pipeline(device, H=120, W=160, focal=200.0, duration=3.6,
                  motion_correction=False, fused=True, baseline=0.10,
                  plane_z=4.0, mode="esio", sequence=None):
    """(make_pipeline, seq, gt_t, gt_P) of tests/test_e2e_loops.py:31-67 on
    the port: ESIO with loop closure and fast relocalization, the loop
    closer's skip_recent at 12 (the revisit cadence of this sequence), and
    with motion_correction the IMU-aided event warp on.  mode "esvio":
    system_mode 1 with stereo frames at FRAME_HZ rendered from the same
    texture (as vio_pipeline renders them), the loop keyframes taken from
    the left frame.  `sequence`: a (seq, gt_t, gt_P) made earlier with the
    same settings (`loop_sequence`)."""
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    from esvio_tpu_torch.io.config import SystemConfig
    from esvio_tpu_torch.vio import estimator as est_mod

    seq, gt_t, gt_P = sequence or loop_sequence(H, W, focal, duration,
                                                baseline, plane_z, mode)
    esvio = mode == "esvio"
    cam = camera.make_pinhole(focal, focal, W / 2, H / 2, width=W, height=H)
    R = np.eye(3)
    sys_cfg = SystemConfig(
        system_mode=int(esvio), event_width=W, event_height=H, image_width=W,
        image_height=H, R_body_cam0=R, t_body_cam0=np.zeros(3),
        R_body_cam1=R, t_body_cam1=np.array([baseline, 0, 0]),
        R_body_event0=R, t_body_event0=np.zeros(3),
        R_body_event1=R, t_body_event1=np.array([baseline, 0, 0]),
        freq=15, max_cnt=60, min_dist=10, max_cnt_img=60, min_dist_img=10,
        loop_closure=1, fast_relocalization=1,
        do_motion_correction=motion_correction)
    tracker_cfg = trk.TrackerConfig(width=W, height=H, capacity=128,
                                    cand_capacity=512, max_cnt=60,
                                    min_dist=10, lk_iters=15)
    est_cfg = est_mod.EstimatorConfig(mode=mode, evt_capacity=256,
                                      img_capacity=256 if esvio else 8,
                                      min_track_for_kf=15, fused=fused)
    cams = {"event0": cam, "event1": cam}
    if esvio:
        cams.update(cam0=cam, cam1=cam)

    def make_pipeline():
        pipe = Pipeline(sys_cfg, cams, device, tracker_cfg=tracker_cfg,
                        est_cfg=est_cfg, event_capacity=1 << 15,
                        img_tracker_cfg=tracker_cfg if esvio else None)
        pipe.loop_closer.cfg.skip_recent = 12
        pipe.loop_closer.db.skip_recent = 12
        return pipe

    return make_pipeline, seq, gt_t, gt_P


def loop_gates(res, gt_t, gt_P):
    """The gates of tests/test_e2e_loops.py:69-88: returns dict(restarts,
    n_stamps, ate, loops, ate_loop, ate_loop_gate, ok)."""
    from esvio_tpu_torch.io import trajectory as traj_io
    ate = float(res.ate(gt_t, gt_P, alignment="yaw"))
    ate_loop = float(traj_io.ate_rmse(
        np.asarray(res.stamps), np.asarray(res.P_loop), gt_t, gt_P,
        alignment="yaw")) if res.P_loop else float("inf")
    out = dict(restarts=res.n_restarts, n_stamps=len(res.stamps), ate=ate,
               loops=res.n_loops, ate_loop=ate_loop,
               ate_loop_gate=ate * 1.3 + 0.03)
    out["ok"] = (out["restarts"] == 0 and out["n_stamps"] >= 30
                 and ate < 0.3 and out["loops"] >= 1
                 and ate_loop <= out["ate_loop_gate"])
    return out


# ---------------------------------------------------------------------------
# Estimator drives of tests/test_estimator.py: a smooth 6-DoF trajectory
# with its IMU, landmarks around it and feature packets made from them, in
# numpy with the rng draws in the same order as tests/synth.py and
# tests/test_estimator.py.

EST_BASELINE = 0.10     # tests/test_estimator.py BASELINE
N_LM = 300


def _quat_mul(q, p):
    qw, qx, qy, qz = q
    pw, px, py, pz = p
    return np.array([qw * pw - qx * px - qy * py - qz * pz,
                     qw * px + qx * pw + qy * pz - qz * py,
                     qw * py - qx * pz + qy * pw + qz * px,
                     qw * pz + qx * py - qy * px + qz * pw])


def quat_to_rot(q):
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                     [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                     [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]])


def simulate_trajectory(rng, n_frames=11, imu_per_frame=20, frame_dt=0.05,
                        g_w=(0.0, 0.0, 9.80766)):
    """tests/synth.simulate_trajectory: per-frame P/Q/V and the IMU samples
    of a smooth trajectory (sinusoidal world acceleration and body rate,
    midpoint propagation), float64."""
    g_w = np.asarray(g_w)
    dt = frame_dt / imu_per_frame
    n_samples = (n_frames - 1) * imu_per_frame + 1
    tt = np.arange(n_samples) * dt

    def smooth(scale):
        w = rng.normal(size=(3, 3)) * scale
        ph = rng.uniform(0, 2 * np.pi, (3, 3))
        fr = rng.uniform(0.3, 1.5, (3, 3))
        return sum(w[:, k][None, :] * np.sin(
            2 * np.pi * fr[:, k][None, :] * tt[:, None] + ph[:, k][None, :])
            for k in range(3))
    a_w = smooth(1.2)
    w_b = smooth(0.5)

    P = [np.zeros(3)]
    V = [np.array([0.3, -0.2, 0.1])]
    Q = [np.array([1.0, 0, 0, 0])]
    accs = [None] * n_samples
    for k in range(n_samples):
        Rk = quat_to_rot(Q[-1])
        accs[k] = Rk.T @ (a_w[k] + g_w)
        if k == n_samples - 1:
            break
        w_mid = 0.5 * (w_b[k] + w_b[k + 1])
        q_new = _quat_mul(Q[-1], np.concatenate([[1.0], 0.5 * (w_mid * dt)]))
        q_new = q_new / np.linalg.norm(q_new)
        R_new = quat_to_rot(q_new)
        a0_w = Rk @ accs[k] - g_w
        a1_w = R_new @ (R_new.T @ (a_w[k + 1] + g_w)) - g_w
        un_acc = 0.5 * (a0_w + a1_w)
        P.append(P[-1] + V[-1] * dt + 0.5 * un_acc * dt * dt)
        V.append(V[-1] + un_acc * dt)
        Q.append(q_new)

    frames = list(range(0, n_samples, imu_per_frame))
    return dict(P=np.asarray([P[i] for i in frames]),
                Q=np.asarray([Q[i] for i in frames]),
                V=np.asarray([V[i] for i in frames]),
                t=np.asarray([tt[i] for i in frames]),
                imu_t=tt, imu_acc=np.asarray(accs), imu_gyr=w_b, dt=dt,
                imu_per_frame=imu_per_frame, g=g_w)


def make_world(rng, traj):
    """Landmarks sprinkled around the trajectory at usable stereo depths
    (tests/test_estimator.make_world)."""
    P = traj["P"]
    lms = []
    for k in range(len(P)):
        for _ in range(N_LM // len(P)):
            d = rng.uniform(2.0, 5.5)
            dir_ = rng.normal(size=3)
            dir_[2] = abs(dir_[2]) + 1.0
            dir_ /= np.linalg.norm(dir_)
            lms.append(P[k] + dir_ * d)
    return np.asarray(lms)


def packet_for_frame(traj, k, lms, seen_ids, noise, rng, cap=128,
                     R_bc=None, baseline=EST_BASELINE):
    """Stereo feature packet of frame k (tests/test_estimator.
    packet_for_frame; with R_bc, _packet_rotated_cam: a camera rotated R_bc
    from the body, t_bc = 0).  Returns (packet, the chosen landmark ids)."""
    import types
    pc = (lms - traj["P"][k]) @ quat_to_rot(traj["Q"][k])
    if R_bc is not None:
        pc = pc @ R_bc                       # x_c = R_bcᵀ x_b
    z = pc[:, 2]
    vis = (z > 1.2) & (z < 6.5)
    un = pc[:, :2] / np.where(vis, z, 1.0)[:, None]
    vis &= (np.abs(un[:, 0]) < 0.6) & (np.abs(un[:, 1]) < 0.6)
    pcr = pc - np.array([baseline, 0, 0.0])
    unr = pcr[:, :2] / np.where(vis, pcr[:, 2], 1.0)[:, None]
    idx = np.nonzero(vis)[0]
    tracked = [i for i in idx if i in seen_ids]
    fresh = [i for i in idx if i not in seen_ids]
    chosen = (tracked + fresh)[:cap]
    ids = np.full(cap, -1, np.int32)
    valid = np.zeros(cap, bool)
    un_o = np.zeros((cap, 2))
    unr_o = np.zeros((cap, 2))
    rv = np.zeros(cap, bool)
    for s, i in enumerate(chosen):
        ids[s] = i
        valid[s] = True
        un_o[s] = un[i] + rng.normal(0, noise, 2)
        unr_o[s] = unr[i] + rng.normal(0, noise, 2)
        rv[s] = True
    return types.SimpleNamespace(
        ids=ids, valid=valid, un=un_o, vel=np.zeros((cap, 2)),
        right_valid=rv, un_right=unr_o, vel_right=np.zeros((cap, 2)),
    ), set(chosen)


# the drives of tests/test_estimator.py's test_mono_init_fallback (seed 7,
# 26 frames, stereo off) and test_online_ex_rotation_calibration (seed 11,
# 30 frames, the left event camera rotated ~16° from the identity guess)
EX_CALIB_Q_BC = np.array([0.98, 0.05, -0.10, 0.08]) / np.linalg.norm(
    [0.98, 0.05, -0.10, 0.08])


def estimator_drive(kind, n_frames=None):
    """(traj, ex_p, ex_q, packets, cfg_kw) of the mono ("mono"), the online
    extrinsic-rotation ("ex_rotation") or the checkpoint ("checkpoint":
    tests/test_checkpoint.py's, seed 0, 22 frames, its packets drawn from
    a second generator seeded 99) drive: the packets of every frame, made
    in the order the tests draw them, and the EstimatorConfig keywords of
    the test."""
    seed, n = {"mono": (7, 26), "ex_rotation": (11, 30),
               "checkpoint": (0, 22)}[kind]
    rng = np.random.default_rng(seed)
    traj = simulate_trajectory(rng, n_frames=n, imu_per_frame=10,
                               frame_dt=0.05)
    lms = make_world(rng, traj)
    if kind == "checkpoint":
        rng = np.random.default_rng(99)
    B = EST_BASELINE
    ex_p = np.array([[0, 0, 0], [0, 0, 0], [B, 0, 0], [B, 0, 0]], float)
    ex_q = np.tile(np.array([1.0, 0, 0, 0]), (4, 1))
    cfg_kw = dict(mode="esio", evt_capacity=128, img_capacity=8,
                  min_track_for_kf=15)
    R_bc = None
    if kind == "ex_rotation":
        R_bc = quat_to_rot(EX_CALIB_Q_BC)
        ex_p[3] = R_bc @ [B, 0, 0]
        ex_q[3] = EX_CALIB_Q_BC
        cfg_kw["estimate_extrinsic"] = 2
    seen = set()
    packets = []
    for f in range(n if n_frames is None else n_frames):
        pkt, seen = packet_for_frame(traj, f, lms, seen, 0.3 / 460.0, rng,
                                     R_bc=R_bc)
        if kind == "mono":
            pkt.right_valid[:] = False          # stereo off entirely
        packets.append(pkt)
    return traj, ex_p, ex_q, packets, cfg_kw


def feed_imu(est, traj, f):
    """The IMU samples of interval f (frame f-1 → f) into estimator est."""
    k_imu = traj["imu_per_frame"]
    for s in range(k_imu):
        i = (f - 1) * k_imu + s + 1
        est.process_imu(traj["dt"], traj["imu_acc"][i], traj["imu_gyr"][i])


# ---------------------------------------------------------------------------
# Reference-style YAML files (the OpenCV FileStorage dialect of the source
# system's config/*/esvio.yaml, as tests/test_run_cli.py writes them)

def yaml_float(v):
    """A float as a YAML 1.1 float scalar (its exponent needs a dot:
    `4e-05` would read as a string), round-tripping exactly."""
    s = repr(float(v))
    if "e" in s and "." not in s:
        s = s.replace("e", ".0e")
    return s


def camera_yaml_text(kind, width, height, **p):
    """A camodocal camera YAML of model `kind` (PINHOLE, KANNALA_BRANDT, MEI
    or SCARAMUZZA) with the parameters p (the loader's key names)."""
    head = (f"%YAML:1.0\n---\nmodel_type: {kind}\ncamera_name: synth\n"
            f"image_width: {width}\nimage_height: {height}\n")
    block = lambda name, keys: f"{name}:\n" + "".join(
        f"   {k}: {yaml_float(p[k])}\n" for k in keys if k in p)
    if kind == "PINHOLE":
        return head + block("distortion_parameters", ("k1", "k2", "p1", "p2")) \
            + block("projection_parameters", ("fx", "fy", "cx", "cy"))
    if kind == "KANNALA_BRANDT":
        return head + block("projection_parameters",
                            ("k2", "k3", "k4", "k5", "mu", "mv", "u0", "v0"))
    if kind == "MEI":
        return head + block("mirror_parameters", ("xi",)) \
            + block("distortion_parameters", ("k1", "k2", "p1", "p2")) \
            + block("projection_parameters", ("gamma1", "gamma2", "u0", "v0"))
    if kind == "SCARAMUZZA":
        return head + block("poly_parameters", tuple(f"p{i}" for i in range(5))) \
            + "inv_poly_parameters:\n" + "".join(
                f"   p{i}: {yaml_float(p['inv'][i])}\n"
                for i in range(len(p["inv"]))) \
            + block("affine_parameters", ("ac", "ad", "ae", "cx", "cy"))
    raise ValueError(kind)


def _matrix_yaml(name, M):
    M = np.asarray(M, float)
    data = ", ".join(repr(float(v)) for v in M.reshape(-1))
    return (f"{name}: !!opencv-matrix\n   rows: {M.shape[0]}\n"
            f"   cols: {M.shape[1]}\n   dt: d\n   data: [{data}]\n")


def _body_T(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def config_yaml_text(cfg, cams):
    """A system YAML holding the fields of SystemConfig `cfg` that the
    loader reads, with the camera files named `<name>.yaml` for each name
    in `cams` (cam0, cam1, event0, event1)."""
    keys = dict(system_mode=cfg.system_mode, event_width=cfg.event_width,
                event_height=cfg.event_height, image_width=cfg.image_width,
                image_height=cfg.image_height,
                estimate_extrinsic=cfg.estimate_extrinsic,
                max_cnt=cfg.max_cnt, max_cnt_img=cfg.max_cnt_img,
                min_dist=cfg.min_dist, min_dist_img=cfg.min_dist_img,
                freq=cfg.freq, F_threshold=float(cfg.f_threshold),
                equalize=cfg.equalize, fisheye=cfg.fisheye,
                decay_ms=float(cfg.decay_ms),
                ignore_polarity=int(cfg.ignore_polarity),
                median_blur_kernel_size=cfg.median_blur_kernel_size,
                feature_filter_threshold=float(cfg.feature_filter_threshold),
                Do_motion_correction=int(cfg.do_motion_correction),
                use_stereo_correction=cfg.use_stereo_correction,
                max_solver_time=float(cfg.max_solver_time),
                max_num_iterations=cfg.max_num_iterations,
                keyframe_parallax=float(cfg.keyframe_parallax),
                acc_n=float(cfg.acc_n), gyr_n=float(cfg.gyr_n),
                acc_w=float(cfg.acc_w), gyr_w=float(cfg.gyr_w),
                g_norm=float(cfg.g_norm), estimate_td=cfg.estimate_td,
                td=float(cfg.td), loop_closure=cfg.loop_closure,
                fast_relocalization=cfg.fast_relocalization)
    out = "%YAML:1.0\n---\n"
    for k, v in keys.items():
        out += f"{k}: {v!r}\n"
    out += f'output_path: "{cfg.output_path}"\n'
    for key, name in (("cam_left_calib", "cam0"), ("cam_right_calib", "cam1"),
                      ("event_left_calib", "event0"),
                      ("event_right_calib", "event1")):
        if name in cams:
            out += f'{key}: "{name}.yaml"\n'
    for name in ("cam0", "cam1", "event0", "event1"):
        R = getattr(cfg, f"R_body_{name}")
        if R is not None:
            out += _matrix_yaml(f"body_T_{name}",
                                _body_T(R, getattr(cfg, f"t_body_{name}")))
    return out


def write_config_yamls(directory, sys_cfg, cams):
    """The system YAML `esvio.yaml` and one PINHOLE YAML per (pinhole)
    camera of `cams` into `directory`; returns the system YAML's path."""
    import os
    for name, cam in cams.items():
        k1, k2, p1, p2 = (float(x) for x in cam.dist.cpu())
        params = dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                      cy=float(cam.cy), k1=k1, k2=k2, p1=p1, p2=p2)
        with open(os.path.join(directory, f"{name}.yaml"), "w") as f:
            f.write(camera_yaml_text("PINHOLE", cam.width, cam.height,
                                     **params))
    path = os.path.join(directory, "esvio.yaml")
    with open(path, "w") as f:
        f.write(config_yaml_text(sys_cfg, cams))
    return path


CAMERA_KINDS = ("PINHOLE", "KANNALA_BRANDT", "MEI", "SCARAMUZZA")


def camera_model_params(kind, width, height):
    """YAML parameters of a test camera of each model for a (width, height)
    sensor: a strongly distorted pinhole, a Kannala-Brandt fisheye, a MEI
    omni camera and a Scaramuzza (OCam) model whose inverse polynomial
    (degree 8) is fitted to its forward one, within 1e-4 px over the
    image's radii."""
    s = width / 346.0
    if kind == "PINHOLE":
        return dict(fx=250.0 * s, fy=251.5 * s, cx=width / 2 - 1,
                    cy=height / 2 + 1, k1=-0.28, k2=0.07, p1=2e-4, p2=-3e-4)
    if kind == "KANNALA_BRANDT":
        return dict(mu=240.0 * s, mv=241.0 * s, u0=width / 2 - 1.5,
                    v0=height / 2 + 0.5, k2=-0.012, k3=0.003, k4=-0.0008,
                    k5=0.0001)
    if kind == "MEI":
        return dict(xi=1.35, gamma1=560.0 * s, gamma2=561.0 * s,
                    u0=width / 2 - 0.5, v0=height / 2 - 1, k1=-0.22, k2=0.05,
                    p1=1e-4, p2=-2e-4)
    if kind == "SCARAMUZZA":
        r = width / 640.0
        a0, a2 = -250.0 * r, 8e-4 / r
        rho = np.linspace(0.0, np.hypot(width, height) / 2 * 1.05, 400)
        theta = np.arctan2(-1.0, rho / -(a0 + a2 * rho ** 2))
        inv = np.polynomial.polynomial.polyfit(theta, rho, 8)
        return dict(p0=a0, p1=0.0, p2=a2, p3=0.0, p4=0.0, inv=list(inv),
                    ac=1.0005, ad=0.0008, ae=-0.0006, cx=width / 2 + 3.5 * r,
                    cy=height / 2 - 2.25 * r)
    raise ValueError(kind)


def write_camera_yaml(directory, kind, width, height):
    """The test camera of model `kind` as a camodocal YAML file in
    `directory`; returns its path."""
    import os
    path = os.path.join(directory, f"{kind.lower()}_{width}x{height}.yaml")
    with open(path, "w") as f:
        f.write(camera_yaml_text(kind, width, height,
                                 **camera_model_params(kind, width, height)))
    return path


# ---------------------------------------------------------------------------
# rosbag 2.0 files (the record layout of tests/test_rosbag.py's writer, with
# the event messages packed by numpy), for jax-free drives of the rosbag
# reader and the CLI's --convert

BAG_TOPICS = dict(event_left="/davis_left/events",
                  event_right="/davis_right/events", imu="/davis_left/imu")


def _bag_fields(fields):
    import struct
    out = b""
    for k, v in fields.items():
        f = k.encode() + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return out


def _bag_record(fields, payload):
    import struct
    h = _bag_fields(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(payload)) \
        + payload


def _ros_time(stamp):
    """(secs, nsecs) of a stamp in seconds, nsecs rounded and carried."""
    secs = np.floor(np.asarray(stamp, np.float64))
    nsecs = np.round((stamp - secs) * 1e9)
    carry = nsecs >= 1e9
    return (secs + carry).astype(np.uint32), np.where(carry, 0, nsecs).astype(
        np.uint32)


def _ros_header(stamp):
    import struct
    s, ns = _ros_time(stamp)
    return struct.pack("<III", 0, int(s), int(ns)) + struct.pack("<I", 3) + b"cam"


def _bag_message(conn, stamp, payload):
    import struct
    s, ns = _ros_time(stamp)
    return _bag_record({"op": b"\x02", "conn": struct.pack("<I", conn),
                        "time": struct.pack("<II", int(s), int(ns))}, payload)


def _event_array(t, x, y, p, height, width):
    """dvs_msgs/EventArray: header, height, width, then the events packed
    13 bytes each (uint16 x, uint16 y, uint32 secs, uint32 nsecs, uint8 p)."""
    import struct
    ev = np.zeros(len(t), np.dtype([("x", "<u2"), ("y", "<u2"), ("s", "<u4"),
                                    ("ns", "<u4"), ("p", "u1")]))
    ev["x"], ev["y"], ev["p"] = x, y, p
    ev["s"], ev["ns"] = _ros_time(t)
    return (_ros_header(t[0]) + struct.pack("<III", height, width, len(t))
            + ev.tobytes())


def _imu_msg(stamp, acc, gyr):
    import struct
    return (_ros_header(stamp) + struct.pack("<4d", 0, 0, 0, 1)
            + struct.pack("<9d", *([0.0] * 9)) + struct.pack("<3d", *gyr)
            + struct.pack("<9d", *([0.0] * 9)) + struct.pack("<3d", *acc)
            + struct.pack("<9d", *([0.0] * 9)))


def write_rosbag(path, seq, height, width, compression="bz2", msg_dt=0.01,
                 chunk_msgs=200):
    """A rosbag 2.0 file of `seq`'s events (one EventArray per camera per
    msg_dt s, on BAG_TOPICS) and IMU samples, in chunks of chunk_msgs
    messages compressed with `compression` ("bz2" or "none")."""
    import bz2
    import struct
    topics = [("event_left", "dvs_msgs/EventArray"),
              ("event_right", "dvs_msgs/EventArray"),
              ("imu", "sensor_msgs/Imu")]
    conns = [_bag_record(
        {"op": b"\x07", "conn": struct.pack("<I", c),
         "topic": BAG_TOPICS[name].encode()},
        _bag_fields({"topic": BAG_TOPICS[name].encode(), "type": dtype.encode(),
                     "md5sum": b"0" * 32, "message_definition": b""}))
        for c, (name, dtype) in enumerate(topics)]
    msgs = []
    for c, ev in enumerate((seq.events_left, seq.events_right)):
        edges = np.searchsorted(ev.t, np.arange(ev.t[0], ev.t[-1] + msg_dt,
                                                msg_dt), side="right")
        for lo, hi in zip(np.concatenate([[0], edges]), np.append(edges, len(ev.t))):
            if hi > lo:
                msgs.append((ev.t[lo], _bag_message(c, ev.t[lo], _event_array(
                    ev.t[lo:hi], ev.x[lo:hi], ev.y[lo:hi], ev.p[lo:hi],
                    height, width))))
    for k, ti in enumerate(seq.imu.t):
        msgs.append((ti, _bag_message(2, ti, _imu_msg(ti, seq.imu.acc[k],
                                                      seq.imu.gyr[k]))))
    msgs.sort(key=lambda m: m[0])
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_bag_record({"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                             "conn_count": struct.pack("<I", len(conns)),
                             "chunk_count": struct.pack("<I", 1)}, b" " * 1024))
        for i in range(0, max(len(msgs), 1), chunk_msgs):
            raw = b"".join(conns if i == 0 else []) + b"".join(
                m for _, m in msgs[i:i + chunk_msgs])
            body = bz2.compress(raw) if compression == "bz2" else raw
            f.write(_bag_record({"op": b"\x05",
                                 "compression": compression.encode(),
                                 "size": struct.pack("<I", len(raw))}, body))
    return path


# ---------------------------------------------------------------------------
# calibration views (numpy copies of tests/test_calib.py's _board, _views
# and render_chessboard) and its four ground-truth cameras
# ---------------------------------------------------------------------------

CALIB_GT = {
    "pinhole": dict(fx=420.0, fy=415.0, cx=330.0, cy=245.0,
                    dist=np.array([-0.30, 0.10, 1e-3, -5e-4])),
    "kb": dict(mu=380.0, mv=378.0, u0=320.0, v0=240.0,
               ks=np.array([-0.01, 0.02, -0.008, 0.001])),
    "mei": dict(gamma1=760.0, gamma2=755.0, u0=325.0, v0=242.0, xi=0.9,
                dist=np.array([-0.15, 0.05, 5e-4, -3e-4])),
    "scara": dict(poly=np.array([-420.0, 0.0, 8.0e-4, -2.0e-7, 1.0e-10]),
                  cx=322.0, cy=243.0),
}


def calib_board(nx=8, ny=6, square=0.03):
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    return np.stack([xs.ravel() * square, ys.ravel() * square,
                     np.zeros(nx * ny)], -1)


def calib_views(rng, board, V=16):
    """Strongly tilted views over a depth range (tests/test_calib.py)."""
    ws, ts = [], []
    for _ in range(V):
        w = rng.normal(0, 0.45, 3)
        w[2] = rng.normal(0, 0.2)
        t = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.12, 0.12),
                      rng.uniform(0.3, 0.9)])
        t[:2] -= board[:, :2].mean(0)
        ws.append(w)
        ts.append(t)
    return np.stack(ws), np.stack(ts)


def calib_observations(project, seed=0, so3=None):
    """(object_pts (V, N, 3), image_pts (V, N, 2)) of tests/test_calib.py's
    16 views of its 8×6 board, 0.1 px of detection noise, with
    project(pc (N, 3)) → pixels (N, 2) the ground-truth camera and so3(w)
    the rotation of a view (this module's so3_exp by default)."""
    so3 = so3 or so3_exp
    rng = np.random.default_rng(seed)
    board = calib_board()
    ws, ts = calib_views(rng, board)
    img = np.stack([project(board @ so3(w).T + t) for w, t in zip(ws, ts)])
    img = img + rng.normal(0, 0.1, img.shape)
    return np.tile(board[None], (len(ws), 1, 1)), img


def render_chessboard(rows, cols, square=20, margin=30, rng=None):
    """Chessboard image with (rows, cols) INNER corners and the corners
    row-major (tests/test_calib.py)."""
    ny, nx = rows + 1, cols + 1
    H = ny * square + 2 * margin
    W = nx * square + 2 * margin
    y, x = np.mgrid[0:H, 0:W]
    bx = (x - margin) // square
    by = (y - margin) // square
    inside = (x >= margin) & (x < W - margin) & (y >= margin) & (y < H - margin)
    img = np.where(inside & (((bx + by) % 2) == 0), 220.0, 40.0)
    img = np.where(inside, img, 130.0)
    corners = np.stack(np.meshgrid(
        margin + square * np.arange(1, nx),
        margin + square * np.arange(1, ny), indexing="xy"), -1)
    corners = corners.reshape(rows, cols, 2).reshape(-1, 2).astype(float)
    if rng is not None:
        img = img + rng.normal(0, 3.0, img.shape)
    return img, corners


def long_log(rng, T=38, n_lm=240, noise_px=0.3 / 460.0, p_noise=0.06):
    """(traj, long_state, long_book) of tests/test_sequence_parallel.py's
    long log (build_long_log): T frames at 20 Hz, n_lm landmarks seen in
    stereo, a noisy initial position guess, the IMU samples per interval."""
    traj = simulate_trajectory(rng, n_frames=T, imu_per_frame=10,
                               frame_dt=0.05)
    lms = make_world(rng, traj)[:n_lm]
    L = len(lms)
    un = np.zeros((L, T, 2))
    un_r = np.zeros((L, T, 2))
    obs = np.zeros((L, T), bool)
    stereo = np.zeros((L, T), bool)
    for f in range(T):
        pc = (lms - traj["P"][f]) @ quat_to_rot(traj["Q"][f])
        z = pc[:, 2]
        vis = (z > 1.2) & (z < 6.5)
        u = pc[:, :2] / np.where(vis, z, 1.0)[:, None]
        vis &= (np.abs(u[:, 0]) < 0.6) & (np.abs(u[:, 1]) < 0.6)
        pcr = pc - np.array([EST_BASELINE, 0, 0.0])
        ur = pcr[:, :2] / np.where(vis, pcr[:, 2], 1.0)[:, None]
        obs[:, f] = vis
        stereo[:, f] = vis
        un[:, f] = u + rng.normal(0, noise_px, (L, 2))
        un_r[:, f] = ur + rng.normal(0, noise_px, (L, 2))

    k = traj["imu_per_frame"]
    C = k + 2
    imu_dt = np.zeros((T - 1, C))
    imu_acc = np.zeros((T - 1, C, 3))
    imu_gyr = np.zeros((T - 1, C, 3))
    imu_n = np.full(T - 1, k, np.int32)
    for f in range(T - 1):
        for s in range(k):
            i = f * k + s + 1
            imu_dt[f, s] = traj["dt"]
            imu_acc[f, s] = traj["imu_acc"][i]
            imu_gyr[f, s] = traj["imu_gyr"][i]

    P0 = traj["P"] + rng.normal(0, p_noise, traj["P"].shape)
    long_state = dict(
        P=P0, Q=traj["Q"], V=traj["V"], Ba=np.zeros((T, 3)),
        Bg=np.zeros((T, 3)),
        ex_p=np.array([[0, 0, 0], [0, 0, 0],
                       [EST_BASELINE, 0, 0], [EST_BASELINE, 0, 0]]),
        ex_q=np.tile(np.array([1.0, 0, 0, 0]), (4, 1)),
        imu_dt=imu_dt, imu_acc=imu_acc, imu_gyr=imu_gyr, imu_n=imu_n)
    long_book = dict(un=un, un_r=un_r, vel=np.zeros_like(un),
                     vel_r=np.zeros_like(un), obs=obs, stereo=stereo)
    return traj, long_state, long_book


def long_log_gates(traj, long_state, P_out):
    """tests/test_sequence_parallel.py's gates on a stitched trajectory:
    (mean error, mean input error, worst step discontinuity); the gates
    are mean error < 0.6 × the input's and discontinuity < 0.1 m."""
    err_in = np.linalg.norm(long_state["P"] - traj["P"], axis=1).mean()
    err_out = np.linalg.norm(P_out - traj["P"], axis=1).mean()
    step = np.linalg.norm(np.diff(P_out, axis=0), axis=1)
    gt_step = np.linalg.norm(np.diff(traj["P"], axis=0), axis=1)
    jump = float(np.abs(step - gt_step).max())
    assert err_out < 0.6 * err_in, (err_out, err_in)
    assert jump < 0.1, jump
    return float(err_out), float(err_in), jump


# ---------------------------------------------------------------------------
# a well-conditioned window problem for the batched solve
# ---------------------------------------------------------------------------

def solver_window(seed, device):
    """One well-conditioned window in float64 on `device`: the port's
    (state, book_img, book_evt, preints, imu_valid, prior) and g, a numpy
    copy of tests/test_solver.build_problem (a simulated trajectory, 40
    landmarks seen in stereo at every frame, 5 % depth noise, noisy states
    but frame 0), preintegrated by the port."""
    import dataclasses
    import torch
    from esvio_tpu_torch.core import lie
    from esvio_tpu_torch.imu import preintegration as tpre
    from esvio_tpu_torch.solver import gauss_newton as tgn
    from esvio_tpu_torch.solver import window as twin
    rng = np.random.default_rng(seed)
    L_CAP, N_LM = 64, 40
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=device)
    on = lambda a: torch.as_tensor(a, device=device)
    traj = simulate_trajectory(rng)
    lms = np.stack([rng.uniform(-3, 3, N_LM), rng.uniform(-3, 3, N_LM),
                    rng.uniform(3, 9, N_LM)], -1)
    R = np.stack([quat_to_rot(q) for q in traj["Q"]])
    p_body = np.einsum("lj,fjk->flk", lms, R) - np.einsum(
        "fj,fjk->fk", traj["P"], R)[:, None]              # (F, L, 3)
    un = np.zeros((L_CAP, 11, 2))
    un_r = np.zeros((L_CAP, 11, 2))
    un[:N_LM] = (p_body[..., :2] / p_body[..., 2:3]).transpose(1, 0, 2)
    pr = p_body - np.array([EST_BASELINE, 0.0, 0.0])
    un_r[:N_LM] = (pr[..., :2] / pr[..., 2:3]).transpose(1, 0, 2)
    assert (p_body[..., 2] > 0.1).all() and (pr[..., 2] > 0.1).all()
    live = np.arange(L_CAP) < N_LM
    obs = np.repeat(live[:, None], 11, 1)
    inv_depth = np.zeros(L_CAP)
    inv_depth[:N_LM] = 1.0 / p_body[0, :, 2] * (1 + 0.05 * rng.normal(size=N_LM))
    book = dataclasses.replace(
        twin.empty_book(L_CAP, device, torch.float64), un=f64(un),
        un_r=f64(un_r), obs=on(obs), stereo=on(obs),
        inv_depth=f64(inv_depth), depth_valid=on(live), active=on(live),
        ids=torch.arange(L_CAP, dtype=torch.int32, device=device))

    k = traj["imu_per_frame"]
    idx = np.arange(10)[:, None] * k + np.arange(k + 1)[None, :]
    acc, gyr = traj["imu_acc"][idx], traj["imu_gyr"][idx]    # (10, k+1, 3)
    z3 = f64(np.zeros((10, 3)))
    preints = tpre.preintegrate_batch(
        f64(np.full((10, k), traj["dt"])), f64(acc[:, 1:]), f64(gyr[:, 1:]),
        f64(acc[:, 0]), f64(gyr[:, 0]), z3, z3,
        tpre.make_imu_params(dtype=torch.float64, device=device),
        on(np.ones((10, k), bool)))

    P, V, Q = traj["P"].copy(), traj["V"].copy(), traj["Q"].copy()
    P[1:] += rng.normal(0, 0.03, (10, 3))
    V[1:] += rng.normal(0, 0.03, (10, 3))
    dq = lie.quat_exp(f64(rng.normal(0, 0.005, (10, 3))))
    Q[1:] = lie.quat_mul(f64(Q[1:]), dq).cpu().numpy()
    ex_p = np.array([[0, 0, 0], [0, 0, 0], [EST_BASELINE, 0, 0],
                     [EST_BASELINE, 0, 0.0]])
    state = twin.WindowState(
        P=f64(P), Q=f64(Q), V=f64(V), Ba=f64(np.zeros((11, 3))),
        Bg=f64(np.zeros((11, 3))), ex_p=f64(ex_p),
        ex_q=f64(np.tile([1.0, 0, 0, 0], (4, 1))), td=f64(0.0))
    return ((state, twin.empty_book(8, device, torch.float64), book, preints,
             on(np.ones(10, bool)), tgn.empty_prior(device, torch.float64)),
            f64(traj["g"]))
