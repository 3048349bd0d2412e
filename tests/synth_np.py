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
    wc, wr = 0.5, 0.9
    radius = 0.4
    amp = np.deg2rad(rot_amp_deg)

    def pos(t):
        th = 2 * np.pi * wc * t
        return np.stack([radius * np.sin(th), radius * (np.cos(th) - 1.0),
                         np.zeros_like(t)], -1)

    def accel_w(t):
        th = 2 * np.pi * wc * t
        k = (2 * np.pi * wc) ** 2
        return np.stack([-k * radius * np.sin(th), -k * radius * np.cos(th),
                         np.zeros_like(t)], -1)

    def rotvec(t):
        return np.stack([amp * np.sin(2 * np.pi * wr * t),
                         amp * np.sin(2 * np.pi * wr * 0.77 * t + 1.0),
                         np.zeros_like(t)], -1)

    def rot(t):
        return so3_exp(rotvec(np.atleast_1d(t)))

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


def vio_pipeline(device, H, W, focal, duration, mode="esio", baseline=0.10,
                 plane_z=4.0, fused=True, img_H=None, img_W=None,
                 loop_closure=0, sequence=None):
    """(make_pipeline, seq, gt_t, gt_P): a factory of fresh port pipelines
    on `device` with the settings of the golden trace
    (tests/test_golden_trace.py:31-64, loop closure off unless
    loop_closure=1, as bench.py's pipeline_run has it), and its synthetic
    sequence.  mode "esio" (system_mode 0) or "esvio" (1: stereo frames at
    FRAME_HZ rendered at (img_H, img_W) with the events' field of view,
    default the event size, which the pipeline resizes to the image
    tracker's (H, W)); `fused` picks the estimator's steady tick;
    `sequence`: a (seq, gt_t, gt_P) made earlier with the same settings,
    reused instead of rendered again."""
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    from esvio_tpu_torch.io.config import SystemConfig
    from esvio_tpu_torch.vio import estimator as est_mod

    esvio = mode == "esvio"
    seq, gt_t, gt_P = sequence or planar_vio_sequence_rot(
        np.random.default_rng(0), H=H, W=W, focal=focal, plane_z=plane_z,
        baseline=baseline, duration=duration,
        frame_hz=FRAME_HZ if esvio else 0, img_H=img_H, img_W=img_W)
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


def loop_pipeline(device, H=120, W=160, focal=200.0, duration=3.6,
                  motion_correction=False, fused=True, baseline=0.10,
                  plane_z=4.0):
    """(make_pipeline, seq, gt_t, gt_P) of tests/test_e2e_loops.py:31-67 on
    the port: ESIO with loop closure and fast relocalization, the loop
    closer's skip_recent at 12 (the revisit cadence of this sequence), and
    with motion_correction the IMU-aided event warp on."""
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    from esvio_tpu_torch.io.config import SystemConfig
    from esvio_tpu_torch.vio import estimator as est_mod

    seq, gt_t, gt_P = planar_vio_sequence_rot(
        np.random.default_rng(0), H=H, W=W, focal=focal, plane_z=plane_z,
        baseline=baseline, duration=duration, texture="smooth",
        gyr_bias=LOOP_GYR_BIAS, acc_bias=LOOP_ACC_BIAS)
    cam = camera.make_pinhole(focal, focal, W / 2, H / 2, width=W, height=H)
    R = np.eye(3)
    sys_cfg = SystemConfig(
        system_mode=0, event_width=W, event_height=H, image_width=W,
        image_height=H, R_body_cam0=R, t_body_cam0=np.zeros(3),
        R_body_cam1=R, t_body_cam1=np.array([baseline, 0, 0]),
        R_body_event0=R, t_body_event0=np.zeros(3),
        R_body_event1=R, t_body_event1=np.array([baseline, 0, 0]),
        freq=15, max_cnt=60, min_dist=10, loop_closure=1,
        fast_relocalization=1, do_motion_correction=motion_correction)
    tracker_cfg = trk.TrackerConfig(width=W, height=H, capacity=128,
                                    cand_capacity=512, max_cnt=60,
                                    min_dist=10, lk_iters=15)
    est_cfg = est_mod.EstimatorConfig(mode="esio", evt_capacity=256,
                                      img_capacity=8, min_track_for_kf=15,
                                      fused=fused)

    def make_pipeline():
        pipe = Pipeline(sys_cfg, {"event0": cam, "event1": cam}, device,
                        tracker_cfg=tracker_cfg, est_cfg=est_cfg,
                        event_capacity=1 << 15)
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
