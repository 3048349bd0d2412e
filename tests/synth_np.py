"""Numpy-only copy of the part of tests/synth.py that the ESIO and ESVIO
golden sequences need (`planar_vio_sequence_rot` with the blob texture and
optional stereo frames), returning the PyTorch port's `SequenceData`.  It
imports neither jax nor esvio_tpu, so it also runs where JAX is not
installed; tests/test_torch_pipeline.py and tests/test_torch_esvio.py check
it against tests/synth.py.
"""
import numpy as np


def blob_texture(rng, H, W, n_blobs=120, margin=80):
    """Binary-ish blob texture with sharp edges, padded by `margin`."""
    img = np.zeros((H + 2 * margin, W + 2 * margin))
    for _ in range(n_blobs):
        cx = rng.uniform(0, W + 2 * margin)
        cy = rng.uniform(0, H + 2 * margin)
        s = rng.uniform(2, 5)
        y, x = np.mgrid[0:H + 2 * margin, 0:W + 2 * margin]
        img += np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))
    img = (img > np.percentile(img, 88)).astype(np.float64) * 200.0 + 20.0
    return img, margin


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
                            frame_hz=0, img_H=None, img_W=None, img_focal=None):
    """Stereo events + IMU from a camera over a blob-textured plane with a
    pitch/roll wobble (tests/synth.planar_vio_sequence_rot, blob texture,
    no IMU bias or noise), and with frame_hz > 0 stereo frames of
    (img_H, img_W) at focal img_focal (default: the event size and field of
    view).  Frames draw nothing from rng.  Returns (SequenceData, gt_t,
    gt_P) with the port's SequenceData."""
    from esvio_tpu_torch.io import datasets as ds

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

    ev_t = np.arange(t0, t0 + duration, 1.0 / event_hz)

    def gen_events(cam_offset):
        ts, xs, ys, ps = [], [], [], []
        prev = None
        for t in ev_t:
            tt = t - t0
            R = rot(tt)[0]
            p = pos(np.atleast_1d(tt))[0] + R @ cam_offset
            img = render_plane(tex, margin, H, W, focal, cx, cy, R, p,
                               plane_z, tex_scale, tex_cx, tex_cy)
            if prev is not None:
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
                 plane_z=4.0, fused=True, img_H=None, img_W=None):
    """(make_pipeline, seq, gt_t, gt_P): a factory of fresh port pipelines
    on `device` with the settings of the golden trace
    (tests/test_golden_trace.py:31-64, loop closure off), and its synthetic
    sequence.  mode "esio" (system_mode 0) or "esvio" (1: stereo frames at
    FRAME_HZ rendered at (img_H, img_W) with the events' field of view,
    default the event size, which the pipeline resizes to the image
    tracker's (H, W)); `fused` picks the estimator's steady tick."""
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    from esvio_tpu_torch.io.config import SystemConfig
    from esvio_tpu_torch.vio import estimator as est_mod

    esvio = mode == "esvio"
    seq, gt_t, gt_P = planar_vio_sequence_rot(
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
        loop_closure=0)
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
