"""The port's image front end at DSEC's proportions, small, on the CPU:
events at 160x120 and focal 140, frames at 360x270 and focal 315 (2.25
times the event pixel pitch, the events' field of view, as the
dsec_640x480_esvio deployment's 640x480 / 1440x1080 at focal 560 / 1260),
frames at 20 Hz beside 10 Hz ticks.  `Pipeline._image_frontend` takes and
tracks the frames, its per-tick record on.

  * the packets against a plain closed-form reference in numpy (no port
    code): a feature's left ray at the true pose of its frame meets the
    plane; that point projected at the next tracked frame's true pose is
    where the same id has to be (track), projected into the right frame
    camera at the same pose, where its match has to be (stereo), each in
    frame pixels.  The control gives the tracker frame intrinsics 2 %
    long and has to fail each tolerance;
  * with frames at twice the tick rate each tick takes the latest frame at
    or before it, exactly once: `frames_offered` 2, `frames_taken` 1 and
    `frame_bytes` the two frames as handed over.

Tolerances, in frame pixels at focal 315 (the stereo disparity is 7.9 px
at the plane's 4 m; frame intrinsics 2 % off shift every right match by
2 % of it, 0.16 px, and every feature's track by 2 % of its motion).  This
run reads 0.0006 / 0.008 / 0.048 px sound and 0.154 / 0.154 / 0.189 px with
the intrinsics 2 % long (0.077 / 0.078 / 0.098 at 1 %), so each tolerance
alone fails the control:
  * stereo bias (length of the median signed stereo error) < 0.02 px: a
    sound tracker on this noise-free scene leaves no common shift;
  * median stereo error < 0.04 px: LK converges to about a hundredth of a
    pixel on the smooth scene; the median is held, not each feature;
  * median track error < 0.1 px: the track spans a tick's motion, ~10 px,
    through the bilinear texture's kinks, so it converges less tightly;
  * at least 80 % of the 60 features a packet and 60 % of them matched in
    stereo (1.0 and 0.91 here): half of them left out fails.
"""
import types

import numpy as np
import pytest

import torch_parity  # noqa: F401 (its torch thread cap)
from synth_np import planar_rot_position, planar_rot_rotation, \
    planar_vio_sequence_rot
from esvio_tpu_torch.apps.pipeline import Pipeline
from esvio_tpu_torch.core import camera
from esvio_tpu_torch.frontend import tracker as trk
from esvio_tpu_torch.io.config import SystemConfig
from esvio_tpu_torch.utils.metrics import Metrics, StageTimer

H, W, FOCAL = 120, 160, 140.0            # events
IMG_H, IMG_W, IMG_FOCAL = 270, 360, 315.0  # frames
FRAME_HZ, TICK_HZ = 20, 10
BASELINE, PLANE_Z = 0.10, 4.0
T0 = 1.0             # the sequence's first stamp (planar_vio_sequence_rot)
TICKS = 5
MAX_CNT = 60

BIAS_PX, STEREO_PX, TRACK_PX = 0.02, 0.04, 0.1
MIN_FEATURES, MIN_MATCHED = 0.8, 0.6


@pytest.fixture(scope="module")
def frames():
    seq, _, _ = planar_vio_sequence_rot(
        np.random.default_rng(0), H=H, W=W, focal=FOCAL, plane_z=PLANE_Z,
        baseline=BASELINE, duration=TICKS / TICK_HZ + 0.05, frame_hz=FRAME_HZ,
        img_H=IMG_H, img_W=IMG_W, img_focal=IMG_FOCAL, texture="smooth")
    # frames as a sensor hands them over: 8-bit gray
    to_u8 = lambda f: np.clip(np.round(f), 0, 255).astype(np.uint8)
    return types.SimpleNamespace(
        images_left=(seq.images_left[0], to_u8(seq.images_left[1])),
        images_right=(seq.images_right[0], to_u8(seq.images_right[1])))


def _run(frames, focal_scale):
    """The packets and tick lines of TICKS ticks of the image front end."""
    R = np.eye(3)
    cfg = SystemConfig(
        system_mode=1, event_width=W, event_height=H, image_width=IMG_W,
        image_height=IMG_H, R_body_cam0=R, t_body_cam0=np.zeros(3),
        R_body_cam1=R, t_body_cam1=np.array([BASELINE, 0, 0]),
        R_body_event0=R, t_body_event0=np.zeros(3), R_body_event1=R,
        t_body_event1=np.array([BASELINE, 0, 0]), freq=TICK_HZ,
        max_cnt=MAX_CNT, min_dist=10, max_cnt_img=MAX_CNT, min_dist_img=10)
    ev = camera.make_pinhole(FOCAL, FOCAL, W / 2, H / 2, width=W, height=H)
    f = IMG_FOCAL * focal_scale
    img = camera.make_pinhole(f, f, IMG_W / 2, IMG_H / 2, width=IMG_W,
                              height=IMG_H)
    small = trk.TrackerConfig(width=IMG_W, height=IMG_H, capacity=128,
                              cand_capacity=512, max_cnt=MAX_CNT, min_dist=10,
                              lk_iters=15)
    pipe = Pipeline(cfg, dict(event0=ev, event1=ev, cam0=img, cam1=img), "cpu",
                    img_tracker_cfg=small)
    met = Metrics(record=True)
    tim = StageTimer("cpu", met)
    pipe._img_idx = pipe._img_seen = 0
    packets = []
    with met.recording():
        for k in range(1, TICKS + 1):
            t = T0 + k / TICK_HZ
            key = met.begin_tick(t)
            packets.append(pipe._image_frontend(frames, t, tim, met, key))
            met.end_tick(key)
    return packets, met.ticks


@pytest.fixture(scope="module")
def runs(frames):
    return {name: _run(frames, s) for name, s in (("sound", 1.0),
                                                    ("focal2", 1.02))}


def _pose(t):
    return planar_rot_rotation(t - T0)[0], planar_rot_position(
        np.atleast_1d(t - T0))[0]


def _on_plane(R, c, un):
    ray = R @ np.array([un[0], un[1], 1.0])
    return c + (PLANE_Z - c[2]) / ray[2] * ray


def _project(R, c, X):
    x = R.T @ (X - c)
    return x[:2] / x[2]


def _readings(packets):
    """Median stereo and track errors, the stereo bias (px), and the share
    of MAX_CNT features and stereo matches a packet."""
    stereo, track, feats, matched = [], [], [], []
    prev = None
    for pk in packets:
        t = float(pk.t)
        R, p = _pose(t)
        cr = p + R @ np.array([BASELINE, 0.0, 0.0])
        ok = (pk.valid & (pk.ids >= 0)).numpy()
        both = ok & pk.right_valid.numpy()
        un, un_r, ids = (pk.un.double().numpy(), pk.un_right.double().numpy(),
                         pk.ids.numpy())
        feats.append(ok.sum())
        matched.append(both.sum())
        for i in np.nonzero(both)[0]:
            X = _on_plane(R, p, un[i])
            stereo.append((un_r[i] - _project(R, cr, X)) * IMG_FOCAL)
        if prev is not None:
            (R0, p0), where = prev
            for i in np.nonzero(ok)[0]:
                if int(ids[i]) in where:
                    X = _on_plane(R0, p0, where[int(ids[i])])
                    track.append((un[i] - _project(R, p, X)) * IMG_FOCAL)
        prev = ((R, p), {int(ids[i]): un[i] for i in np.nonzero(ok)[0]})
    stereo, track = np.array(stereo), np.array(track)
    return dict(
        stereo_px=np.median(np.hypot(*stereo.T)),
        track_px=np.median(np.hypot(*track.T)),
        bias_px=np.hypot(*np.median(stereo, 0)),
        features=np.mean(feats) / MAX_CNT, matched=np.mean(matched) / MAX_CNT)


def test_image_packets_meet_the_closed_form_reference(runs):
    packets, _ = runs["sound"]
    r = _readings(packets)
    assert r["bias_px"] < BIAS_PX, r
    assert r["stereo_px"] < STEREO_PX, r
    assert r["track_px"] < TRACK_PX, r
    assert r["features"] >= MIN_FEATURES and r["matched"] >= MIN_MATCHED, r


def test_frame_intrinsics_two_percent_long_fail(runs):
    r = _readings(runs["focal2"][0])
    assert r["bias_px"] > BIAS_PX and r["stereo_px"] > STEREO_PX \
        and r["track_px"] > TRACK_PX, r


def test_latest_frame_taken_once_at_twice_the_tick_rate(runs, frames):
    packets, lines = runs["sound"]
    stamps = frames.images_left[0]
    nbytes = frames.images_left[1][0].nbytes + frames.images_right[1][0].nbytes
    taken = []
    for pk, line in zip(packets, lines):
        latest = stamps[stamps <= line["tick"]].max()
        assert pk is not None and float(pk.t) == pytest.approx(latest, abs=1e-6)
        assert line["frames_offered"] == 2 and line["frames_taken"] == 1
        assert line["counts"]["frame_bytes"] == {"frontend_image": nbytes}
        assert {"frontend_image", "frontend_image.upload"} <= \
            {s[0] for s in line["spans"]}
        taken.append(latest)
    assert len(set(taken)) == TICKS
