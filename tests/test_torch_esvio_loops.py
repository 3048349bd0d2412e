"""ESVIO with loop closure and fast relocalization (system_mode 1, loop
keyframes from the prepared left frame): the port's pipeline against the
JAX pipeline on the loop sequence of tests/test_e2e_loops.py with stereo
frames (synth_np.loop_pipeline(mode="esvio")), on the CPU.

One JAX run, on the sequence as synth_np renders it
(torch_parity.np_render_for_jax), records both trackers' packets, every
keyframe handed to its loop closer, the first relocalization match the
closer hands the estimator and the estimator's relocalization solve of it.  The port's pipeline then
runs on those packets (its trackers replaced by the recording).  Both back
ends take the general path (fused=False), the JAX one with its
marginalization's eigendecompositions in float64 as the port takes them
(ROADMAP 3-R4), as tests/test_torch_relo.py holds them.  Exact: the
keyframe stamps, the left frame each keyframe hands the closer (bit for
bit), the loops closed (their keyframe pairs), the matched feature ids of
each, the relocalization match's stamp and ids, and the window frame and
match count the estimator solves it with.  Within the golden's 0.05 m
(tests/test_golden_trace.py:83, MAX_DEV_M; the two float32 back ends part
by up to ~0.03 m over this sequence's 33 steady ticks): every position of
the trajectory, the old keyframe's position in the match and, where the
solve accepts the relocalization, the position it refines and the drift
it feeds back; their rotations within the angle 0.05 m subtends at the
plane's 4 m (a quaternion's vector part within MAX_DEV_M / (2 * 4.0)).
This sequence's first relocalization is rejected on both sides (fewer
than 15 of its 15 matches reproject within 10 px of the refined pose), so
the decision is what is held there.

The first loop needs one revolution of the sequence's circle after the
initialization (tick 11): its match reaches the estimator on tick 43 and
is solved on tick 44, when its keyframe is in the window, so both runs stop
after RUN_TICKS ticks of the 54.
"""
import numpy as np
import pytest

from torch_parity import jax_marginalization_f64, np_render_for_jax, to_torch
from synth_np import LOOP_ACC_BIAS, LOOP_GYR_BIAS, loop_pipeline

SKIP_RECENT = 12          # tests/test_e2e_loops.py's, the revisit cadence
RUN_TICKS = 44            # through the first relocalization solve
MAX_DEV_M = 0.05          # tests/test_golden_trace.py:83
MAX_DEV_Q = MAX_DEV_M / (2 * 4.0)   # the same at the plane's depth, 4 m


def _spy(pipe, store):
    """Record (stamp, image) of every keyframe begun, the loop info of every
    commit that closed one, the estimator tick of each, every
    relocalization match handed to the estimator and every relocalization
    solve it finished."""
    lc, est = pipe.loop_closer, pipe.estimator
    real_begin, real_commit = lc.begin_keyframe, lc.commit_keyframe
    real_pp, real_set = est.process_packets, est.set_relo_frame
    real_finish = est._finish_relo
    tick = [0]

    def begin(stamp, t_w, q_w, pts_w, uv, valid, img, **kw):
        img_np = img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)
        store["kf"].append((float(stamp), np.asarray(img_np,
                                                     np.float32).copy()))
        return real_begin(stamp, t_w, q_w, pts_w, uv, valid, img, **kw)

    def commit(pending):
        info = real_commit(pending)
        if info is not None:
            store["loops"].append((tick[0], info))
        return info

    def process_packets(t, *a, **k):
        tick[0] += 1
        return real_pp(t, *a, **k)

    def set_relo_frame(stamp, match_ids, match_un, relo_P, relo_Q):
        store["relo_set"].append((tick[0], float(stamp),
                                  np.asarray(match_ids).copy(),
                                  np.asarray(match_un, np.float64).copy(),
                                  np.asarray(relo_P, np.float64).copy(),
                                  np.asarray(relo_Q, np.float64).copy()))
        return real_set(stamp, match_ids, match_un, relo_P, relo_Q)

    def finish_relo(prep):
        out = real_finish(prep)
        if prep is not None:
            refined = prep.get("refined")
            store["relo_solved"].append(dict(
                tick=tick[0], i=int(prep["i"]), n=int(prep["n"]),
                frame_stamp=float(prep["frame_stamp"]),
                refined=None if refined is None else
                tuple(np.asarray(x.cpu() if hasattr(x, "cpu") else x,
                                 np.float64) for x in refined),
                out=out))
        return out

    lc.begin_keyframe, lc.commit_keyframe = begin, commit
    est.process_packets, est.set_relo_frame = process_packets, set_relo_frame
    est._finish_relo = finish_relo


def _store():
    return dict(kf=[], loops=[], relo_set=[], relo_solved=[])


def _loop_key(tick_info):
    """(tick, old keyframe, new keyframe, its stamp, matched feature ids)."""
    tick, info = tick_info
    return (tick, int(info["i_old"]), int(info["j_new"]),
            float(info["stamp_new"]),
            tuple(int(i) for i in np.asarray(info["match_ids"])))


@pytest.fixture(scope="module")
def jax_run():
    import jax
    from esvio_tpu.apps import pipeline as jpipe
    from esvio_tpu.core import camera
    from esvio_tpu.frontend import tracker as trk
    from esvio_tpu.io.config import SystemConfig
    from esvio_tpu.vio import estimator as est_mod
    H, W, F, B = 120, 160, 200.0, 0.10
    seq, _, _ = np_render_for_jax(
        np.random.default_rng(0), H=H, W=W, focal=F, plane_z=4.0, baseline=B,
        duration=3.6, texture="smooth", gyr_bias=LOOP_GYR_BIAS,
        acc_bias=LOOP_ACC_BIAS, frame_hz=15)
    cam = camera.make_pinhole(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H)
    R = np.eye(3)
    sys_cfg = SystemConfig(
        system_mode=1, event_width=W, event_height=H, image_width=W,
        image_height=H, R_body_cam0=R, t_body_cam0=np.zeros(3),
        R_body_cam1=R, t_body_cam1=np.array([B, 0, 0]), R_body_event0=R,
        t_body_event0=np.zeros(3), R_body_event1=R,
        t_body_event1=np.array([B, 0, 0]), freq=15, max_cnt=60, min_dist=10,
        max_cnt_img=60, min_dist_img=10, loop_closure=1, fast_relocalization=1)
    tcfg = trk.TrackerConfig(width=W, height=H, capacity=128, cand_capacity=512,
                             max_cnt=60, min_dist=10, lk_iters=15)
    pipe = jpipe.Pipeline(
        sys_cfg, {"event0": cam, "event1": cam, "cam0": cam, "cam1": cam},
        tracker_cfg=tcfg, img_tracker_cfg=tcfg, event_capacity=1 << 15,
        est_cfg=est_mod.EstimatorConfig(mode="esvio", evt_capacity=256,
                                        img_capacity=256, min_track_for_kf=15,
                                        fused=False))
    pipe.loop_closer.cfg.skip_recent = SKIP_RECENT
    pipe.loop_closer.db.skip_recent = SKIP_RECENT
    store = dict(_store(), evt=[], img=[])
    _spy(pipe, store)
    with jax_marginalization_f64(), pytest.MonkeyPatch.context() as mp:
        for name, key in (("track_event_stereo", "evt"),
                          ("track_image_stereo", "img")):
            real = getattr(jpipe.trk, name)

            def rec(*a, real=real, key=key, **k):
                state, pkt = real(*a, **k)
                store[key].append(jax.device_get(pkt))
                return state, pkt
            mp.setattr(jpipe.trk, name, rec)
        res = pipe.run(seq, max_frames=RUN_TICKS)
    store["res"], store["seq"] = res, seq
    return store


@pytest.fixture(scope="module")
def port_run(jax_run):
    import esvio_tpu_torch.apps.pipeline as tpipe
    from esvio_tpu_torch.frontend import tracker as ttrk
    evt = iter([to_torch(p, ttrk.FeaturePacket) for p in jax_run["evt"]])
    img = iter([to_torch(p, ttrk.FeaturePacket) for p in jax_run["img"]])
    make_pipeline, seq, _, _ = loop_pipeline("cpu", mode="esvio", fused=False)
    store = dict(_store(), seq=seq)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe.trk, "track_event_stereo",
                   lambda cfg, cam_l, cam_r, state, ch_l, ch_r, t:
                   (state, next(evt)))
        mp.setattr(tpipe.trk, "track_image_stereo",
                   lambda cfg, cam_l, cam_r, state, f_l, f_r, t:
                   (state, next(img)))
        pipe = make_pipeline()
        assert pipe.sys_cfg.fast_relocalization == 1
        pipe.loop_closer.cfg.skip_recent = SKIP_RECENT
        pipe.loop_closer.db.skip_recent = SKIP_RECENT
        _spy(pipe, store)
        store["res"] = pipe.run(seq, max_frames=RUN_TICKS)
    assert next(evt, None) is None and next(img, None) is None
    return store


def test_esvio_loop_branch_matches_jax(jax_run, port_run):
    # both sides render with synth_np, so this checks that the two fixtures
    # pass the renderer the same arguments, not the renderer itself;
    # test_torch_no_jax.py holds synth_np's frames, events and IMU to
    # tests/synth.py's bit for bit over the sequence's first 0.3 s only
    for side in ("images_left", "images_right"):
        js, ts = getattr(jax_run["seq"], side), getattr(port_run["seq"], side)
        np.testing.assert_array_equal(ts[0], js[0])
        np.testing.assert_array_equal(ts[1], js[1])
    jres, tres = jax_run["res"], port_run["res"]
    assert len(jres.stamps) > 0 and tres.stamps == jres.stamps
    dev = np.linalg.norm(np.asarray(tres.P) - np.asarray(jres.P), axis=1)
    print("per-tick |P_port - P_jax| (m):", np.array2string(dev, precision=6))
    assert dev.max() < MAX_DEV_M, dev
    jk, tk = jax_run["kf"], port_run["kf"]
    assert len(jk) >= 4 and [s for s, _ in tk] == [s for s, _ in jk]
    for (_, a), (_, b) in zip(jk, tk):
        assert b.shape == (120, 160)
        np.testing.assert_array_equal(b, a)
    jl = [_loop_key(i) for i in jax_run["loops"]]
    tl = [_loop_key(i) for i in port_run["loops"]]
    assert jl and tl == jl, (tl, jl)
    assert port_run["res"].n_loops == jax_run["res"].n_loops == len(jl)


def test_esvio_first_relocalization_matches_jax(jax_run, port_run):
    """The first loop's relocalization: the match the closer hands the
    estimator, and the estimator's window solve of it one tick later."""
    js, ts = jax_run["relo_set"], port_run["relo_set"]
    assert js and len(ts) == len(js)
    (jt, jstamp, jids, jun, jP, jQ), (tt, tstamp, tids, tun, tP, tQ) = \
        js[0], ts[0]
    # handed over on the tick the first loop closed
    assert (tt, tstamp) == (jt, jstamp) and jt == jax_run["loops"][0][0]
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tun, jun, atol=1e-6)
    np.testing.assert_allclose(tP, jP, atol=MAX_DEV_M)
    np.testing.assert_allclose(np.sign(float(tQ @ jQ)) * tQ, jQ,
                               atol=MAX_DEV_Q)
    jr, tr = jax_run["relo_solved"], port_run["relo_solved"]
    assert jr and len(tr) == len(jr)
    a, b = jr[0], tr[0]
    assert a["tick"] == jt + 1 == RUN_TICKS and b["tick"] == a["tick"]
    for k in ("i", "n", "frame_stamp"):
        assert b[k] == a[k], k
    assert abs(a["frame_stamp"] - jstamp) < 1e-4
    # the joint in-window solve on both sides, accepted or rejected alike
    assert (a["refined"] is None) == (b["refined"] is None)
    assert (a["out"] is None) == (b["out"] is None)
    if a["out"] is not None:
        # accepted: the refined pose feeds the drift (rejected, it is unused
        # and left wherever the relo rows' outliers pulled it)
        np.testing.assert_allclose(b["refined"][0], a["refined"][0],
                                   atol=MAX_DEV_M)
        qa, qb = a["refined"][1], b["refined"][1]
        np.testing.assert_allclose(np.sign(float(qa @ qb)) * qb, qa,
                                   atol=MAX_DEV_Q)
        for k in ("relative_t", "P_old"):
            np.testing.assert_allclose(b["out"][k], a["out"][k],
                                       atol=MAX_DEV_M)
        assert abs(b["out"]["relative_yaw"] - a["out"]["relative_yaw"]) \
            < np.degrees(MAX_DEV_M / 4.0)
