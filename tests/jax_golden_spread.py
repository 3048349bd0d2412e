"""The JAX package's own standing against a golden trace, and its spread
when only the event tracker's RANSAC key changes.

    JAX_PLATFORMS=cpu python tests/jax_golden_spread.py esvio default 1 2 3
    JAX_PLATFORMS=cpu python tests/jax_golden_spread.py loops 0 1 1:2
    JAX_PLATFORMS=cpu python tests/jax_golden_spread.py loops gauge

runs the golden pipeline of tests/test_golden_trace.py (mode "esio" or
"esvio", the JAX package's default fused path, the test suite's JAX
settings) once per seed ("default" keeps the tracker's own key) and prints
one line of gates each (synth_np.golden_gates: stamps, max deviation
unaligned and after the yaw + translation alignment, ATE).  The port's
chip_smoke holds its ESVIO golden run to what these runs meet.

Mode "loops" runs the loop-closure sequence of tests/test_e2e_loops.py
(ESIO 120x160, 3.6 s, smooth texture, IMU biases, loop closure + fast
relocalization) once per argument, "M" or "M:SEED" with M 0 or 1 for
do_motion_correction and SEED the event tracker's RANSAC key (default:
its own), and prints the gates of that test, the loops closed and the
ticks that took the in-window relocalization solve: chip_smoke's phase 12
holds the port to what these runs meet.

`loops gauge` runs the JAX pipeline and the port's on that sequence with
motion correction for the first 16 ticks and prints, per tick, how far
apart their outputs P and V are, and how far apart the inputs of their
motion correction (mean gyro, velocity feedback) are.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def loop_run(motion: bool):
    """The JAX pipeline on tests/test_e2e_loops.py's sequence and config,
    with do_motion_correction = motion.  Returns (res, gt_t, gt_P, relo)
    with relo = dict(solves=relocalization solves, feedback=Output.relo
    results)."""
    import numpy as np
    from esvio_tpu.apps.pipeline import Pipeline
    from esvio_tpu.core import camera
    from esvio_tpu.frontend import tracker as trk
    from esvio_tpu.io.config import SystemConfig
    from esvio_tpu.solver import gauss_newton as gn
    from esvio_tpu.vio import estimator as est_mod
    from synth import planar_vio_sequence_rot

    H, W, FOCAL, BASELINE, PLANE_Z = 120, 160, 200.0, 0.10, 4.0
    seq, gt_t, gt_P = planar_vio_sequence_rot(
        np.random.default_rng(0), H=H, W=W, focal=FOCAL, plane_z=PLANE_Z,
        baseline=BASELINE, duration=3.6, texture="smooth",
        gyr_bias=np.array([0.01, -0.015, 0.008]),
        acc_bias=np.array([0.05, 0.03, -0.08]))
    cam = camera.make_pinhole(fx=FOCAL, fy=FOCAL, cx=W / 2, cy=H / 2,
                              width=W, height=H)
    R = np.eye(3)
    sys_cfg = SystemConfig(
        system_mode=0, event_width=W, event_height=H, image_width=W,
        image_height=H, R_body_cam0=R, t_body_cam0=np.zeros(3),
        R_body_cam1=R, t_body_cam1=np.array([BASELINE, 0, 0]),
        R_body_event0=R, t_body_event0=np.zeros(3),
        R_body_event1=R, t_body_event1=np.array([BASELINE, 0, 0]),
        freq=15, max_cnt=60, min_dist=10, loop_closure=1,
        fast_relocalization=1, do_motion_correction=motion)
    pipe = Pipeline(sys_cfg, cams={"event0": cam, "event1": cam},
                    tracker_cfg=trk.TrackerConfig(
                        width=W, height=H, capacity=128, cand_capacity=512,
                        max_cnt=60, min_dist=10, lk_iters=15),
                    est_cfg=est_mod.EstimatorConfig(
                        mode="esio", evt_capacity=256, img_capacity=8,
                        min_track_for_kf=15),
                    event_capacity=1 << 15)
    pipe.loop_closer.cfg.skip_recent = 12
    pipe.loop_closer.db.skip_recent = 12
    relo = dict(solves=0, feedback=0)
    real_solve, real_finish = gn.solve_window_relo, est_mod.Estimator._finish_relo

    def solve(*a, **k):
        relo["solves"] += 1
        return real_solve(*a, **k)

    def finish(self, prep):
        out = real_finish(self, prep)
        relo["feedback"] += out is not None
        return out

    gn.solve_window_relo, est_mod.Estimator._finish_relo = solve, finish
    try:
        res = pipe.run(seq)
    finally:
        gn.solve_window_relo, est_mod.Estimator._finish_relo = \
            real_solve, real_finish
    return res, gt_t, gt_P, relo


def loops_gauge(n_ticks=16):
    """Per tick: |P_jax - P_port|, |V_jax - V_port|; per warp: the largest
    difference between the two sides' motion-correction inputs."""
    import numpy as np
    import torch
    from esvio_tpu.apps.pipeline import Pipeline as JaxPipeline
    from esvio_tpu.events import motion as jmotion
    from esvio_tpu_torch.apps import pipeline as tpipe
    from synth_np import loop_pipeline

    inputs = {"jax": [], "port": []}

    def spy(side, real):
        def warp(chunk, fx, fy, cx, cy, omega, v_cur, v_prev, accel, t0,
                 width, height):
            inputs[side].append(np.concatenate([np.asarray(a, float).ravel()
                                                for a in (omega, v_cur, v_prev)]))
            return real(chunk, fx, fy, cx, cy, omega, v_cur, v_prev, accel,
                        t0, width=width, height=height)
        return warp

    outs = {"jax": [], "port": []}

    def record(est, side):
        real = est.process_packets

        def run(*args):
            out = real(*args)
            outs[side].append((out.solver_flag, np.asarray(out.P, float),
                               np.asarray(out.V, float)))
            return out
        est.process_packets = run

    real_j, real_t = jmotion.motion_correct_chunk, tpipe.motion_correct_chunk
    real_run = JaxPipeline.run
    jmotion.motion_correct_chunk = spy("jax", real_j)
    tpipe.motion_correct_chunk = spy("port", real_t)

    def jax_run(self, seq, **kw):
        record(self.estimator, "jax")
        return real_run(self, seq, max_frames=n_ticks)

    JaxPipeline.run = jax_run
    try:
        torch.set_num_threads(4)
        make_pipeline, seq, _, _ = loop_pipeline("cpu", motion_correction=True)
        pipe = make_pipeline()
        record(pipe.estimator, "port")
        pipe.run(seq, max_frames=n_ticks)
        loop_run(True)
    finally:
        jmotion.motion_correct_chunk, tpipe.motion_correct_chunk = real_j, real_t
        JaxPipeline.run = real_run
    for k, ((fj, Pj, Vj), (ft, Pt, Vt)) in enumerate(zip(outs["jax"],
                                                        outs["port"])):
        print(f"gauge tick {k}: {fj}/{ft}, |dP| {np.abs(Pj - Pt).max():.4f} m, "
              f"|dV| {np.abs(Vj - Vt).max():.4f} m/s", flush=True)
    for k, (a, b) in enumerate(zip(inputs["jax"], inputs["port"])):
        print(f"gauge warp {k // 2} ({'left' if k % 2 == 0 else 'right'} camera):"
              f" inputs differ by {np.abs(a - b).max():.4f}", flush=True)


def main_loops(argv):
    if argv == ["gauge"]:
        return loops_gauge()
    import jax
    import numpy as np
    from esvio_tpu.frontend import tracker as trk
    from esvio_tpu.io import trajectory as traj_io
    real = trk.init_state
    for arg in argv:
        motion, _, seed = arg.partition(":")
        key = jax.random.PRNGKey(int(seed)) if seed else None
        trk.init_state = lambda cfg, key_=key, **kw: real(cfg, key=key_, **kw)
        t0 = time.perf_counter()
        try:
            res, gt_t, gt_P, relo = loop_run(bool(int(motion)))
        finally:
            trk.init_state = real
        ate = res.ate(gt_t, gt_P, alignment="yaw")
        ate_loop = traj_io.ate_rmse(np.asarray(res.stamps),
                                    np.asarray(res.P_loop), gt_t, gt_P,
                                    alignment="yaw") if res.P_loop else \
            float("nan")
        print(f"loops motion_correction {motion} key {seed or 'default'}: "
              f"restarts {res.n_restarts}, "
              f"{len(res.stamps)} NON_LINEAR stamps, ATE {ate:.4f} m, loop "
              f"ATE {ate_loop:.4f} m (gate {ate * 1.3 + 0.03:.4f}), "
              f"{res.n_loops} loops, {relo['solves']} relocalization solves, "
              f"{relo['feedback']} relo feedbacks; "
              f"{time.perf_counter() - t0:.0f} s", flush=True)


def main(argv):
    import conftest  # noqa: F401  (the suite's JAX settings: CPU, x64, cache)
    import jax
    if argv[0] == "loops":
        return main_loops(argv[1:])
    from esvio_tpu.frontend import tracker as trk
    from synth_np import golden_gates
    from test_golden_trace import GOLDEN, GOLDEN_ESVIO, run_golden_pipeline

    mode, seeds = argv[0], argv[1:]
    npz = GOLDEN_ESVIO if mode == "esvio" else GOLDEN
    real = trk.init_state
    for seed in seeds:
        key = None if seed == "default" else jax.random.PRNGKey(int(seed))
        trk.init_state = lambda cfg, key_=key, **kw: real(cfg, key=key_, **kw)
        t0 = time.perf_counter()
        res, gt_t, gt_P = run_golden_pipeline(mode)
        g = golden_gates(res, gt_t, gt_P, npz)
        print(f"{mode} seed {seed}: stamps {g['n_stamps']}/{g['n_golden']} "
              f"ok {g['stamps_ok']}, max dev {g['max_dev']:.4f} m unaligned, "
              f"{g['max_dev_4dof']:.4f} m aligned (yaw {g['yaw_deg']:.2f} deg, "
              f"shift {g['shift_m']:.4f} m), ATE {g['ate']:.4f} m (golden "
              f"{g['ate_golden']:.4f}, gate ok {g['ate_ok']}); "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    trk.init_state = real


if __name__ == "__main__":
    main(sys.argv[1:])
