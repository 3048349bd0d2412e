"""The port stands without JAX: in a fresh interpreter where `import jax`
fails, every module of esvio_tpu_torch imports, two ESIO and two ESVIO
pipeline ticks run on the CPU, three ESIO ticks with loop closure, fast
relocalization and motion correction on (the third tick warps its events)
and their result files and pose graph are written (and the graph loaded
back), a loop closer registers a keyframe and survives save/load, the CG pose-graph solve runs, a pipeline built
from reference-style YAML files (io.config.load_config) runs two ticks,
the mono drive of tests/test_estimator.py initializes through the
monocular fallback, every camera kind loads from its YAML file and lifts
a pixel, the run CLI runs three ticks from an npz, a rosbag converts, the
mono drive's estimator is checkpointed and loaded back, greedy spacing
runs once, the native packetizer chunks a stream, a pinhole calibration
and the chessboard detector run, a one-process sharded window solve runs,
and chip_smoke and chip_ab import (without running).  Nothing of jax or esvio_tpu may be
loaded along the way.  tests/synth_np.py, which these drives use, is held
bit for bit against tests/synth.py on the loop sequence's smooth texture
with IMU biases and noise and stereo frames."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None              # any `import jax` now raises
    sys.path[:0] = [{root!r}, {tests!r}]
    import torch
    torch.set_num_threads(2)
    import esvio_tpu_torch
    for m in pkgutil.walk_packages(esvio_tpu_torch.__path__, "esvio_tpu_torch."):
        importlib.import_module(m.name)
    from synth_np import vio_pipeline
    for mode in ("esio", "esvio"):
        make_pipeline, seq, _, _ = vio_pipeline("cpu", H=120, W=160, focal=200.0,
                                                duration=0.3, mode=mode)
        res = make_pipeline().run(seq, max_frames=2)
        assert res.metrics["ticks"] == 2, res.metrics
    assert res.stage_times["frontend_image"]["n"] == 2, res.stage_times
    import os, tempfile
    import numpy as np
    from synth_np import blob_texture, loop_pipeline, sample_texture
    make_pipeline, seq, _, _ = loop_pipeline("cpu", duration=0.3,
                                             motion_correction=True)
    pipe = make_pipeline()
    res = pipe.run(seq, max_frames=3)
    assert res.metrics["ticks"] == 3 and pipe._last_v is not None, res.metrics
    tmp = tempfile.mkdtemp()
    res.write(tmp)
    assert os.path.exists(os.path.join(tmp, "esvio_result_no_loop.csv"))
    pipe.save_pose_graph(os.path.join(tmp, "session.npz"))
    pipe.load_pose_graph(os.path.join(tmp, "session.npz"))
    assert pipe.sequence == 1, pipe.sequence   # the next session's sequence
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.loop import loop_closure, pose_graph
    tex, margin = blob_texture(np.random.default_rng(0), 120, 160, n_blobs=200)
    img = sample_texture(tex, margin, 120, 160, 0.0, 0.0)
    cam = camera.make_pinhole(200.0, 200.0, 80.0, 60.0, width=160, height=120)
    lc = loop_closure.LoopCloser(loop_closure.LoopConfig(fast_threshold=15),
                                 cam=cam, device="cpu")
    uv = np.array([[40.0, 30], [100, 50], [70, 90], [120, 80]])
    lc.add_keyframe(0.0, np.zeros(3), np.array([1.0, 0, 0, 0]),
                    np.ones((4, 3)), uv, np.ones(4, bool), img)
    lc.save(os.path.join(tmp, "graph.npz"))
    lc2 = loop_closure.LoopCloser.load(os.path.join(tmp, "graph.npz"),
                                       cam=cam, device="cpu")
    assert lc2.db.count == 1 and lc2.db.ext_valid[0].sum() > 0
    K = 64
    z = torch.zeros(K)
    t = torch.cumsum(torch.full((K, 3), 0.1), 0)
    li = torch.tensor([0, 1]); lj = torch.tensor([40, 41])
    yaw, t2 = pose_graph.optimize_4dof_cg(
        z, t, z, z, torch.ones(K, dtype=torch.bool), torch.tensor(0), li, lj,
        torch.zeros(2, 3), torch.zeros(2), torch.ones(2, dtype=torch.bool),
        cg_iters=20)
    assert torch.isfinite(t2).all() and (t2 - t).abs().max() > 0
    from synth_np import (CAMERA_KINDS, estimator_drive, feed_imu,
                          write_camera_yaml)
    make_pipeline, seq, _, _ = vio_pipeline("cpu", H=120, W=160, focal=200.0,
                                            duration=0.3, config_dir=tmp)
    pipe = make_pipeline()
    assert pipe.sys_cfg.event_left_calib == "event0.yaml", pipe.sys_cfg
    assert pipe.run(seq, max_frames=2).metrics["ticks"] == 2
    from esvio_tpu_torch.vio import estimator as est_mod
    traj, ex_p, ex_q, packets, kw = estimator_drive("mono", 11)
    est = est_mod.Estimator(est_mod.EstimatorConfig(**kw), ex_p, ex_q, "cpu")
    for f, pkt in enumerate(packets):
        if f > 0:
            feed_imu(est, traj, f)
        est.process_packets(traj["t"][f], pkt)
    assert est.solver_flag == "NON_LINEAR", est.solver_flag
    from esvio_tpu_torch.io.config import load_camera_yaml
    for kind in CAMERA_KINDS:
        cam = load_camera_yaml(write_camera_yaml(tmp, kind, 346, 260))
        ray = camera.lift_projective(cam, torch.tensor([[100.0, 80.0]]))
        px = camera.space_to_plane(cam, ray)
        assert torch.isfinite(ray).all() and torch.isfinite(px).all(), kind
    # the run CLI on an npz (3 ticks), a rosbag conversion, an estimator
    # checkpoint saved and loaded, one greedy spacing call
    import contextlib, io, json
    from synth_np import write_rosbag
    from esvio_tpu_torch.apps import run as run_cli
    from esvio_tpu_torch.io import datasets as ds
    make_pipeline, seq, gt_t, gt_P = vio_pipeline("cpu", H=120, W=160,
                                                  focal=200.0, duration=0.3,
                                                  config_dir=tmp)
    seq.ground_truth = (gt_t, gt_P)
    ds.save_npz(seq, os.path.join(tmp, "seq.npz"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_cli.main(["--config", os.path.join(tmp, "esvio.yaml"),
                           "--seq", os.path.join(tmp, "seq.npz"),
                           "--out", os.path.join(tmp, "cli"),
                           "--max-frames", "3", "--device", "cpu"])
    assert rc == 0 and json.loads(out.getvalue().splitlines()[-1])["restarts"] == 0
    assert os.path.exists(os.path.join(tmp, "cli", "esvio_result_no_loop.tum"))
    from esvio_tpu_torch.io import rosbag
    bag = write_rosbag(os.path.join(tmp, "seq.bag"), seq, 120, 160)
    conv = rosbag.convert_rosbag(bag, event_left="/davis_left/events",
                                 imu="/davis_left/imu")
    assert np.array_equal(conv.events_left.x, seq.events_left.x)
    from esvio_tpu_torch.vio import checkpoint
    checkpoint.save_estimator(est, os.path.join(tmp, "est.npz"))
    est2 = checkpoint.load_estimator(
        est_mod.Estimator(est_mod.EstimatorConfig(**kw), ex_p, ex_q, "cpu"),
        os.path.join(tmp, "est.npz"))
    assert est2.solver_flag == "NON_LINEAR" and torch.equal(est2.ws.P, est.ws.P)
    from esvio_tpu_torch.frontend import mask
    keep, occ = mask.greedy_spacing(torch.arange(5.0), torch.tensor(
        [10.0, 12, 40, 70, 71]), torch.full((5,), 20.0),
        torch.ones(5, dtype=torch.bool), 40, 80, min_dist=5, max_keep=10)
    assert keep.tolist() == [False, True, True, False, True], keep
    # the native packetizer, a pinhole calibration with the chessboard
    # detector, and a one-process sharded solve (lm = 2) with its dry run
    from esvio_tpu_torch.io import native
    stamps, *_ = native.packetize(seq.events_left.t, seq.events_left.x,
                                  seq.events_left.y, seq.events_left.p,
                                  float(seq.events_left.t[0]), 15.0, 256, 4)
    assert len(stamps) == 4
    from esvio_tpu_torch.apps import calib, chessboard
    from synth_np import CALIB_GT, calib_observations, render_chessboard
    gt = CALIB_GT["pinhole"]
    cam = camera.make_pinhole(gt["fx"], gt["fy"], gt["cx"], gt["cy"],
                              dist=tuple(gt["dist"]), width=640, height=480,
                              dtype=torch.float64)
    obj, img = calib_observations(lambda pc: camera.space_to_plane(
        cam, torch.as_tensor(pc)).numpy())
    res = calib.calibrate_pinhole(obj, img, iters=10, device="cpu")
    assert res["rms"] < 0.15 and abs(res["fx"] - gt["fx"]) < 1.0, res["rms"]
    board, corners = render_chessboard(5, 7)
    grid, ok = chessboard.find_chessboard(board, 5, 7, device="cpu")
    assert ok and np.abs(grid - corners).max() < 1.0
    from esvio_tpu_torch.dist import distributed_ba, dryrun, sharding
    args = dryrun.make_problem(torch.float32, L_img=8, L_evt=16, batch=2,
                               device="cpu")
    costs = distributed_ba.make_sharded_solver(
        sharding.make_mesh(dp=2, lm=2), iters=2)(*args)[3]
    assert costs.shape == (2, 2) and torch.isfinite(costs).all()
    import chip_smoke, chip_ab
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and m.split(".")[0] in ("jax", "jaxlib", "esvio_tpu")]
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def test_port_imports_and_runs_without_jax():
    code = SCRIPT.format(root=ROOT, tests=os.path.join(ROOT, "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_synth_np_reproduces_the_loop_sequence():
    """The smooth texture (bicubic value noise, the contrast event model),
    the IMU biases, the IMU noise and the stereo frames of tests/synth.py,
    bit for bit, on 0.3 s of the loop sequence: every option
    test_torch_esvio_loops.py's JAX run renders with synth_np."""
    import numpy as np
    import synth
    import synth_np
    kw = dict(duration=0.3, texture="smooth",
              gyr_bias=synth_np.LOOP_GYR_BIAS, acc_bias=synth_np.LOOP_ACC_BIAS,
              gyr_n=0.01, acc_n=0.05, frame_hz=15)
    a, ta, pa = synth.planar_vio_sequence_rot(
        np.random.default_rng(0), imu_noise_rng=np.random.default_rng(5), **kw)
    b, tb, pb = synth_np.planar_vio_sequence_rot(
        np.random.default_rng(0), imu_noise_rng=np.random.default_rng(5), **kw)

    def same(x, y, what):
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=str(what))

    for side in ("events_left", "events_right"):
        for f in ("t", "x", "y", "p"):
            same(getattr(getattr(b, side), f), getattr(getattr(a, side), f),
                 (side, f))
    for f in ("t", "acc", "gyr"):
        same(getattr(b.imu, f), getattr(a.imu, f), ("imu", f))
    for side in ("images_left", "images_right", "ground_truth"):
        for x, y in zip(getattr(b, side), getattr(a, side)):
            same(x, y, side)
    same(tb, ta, "gt_t")
    same(pb, pa, "gt_P")
    assert len(a.events_left.t) > 1000 and len(a.images_left[0]) == 4
