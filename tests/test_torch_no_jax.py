"""The port stands without JAX: in a fresh interpreter where `import jax`
fails, every module of esvio_tpu_torch imports, two ESIO and two ESVIO
pipeline ticks run on the CPU, three ESIO ticks with loop closure, fast
relocalization and motion correction on (the third tick warps its events)
and their result files and pose graph are written (and the graph loaded
back), a loop closer registers a keyframe and survives save/load, the CG pose-graph solve runs, and chip_smoke and
chip_ab import (without running).  Nothing of jax or esvio_tpu may be
loaded along the way.  tests/synth_np.py, which these drives use, is held
bit for bit against tests/synth.py on the loop sequence's smooth texture
with IMU biases and noise."""
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
    the IMU biases and the IMU noise of tests/synth.py, bit for bit, on
    0.3 s of the loop sequence."""
    import numpy as np
    import synth
    import synth_np
    kw = dict(duration=0.3, texture="smooth",
              gyr_bias=synth_np.LOOP_GYR_BIAS, acc_bias=synth_np.LOOP_ACC_BIAS,
              gyr_n=0.01, acc_n=0.05)
    a, ta, pa = synth.planar_vio_sequence_rot(
        np.random.default_rng(0), imu_noise_rng=np.random.default_rng(5), **kw)
    b, tb, pb = synth_np.planar_vio_sequence_rot(
        np.random.default_rng(0), imu_noise_rng=np.random.default_rng(5), **kw)
    for side in ("events_left", "events_right"):
        for f in ("t", "x", "y", "p"):
            np.testing.assert_array_equal(getattr(getattr(b, side), f),
                                          getattr(getattr(a, side), f))
    for f in ("t", "acc", "gyr"):
        np.testing.assert_array_equal(getattr(b.imu, f), getattr(a.imu, f))
    np.testing.assert_array_equal(tb, ta)
    np.testing.assert_array_equal(pb, pa)
    assert len(a.events_left.t) > 1000
