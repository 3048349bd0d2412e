"""The port's run CLI (`python -m esvio_tpu_torch.apps.run`) on the CPU,
against the port's own Pipeline and the JAX package's CLI.

The golden sequence is written as an npz (save_npz) beside reference-style
YAML files (synth_np.write_config_yamls).  The CLI builds its pipeline from
the YAML alone, as the JAX CLI does, so its tracker and estimator take
their default sizes (not the golden's code-level ones): on the golden it
reaches NON_LINEAR at tick 13, hence 16 frames here
(tests/golden_defaults_sweep.py names the sizes that move it).

Tolerances: against the port's Pipeline none — summaries, trajectories and
files equal.  Against the JAX CLI on the same files, the golden's
(tests/test_golden_trace.py): the same frames, NON_LINEAR stamps (1e-6 s)
and restarts, the trajectory within MAX_DEV_M of the JAX CLI's once yaw
and translation, which VIO cannot observe, are aligned, and its ATE at
most 1.5x the JAX CLI's + 0.01 m.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its torch thread cap)
from synth_np import GOLDEN, vio_pipeline, write_rosbag
from esvio_tpu_torch.apps import run as trun
from esvio_tpu_torch.apps.pipeline import Pipeline
from esvio_tpu_torch.io import datasets as tds

TESTS = os.path.dirname(os.path.abspath(__file__))
FRAMES = 16
EVENT_CAPACITY = 1 << 15
MAX_DEV_M = 0.05          # tests/test_golden_trace.py:83
JAX_SUMMARY_KEYS = {"config", "seq", "frames", "restarts", "loops", "out",
                    "stage_ms", "ate_rmse_m"}


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    _, seq, gt_t, gt_P = vio_pipeline("cpu", **GOLDEN, config_dir=str(d))
    seq.ground_truth = (gt_t, gt_P)
    npz = str(d / "seq.npz")
    tds.save_npz(seq, npz)
    return str(d / "esvio.yaml"), npz


def _run_cli(main, cfg_path, npz, out, *extra):
    """(exit code, summary) of one CLI's run of FRAMES ticks."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--config", cfg_path, "--seq", npz, "--out", out,
                   "--max-frames", str(FRAMES), "--event-capacity",
                   str(EVENT_CAPACITY), *extra])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _recording(mod, packets, replay=None):
    """`mod.trk.track_event_stereo` that appends each tick's packet to
    `packets`, or with `replay` (an iterator) returns its packets instead
    of tracking."""
    track = mod.trk.track_event_stereo

    def tracked(*a, **k):
        if replay is not None:
            return a[3], next(replay)
        state, pkt = track(*a, **k)
        packets.append(pkt)
        return state, pkt
    return tracked


@pytest.fixture(scope="module")
def port_cli(golden_files, tmp_path_factory):
    """The port CLI's run of FRAMES ticks: (exit code, summary, out dir,
    its event tracker's packet of each tick)."""
    import esvio_tpu_torch.apps.pipeline as tpipe
    out, packets = str(tmp_path_factory.mktemp("cli")), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe.trk, "track_event_stereo", _recording(tpipe, packets))
        rc, summary = _run_cli(trun.main, *golden_files, out, "--device", "cpu")
    return rc, summary, out, packets


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tum(out):
    return np.loadtxt(os.path.join(out, "esvio_result_no_loop.tum"), ndmin=2)


def test_cli_equals_pipeline_run(golden_files, port_cli, tmp_path):
    cfg_path, npz = golden_files
    rc, summary, out, _ = port_cli
    assert rc == 0
    assert set(summary) == JAX_SUMMARY_KEYS
    assert summary["frames"] >= 2 and summary["restarts"] == 0

    from esvio_tpu_torch.io.config import load_config
    cfg = load_config(cfg_path)
    res = Pipeline(cfg, cfg.cameras, "cpu", event_capacity=EVENT_CAPACITY).run(
        tds.load_npz(npz), max_frames=FRAMES)
    assert summary["frames"] == len(res.stamps)
    seq = tds.load_npz(npz)
    assert summary["ate_rmse_m"] == res.ate(*seq.ground_truth)
    ref = str(tmp_path / "ref")
    res.write(ref)
    for name in ("esvio_result_no_loop.csv", "esvio_result_no_loop.tum"):
        got = open(os.path.join(out, name)).read()
        assert got == open(os.path.join(ref, name)).read(), name
        assert len(got.splitlines()) == summary["frames"]
    assert _tum(out).shape == (summary["frames"], 8)


def _same_run(a, out_a, b, out_b):
    """Two CLI runs (summary, out dir) agree within the golden's
    tolerances (module docstring)."""
    from esvio_tpu_torch.io.trajectory import _yaw_alignment
    assert a["frames"] == b["frames"] and a["restarts"] == b["restarts"], (a, b)
    if a["frames"] == 0:
        return
    ta, tb = _tum(out_a), _tum(out_b)
    np.testing.assert_allclose(ta[:, 0], tb[:, 0], rtol=0, atol=1e-6)
    _, R, t = _yaw_alignment(ta[:, 1:4], tb[:, 1:4])
    dev = np.linalg.norm(ta[:, 1:4] @ R.T + t - tb[:, 1:4], axis=1).max()
    assert dev < MAX_DEV_M, dev
    if a["frames"] >= 2:
        assert a["ate_rmse_m"] <= 1.5 * b["ate_rmse_m"] + 0.01, (a, b)


def _save_packets(path, packets):
    np.savez(path, **{
        f"{k}.{f.name}": (getattr(p, f.name).numpy()
                          if isinstance(getattr(p, f.name), torch.Tensor)
                          else np.asarray(getattr(p, f.name)))
        for k, p in enumerate(packets) for f in dataclasses.fields(p)})


def _load_packets(path, cls, conv):
    z = np.load(path)
    n = 1 + max(int(k.split(".")[0]) for k in z.files)
    return [cls(**{f.name: conv(z[f"{k}.{f.name}"])
                   for f in dataclasses.fields(cls)}) for k in range(n)]


def jax_cli_child(cfg_path, npz, out, replay, record):
    """One JAX CLI run of FRAMES ticks, as a process of its own: on the
    tracker's packets, or on those saved in `replay`; with `record`, its
    tracker's packets saved there.  Prints [exit code, summary].  The JAX
    CLI compiles anew at each init attempt: two such runs beside a test
    worker's other JAX programs ran XLA:CPU out of memory maps."""
    import conftest  # noqa: F401 (the suite's JAX settings: CPU, x64)
    import jax.numpy as jnp
    import esvio_tpu.apps.pipeline as jpipe
    from esvio_tpu.apps import run as jrun
    packets = []
    jpipe.trk.track_event_stereo = _recording(jpipe, packets, iter(
        _load_packets(replay, jpipe.trk.FeaturePacket, jnp.asarray))
        if replay else None)
    rc, summary = _run_cli(jrun.main, cfg_path, npz, out)
    if record:
        _save_packets(record, packets)
    print(json.dumps([rc, summary]))


def _jax_cli(files, out, replay="", record=""):
    """Starts jax_cli_child in a process of its own; returns a function that
    waits for it and gives its [exit code, summary]."""
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import "
            "test_torch_run_cli as m; m.jax_cli_child(*sys.argv[2:])")
    p = subprocess.Popen([sys.executable, "-c", code, TESTS, *files, out,
                          replay, record], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         cwd=os.path.dirname(TESTS))

    def result():
        try:
            stdout, stderr = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            raise
        assert p.returncode == 0, stderr[-4000:]
        return json.loads(stdout.strip().splitlines()[-1])
    return result


def test_cli_matches_jax_cli(golden_files, port_cli, tmp_path):
    """Both packages' CLIs on the same YAML and npz, FRAMES ticks each.
    At the CLI's default sizes the stereo init of this sequence is
    marginal: the JAX CLI never reaches NON_LINEAR in these ticks, the
    port's reaches it at tick 13 on its own packets, which differ from
    JAX's by float32 ulps (test_torch_frontend.py).  So the port CLI is
    held to the JAX CLI's run on the JAX tracker's packets, and the JAX
    CLI to the port CLI's run on the port's packets
    (test_torch_run_cli_jax_packets.py; tolerances above)."""
    import esvio_tpu_torch.apps.pipeline as tpipe
    rc, summary, _, _ = port_cli
    outs = {k: str(tmp_path / k) for k in ("jax", "port_on_jax")}
    jpk = str(tmp_path / "jax_packets.npz")
    runs = {"jax": _jax_cli(golden_files, outs["jax"], record=jpk)()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe.trk, "track_event_stereo", _recording(
            tpipe, [], iter(_load_packets(jpk, tpipe.trk.FeaturePacket,
                                          torch.from_numpy))))
        runs["port_on_jax"] = _run_cli(trun.main, *golden_files,
                                       outs["port_on_jax"], "--device", "cpu")
    assert rc == 0 and all(r == 0 for r, _ in runs.values())
    assert set(runs["jax"][1]) <= JAX_SUMMARY_KEYS
    print("frames: port", summary["frames"], {k: s["frames"]
                                              for k, (_, s) in runs.items()})
    _same_run(runs["port_on_jax"][1], outs["port_on_jax"], runs["jax"][1],
              outs["jax"])


def test_cli_convert_equals_jax_cli(golden_files, tmp_path, capsys):
    """--convert of a bz2 bag (synth_np.write_rosbag, 0.2 s of the golden's
    events and IMU) by both CLIs: the same summary and the same npz."""
    from esvio_tpu.apps import run as jrun
    from synth_np import planar_vio_sequence_rot
    cfg_path, _ = golden_files
    seq, _, _ = planar_vio_sequence_rot(np.random.default_rng(0), duration=0.2)
    bag = write_rosbag(str(tmp_path / "seq.bag"), seq, 120, 160)
    outs = {}
    for name, mod in (("jax", jrun), ("torch", trun)):
        outs[name] = str(tmp_path / f"{name}.npz")
        assert mod.main(["--config", cfg_path, "--convert", bag,
                         "--out", outs[name]]) == 0
        s = _summary(capsys)
        assert s["converted"] == outs[name]
        assert s["events_left"] == len(seq.events_left.t)
        assert s["imu"] == len(seq.imu.t)
    a, b = np.load(outs["jax"]), np.load(outs["torch"])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    conv = tds.load_npz(outs["torch"])
    np.testing.assert_array_equal(conv.events_left.x, seq.events_left.x)
    np.testing.assert_allclose(conv.events_left.t, seq.events_left.t,
                               rtol=0, atol=1e-6)
