"""Parity: the port's file loaders (esvio_tpu_torch.io.datasets npz and
HDF5, io.rosbag) and ATE (io.trajectory.ate_rmse) against esvio_tpu.io.

Tolerances: arrays read from files exact (both packages read the same
bytes); event times read from a bag within 1e-9 s of the written ones (the
bag stores integer nanoseconds); ATE within 1e-12 m in float64.
"""
import numpy as np
import pytest

import torch_parity  # noqa: F401 (its torch thread cap)
from esvio_tpu.io import datasets as jds
from esvio_tpu.io import rosbag as jbag
from esvio_tpu.io import trajectory as jtraj
from esvio_tpu_torch.io import datasets as tds
from esvio_tpu_torch.io import rosbag as tbag
from esvio_tpu_torch.io import trajectory as ttraj


def _sequence(mod, rng, n=300, images=True):
    ev = lambda: mod.EventStream(np.sort(rng.uniform(0, 1, n)),
                                 rng.integers(0, 346, n).astype(np.int32),
                                 rng.integers(0, 260, n).astype(np.int32),
                                 rng.integers(0, 2, n).astype(np.int32))
    imgs = (np.arange(0, 1, 0.25), rng.integers(0, 255, (4, 12, 16)).astype(
        np.uint8)) if images else None
    return mod.SequenceData(
        ev(), ev(), mod.ImuStream(np.arange(0, 1, 0.01),
                                  rng.normal(size=(100, 3)),
                                  rng.normal(size=(100, 3))),
        images_left=imgs, images_right=imgs,
        ground_truth=(np.arange(0, 1, 0.1), rng.normal(size=(10, 3))))


def _assert_same_sequence(a, b):
    for side in ("events_left", "events_right"):
        for f in ("t", "x", "y", "p"):
            x, y = getattr(getattr(a, side), f), getattr(getattr(b, side), f)
            assert x.dtype == y.dtype, (side, f)
            np.testing.assert_array_equal(x, y)
    for f in ("t", "acc", "gyr"):
        np.testing.assert_array_equal(getattr(a.imu, f), getattr(b.imu, f))
    for f in ("images_left", "images_right", "ground_truth"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_written_by_either_package_reads_in_both(rng, tmp_path, writer):
    seq = _sequence(jds if writer == "jax" else tds, rng)
    path = str(tmp_path / "seq.npz")
    (jds if writer == "jax" else tds).save_npz(seq, path)
    a, b = jds.load_npz(path), tds.load_npz(path)
    _assert_same_sequence(a, b)
    _assert_same_sequence(seq, b)


def test_dsec_and_mvsec_hdf5_loaders_match(rng, tmp_path):
    import h5py
    n = 500
    paths = []
    for side in ("left", "right"):
        p = str(tmp_path / f"{side}.h5")
        with h5py.File(p, "w") as f:
            g = f.create_group("events")
            g["t"] = np.sort(rng.integers(0, 10 ** 6, n)).astype(np.int64)
            g["x"] = rng.integers(0, 640, n).astype(np.uint16)
            g["y"] = rng.integers(0, 480, n).astype(np.uint16)
            g["p"] = rng.integers(0, 2, n).astype(np.uint8)
            f["t_offset"] = np.int64(5_000_000)
        paths.append(p)
    imu_p = str(tmp_path / "imu.h5")
    with h5py.File(imu_p, "w") as f:
        f["t"] = np.arange(0, 1, 0.005)
        f["acc"] = rng.normal(size=(200, 3))
        f["gyr"] = rng.normal(size=(200, 3))
    a = jds.load_dsec_h5(*paths, imu_path=imu_p)
    b = tds.load_dsec_h5(*paths, imu_path=imu_p)
    assert b.events_left.t[0] >= 5.0
    _assert_same_sequence(a, b)

    data_p, gt_p = str(tmp_path / "mvsec.hdf5"), str(tmp_path / "mvsec_gt.hdf5")
    with h5py.File(data_p, "w") as f:
        for side in ("left", "right"):
            e = np.stack([rng.integers(0, 346, n), rng.integers(0, 260, n),
                          np.sort(rng.uniform(0, 2, n)),
                          rng.choice([-1, 1], n)], 1).astype(np.float64)
            f[f"davis/{side}/events"] = e
            f[f"davis/{side}/image_raw"] = rng.integers(0, 255, (3, 26, 34)).astype(
                np.uint8)
            f[f"davis/{side}/image_raw_ts"] = np.array([0.1, 0.6, 1.1])
        f["davis/left/imu"] = rng.normal(size=(150, 6))
        f["davis/left/imu_ts"] = np.arange(150) * 0.01
    with h5py.File(gt_p, "w") as f:
        T = np.tile(np.eye(4), (20, 1, 1))
        T[:, :3, 3] = rng.normal(size=(20, 3))
        f["davis/left/pose"] = T
        f["davis/left/pose_ts"] = np.arange(20) * 0.1
    a, b = jds.load_mvsec_h5(data_p, gt_p), tds.load_mvsec_h5(data_p, gt_p)
    assert set(np.unique(b.events_left.p)) == {0, 1}
    _assert_same_sequence(a, b)


@pytest.mark.parametrize("compression", [None, "bz2"])
def test_rosbag_reader_matches(rng, tmp_path, compression):
    """tests/test_rosbag.py::test_rosbag_roundtrip's bag (two event packets,
    100 IMU samples, one image), read by both packages' readers."""
    import test_rosbag as tb
    n_ev = 200
    t_ev = np.sort(rng.uniform(10.0, 11.0, n_ev))
    x, y, p = (rng.integers(0, m, n_ev) for m in (346, 260, 2))
    imu_t = np.arange(10.0, 11.0, 0.01)
    acc = rng.normal(0, 1, (len(imu_t), 3))
    gyr = rng.normal(0, 1, (len(imu_t), 3))
    img = rng.integers(0, 255, (12, 16)).astype(np.uint8)
    recs = [tb._connection(0, "/davis_left/events", "dvs_msgs/EventArray"),
            tb._connection(1, "/davis_left/imu", "sensor_msgs/Imu"),
            tb._connection(2, "/davis_left/image_raw", "sensor_msgs/Image")]
    half = n_ev // 2
    recs.append(tb._message(0, t_ev[0], tb._event_array_msg(
        t_ev[0], t_ev[:half], x[:half], y[:half], p[:half])))
    recs.append(tb._message(0, t_ev[half], tb._event_array_msg(
        t_ev[half], t_ev[half:], x[half:], y[half:], p[half:])))
    for k in range(len(imu_t)):
        recs.append(tb._message(1, imu_t[k], tb._imu_msg(imu_t[k], acc[k], gyr[k])))
    recs.append(tb._message(2, 10.5, tb._image_msg(10.5, img)))
    path = str(tmp_path / "test.bag")
    tb.write_bag(path, recs, compression)

    ja, ta = list(jbag.read_messages(path)), list(tbag.read_messages(path))
    assert len(ta) == len(ja) == len(imu_t) + 3
    for u, v in zip(ja, ta):
        assert u == v
    kw = dict(event_left="/davis_left/events", imu="/davis_left/imu",
              image_left="/davis_left/image_raw")
    a, b = jbag.convert_rosbag(path, **kw), tbag.convert_rosbag(path, **kw)
    _assert_same_sequence(a, b)
    np.testing.assert_allclose(b.events_left.t, t_ev, rtol=0, atol=2e-9)
    np.testing.assert_array_equal(b.images_left[1][0], img)


def test_synth_np_bag_writer_round_trips(tmp_path):
    """synth_np.write_rosbag (the jax-free writer that chip_smoke's --convert
    phase uses), bz2 chunks, read by both readers: x, y, p and IMU exact,
    t within 1e-9 s."""
    from synth_np import BAG_TOPICS, planar_vio_sequence_rot, write_rosbag
    seq, _, _ = planar_vio_sequence_rot(np.random.default_rng(0), duration=0.2)
    path = write_rosbag(str(tmp_path / "seq.bag"), seq, 120, 160, msg_dt=0.02)
    a = jbag.convert_rosbag(path, **BAG_TOPICS)
    b = tbag.convert_rosbag(path, **BAG_TOPICS)
    _assert_same_sequence(a, b)
    for side in ("events_left", "events_right"):
        src, got = getattr(seq, side), getattr(b, side)
        for f in ("x", "y", "p"):
            np.testing.assert_array_equal(getattr(got, f), getattr(src, f))
        np.testing.assert_allclose(got.t, src.t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.imu.t, seq.imu.t, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(b.imu.acc, seq.imu.acc)


def test_rosbag_lz4_chunk_raises_without_lz4(tmp_path, monkeypatch):
    import struct
    import sys
    import test_rosbag as tb
    monkeypatch.setitem(sys.modules, "lz4", None)
    monkeypatch.setitem(sys.modules, "lz4.frame", None)
    path = str(tmp_path / "lz4.bag")
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(tb._record({"op": b"\x05", "compression": b"lz4",
                            "size": struct.pack("<I", 0)}, b""))
    for reader in (jbag, tbag):
        with pytest.raises(RuntimeError, match="lz4"):
            list(reader.read_messages(path))


@pytest.mark.parametrize("alignment", ["none", "yaw", "se3", "sim3"])
def test_ate_rmse_matches(rng, alignment):
    t = np.linspace(0, 5, 200)
    gt = np.stack([np.sin(t), np.cos(0.7 * t), 0.1 * t], 1)
    ang = 0.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0.1],
                  [np.sin(ang), np.cos(ang), -0.05], [-0.1, 0.05, 1.0]])
    R = np.linalg.qr(R)[0]
    est = 1.3 * gt @ R.T + [0.5, -0.2, 0.3] + rng.normal(0, 0.02, gt.shape)
    est_t = t[::3] + 0.001
    a = jtraj.ate_rmse(est_t, est[::3], t, gt, alignment=alignment)
    b = ttraj.ate_rmse(est_t, est[::3], t, gt, alignment=alignment)
    assert np.isfinite(b)
    assert abs(a - b) <= 1e-12
    if alignment == "se3":
        assert ttraj.ate_rmse(est_t, est[::3], t, gt) == b   # the default
