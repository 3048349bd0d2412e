"""Port parity of io/native.py (the port's own build of
native/packetizer.cc): packetize and imu_between_native against the JAX
package's native module (tests/test_native.py's streams), and
io/datasets.iterate_chunks_fast against the port's numpy iterate_chunks,
its plain version."""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads)


def _stream(rng, n, t0, t1, W=346, H=260):
    t = np.sort(rng.uniform(t0, t1, n))
    x = rng.integers(0, W, n).astype(np.int32)
    y = rng.integers(0, H, n).astype(np.int32)
    p = rng.integers(0, 2, n).astype(np.int32)
    return t, x, y, p


@pytest.mark.parametrize("capacity, n_frames, freq", [
    (4096, 64, 20.0), (1024, 4, 10.0), (256, 200, 15.0)])
def test_packetize_matches_jax_native(capacity, n_frames, freq):
    """Frames, stamps, times and masks equal to the JAX package's native
    packetizer (a dense stream, so the newest-capacity cut applies)."""
    from esvio_tpu.io import native as jnat
    from esvio_tpu_torch.io import native as tnat
    rng = np.random.default_rng(capacity)
    t, x, y, p = _stream(rng, 50000, 1.0, 3.0)
    ref = jnat.packetize(t, x, y, p, t0=1.0, freq=freq, capacity=capacity,
                         n_frames=n_frames)
    out = tnat.packetize(t, x, y, p, t0=1.0, freq=freq, capacity=capacity,
                         n_frames=n_frames)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_imu_between_matches_jax_native_and_numpy():
    """Equal to the numpy imu_between (the port's build contracts no
    multiply-add), and to the JAX package's build (which may) within
    tests/test_native.py's 1e-12."""
    from esvio_tpu.io import native as jnat
    from esvio_tpu_torch.io import datasets as ds
    from esvio_tpu_torch.io import native as tnat
    rng = np.random.default_rng(0)
    imu_t = np.arange(0, 2.0, 0.005)
    acc = rng.normal(size=(len(imu_t), 3))
    gyr = rng.normal(size=(len(imu_t), 3))
    for t0, t1 in ((0.1012, 0.2034), (0.0, 0.5), (1.9, 2.5)):
        out = tnat.imu_between_native(imu_t, acc, gyr, t0, t1)
        ref = jnat.imu_between_native(imu_t, acc, gyr, t0, t1)
        plain = ds.imu_between(ds.ImuStream(imu_t, acc, gyr), t0, t1)
        for a, b, c in zip(out, ref, plain):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("n, freq, capacity, t_start", [
    (5000, 15.0, 256, None), (50000, 20.0, 4096, 1.5), (300, 30.0, 64, None)])
def test_iterate_chunks_fast_matches_numpy(n, freq, capacity, t_start):
    """The native chunks (stamps, every field, the host count) equal the
    numpy ones, empty ticks skipped alike."""
    from esvio_tpu_torch.io import datasets as ds
    rng = np.random.default_rng(n)
    stream = ds.EventStream(*_stream(rng, n, 1.0, 3.0, 160, 120))
    fast = list(ds.iterate_chunks_fast(stream, freq, capacity, "cpu",
                                       t_start=t_start))
    ref = list(ds.iterate_chunks(stream, freq, capacity, "cpu",
                                 t_start=t_start))
    assert len(fast) == len(ref) > 0
    for (sf, cf), (sr, cr) in zip(fast, ref):
        assert sf == sr and cf.n_host == cr.n_host
        for f in ("t", "x", "y", "p", "valid"):
            a, b = getattr(cf, f), getattr(cr, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("ticks_per_block", [1, 3, 7])
def test_iterate_chunks_fast_in_blocks_matches_numpy(monkeypatch,
                                                     ticks_per_block):
    """Packed a few ticks per packetizer call, the native chunks still equal
    the numpy ones: each block continues the last one's edge, and the
    stream may end inside a block or on its boundary."""
    from esvio_tpu_torch.io import datasets as ds
    capacity = 128
    monkeypatch.setattr(ds, "NATIVE_BLOCK_EVENTS", capacity * ticks_per_block)
    rng = np.random.default_rng(ticks_per_block)
    stream = ds.EventStream(*_stream(rng, 3000, 1.0, 2.0, 160, 120))
    for t_end in (None, 2.7):
        fast = list(ds.iterate_chunks_fast(stream, 21.0, capacity, "cpu",
                                           t_end=t_end))
        ref = list(ds.iterate_chunks(stream, 21.0, capacity, "cpu",
                                     t_end=t_end))
        assert len(fast) == len(ref) == 21
        for (sf, cf), (sr, cr) in zip(fast, ref):
            assert sf == sr and cf.n_host == cr.n_host
            for f in ("t", "x", "y", "p", "valid"):
                assert torch.equal(getattr(cf, f), getattr(cr, f)), f


def test_failed_build_raises(monkeypatch, tmp_path):
    """A packetizer that does not build raises; nothing falls back."""
    from esvio_tpu_torch import _kernels
    lib = _kernels.HostLib("broken", None, "esvio_tpu_torch/native/none.cc",
                           "none")
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    with pytest.raises((RuntimeError, FileNotFoundError)):
        lib.fn()
