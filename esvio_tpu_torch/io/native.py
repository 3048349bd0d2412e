"""ctypes bindings of the native C++ packetizer (port of
esvio_tpu/io/native.py; the port's own source, native/packetizer.cc).

The library is built at first use by the host compiler into
esvio_tpu_torch/build/ (`_kernels.build`, which chip_smoke.py's first phase
runs beside the CUDA kernels).  Unlike the JAX module, a failed build
raises: nothing falls back to numpy in silence.  The numpy
`io/datasets.iterate_chunks` and `imu_between` stay as the plain versions
that the tests hold these against.
"""
from __future__ import annotations

import ctypes

import numpy as np

from esvio_tpu_torch import _kernels

_lib = None


def get_lib() -> ctypes.CDLL:
    """The packetizer library, built first if needed (raises if the build
    fails)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _kernels.PACKETIZER.fn()
    i64, f64 = ctypes.c_int64, ctypes.c_double
    P = ctypes.POINTER
    lib.esv_packetize.restype = i64
    lib.esv_packetize.argtypes = [
        P(ctypes.c_double), P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_int32), i64, f64, f64, i64, i64,
        P(ctypes.c_float), P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_int32), P(ctypes.c_uint8), P(ctypes.c_double)]
    lib.esv_imu_between.restype = i64
    lib.esv_imu_between.argtypes = [
        P(ctypes.c_double), P(ctypes.c_double), P(ctypes.c_double), i64,
        f64, f64, i64, P(ctypes.c_double), P(ctypes.c_double),
        P(ctypes.c_double)]
    _lib = lib
    return lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def packetize(t, x, y, p, t0: float, freq: float, capacity: int,
              n_frames: int):
    """Chunk a time-sorted stream in one call: (stamps (F,), t (F,C) f32,
    x/y/p (F,C) i32, valid (F,C) bool) with F the frames produced.  Frame k
    holds the events in (edge[k-1], edge[k]], edges accumulated from t0 by
    1/freq, the newest `capacity` kept."""
    lib = get_lib()
    t = np.ascontiguousarray(t, np.float64)
    x = np.ascontiguousarray(x, np.int32)
    y = np.ascontiguousarray(y, np.int32)
    p = np.ascontiguousarray(p, np.int32)
    ot = np.zeros((n_frames, capacity), np.float32)
    ox = np.zeros((n_frames, capacity), np.int32)
    oy = np.zeros((n_frames, capacity), np.int32)
    op = np.zeros((n_frames, capacity), np.int32)
    ov = np.zeros((n_frames, capacity), np.uint8)
    ost = np.zeros(n_frames, np.float64)
    nf = int(lib.esv_packetize(
        _ptr(t, ctypes.c_double), _ptr(x, ctypes.c_int32),
        _ptr(y, ctypes.c_int32), _ptr(p, ctypes.c_int32),
        len(t), t0, freq, capacity, n_frames,
        _ptr(ot, ctypes.c_float), _ptr(ox, ctypes.c_int32),
        _ptr(oy, ctypes.c_int32), _ptr(op, ctypes.c_int32),
        _ptr(ov, ctypes.c_uint8), _ptr(ost, ctypes.c_double)))
    return (ost[:nf], ot[:nf], ox[:nf], oy[:nf], op[:nf],
            ov[:nf].astype(bool))


def imu_between_native(imu_t, imu_acc, imu_gyr, t0: float, t1: float,
                       capacity: int = 1024):
    """IMU samples spanning (t0, t1] with boundary interpolation at t1:
    (t (K,), acc (K, 3), gyr (K, 3))."""
    lib = get_lib()
    imu_t = np.ascontiguousarray(imu_t, np.float64)
    imu_acc = np.ascontiguousarray(imu_acc, np.float64)
    imu_gyr = np.ascontiguousarray(imu_gyr, np.float64)
    ot = np.zeros(capacity, np.float64)
    oa = np.zeros((capacity, 3), np.float64)
    og = np.zeros((capacity, 3), np.float64)
    k = int(lib.esv_imu_between(
        _ptr(imu_t, ctypes.c_double), _ptr(imu_acc, ctypes.c_double),
        _ptr(imu_gyr, ctypes.c_double), len(imu_t), t0, t1, capacity,
        _ptr(ot, ctypes.c_double), _ptr(oa, ctypes.c_double),
        _ptr(og, ctypes.c_double)))
    return ot[:k], oa[:k], og[:k]
