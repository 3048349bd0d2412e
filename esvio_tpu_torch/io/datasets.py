"""Sequence containers, file loaders, event chunking and IMU slicing (port
of esvio_tpu/io/datasets.py, in numpy + torch).

The pipeline consumes packed, time-sorted arrays:

  events: t (float64 s), x, y, p   — per camera
  imu:    t, acc (N, 3), gyr (N, 3)
  images: t, frames (N, H, W) uint8 (optional)

`load_npz` / `save_npz` use the JAX package's keys, so either package
reads the other's files; `load_dsec_h5` and `load_mvsec_h5` read the
public datasets' HDF5 layouts (h5py, imported where it is used); the
rosbag converter is io/rosbag.py.

`iterate_chunks` follows the production packetizer
(native/packetizer.cc): frame k holds the events in (edge[k-1], edge[k]]
with edges accumulated from t0 by 1/freq, newest `capacity` kept; empty
frames yield no chunk.  `iterate_chunks_fast` runs the packetizer itself
(io/native.py), as `Pipeline.run` does; the numpy one is its plain
version.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from esvio_tpu_torch.events.sae import EventChunk


@dataclasses.dataclass
class EventStream:
    t: np.ndarray
    x: np.ndarray
    y: np.ndarray
    p: np.ndarray

    def __len__(self):
        return len(self.t)


@dataclasses.dataclass
class ImuStream:
    t: np.ndarray
    acc: np.ndarray
    gyr: np.ndarray


@dataclasses.dataclass
class SequenceData:
    events_left: EventStream
    events_right: EventStream
    imu: ImuStream
    images_left: Optional[Tuple[np.ndarray, np.ndarray]] = None
    images_right: Optional[Tuple[np.ndarray, np.ndarray]] = None
    ground_truth: Optional[Tuple[np.ndarray, np.ndarray]] = None


def load_npz(path) -> SequenceData:
    """The packed npz format that `save_npz` and the converters write."""
    z = np.load(path, allow_pickle=False)

    def ev(prefix):
        return EventStream(z[f"{prefix}_t"], z[f"{prefix}_x"],
                           z[f"{prefix}_y"], z[f"{prefix}_p"])

    imu = ImuStream(z["imu_t"], z["imu_acc"], z["imu_gyr"])
    gt = (z["gt_t"], z["gt_p"]) if "gt_t" in z else None
    imgs_l = (z["img_left_t"], z["img_left"]) if "img_left_t" in z else None
    imgs_r = (z["img_right_t"], z["img_right"]) if "img_right_t" in z else None
    return SequenceData(ev("ev_left"), ev("ev_right"), imu, imgs_l, imgs_r, gt)


def save_npz(seq: SequenceData, path):
    """Write SequenceData in the packed npz format `load_npz` reads."""
    arrs = {}
    for prefix, ev in (("ev_left", seq.events_left),
                       ("ev_right", seq.events_right)):
        arrs[f"{prefix}_t"] = ev.t
        arrs[f"{prefix}_x"] = ev.x
        arrs[f"{prefix}_y"] = ev.y
        arrs[f"{prefix}_p"] = ev.p
    if seq.imu is not None:
        arrs["imu_t"] = seq.imu.t
        arrs["imu_acc"] = seq.imu.acc
        arrs["imu_gyr"] = seq.imu.gyr
    if seq.images_left is not None:
        arrs["img_left_t"], arrs["img_left"] = seq.images_left
    if seq.images_right is not None:
        arrs["img_right_t"], arrs["img_right"] = seq.images_right
    if seq.ground_truth is not None:
        arrs["gt_t"], arrs["gt_p"] = seq.ground_truth
    np.savez_compressed(path, **arrs)


def load_dsec_h5(events_left_path, events_right_path, imu_path=None):
    """DSEC-format HDF5 event files (events/{t, x, y, p}, t in µs, an
    optional t_offset in µs)."""
    import h5py

    def ev(path):
        with h5py.File(path, "r") as f:
            g = f["events"]
            t = np.asarray(g["t"], np.float64) * 1e-6
            if "t_offset" in f:
                t = t + float(np.asarray(f["t_offset"])) * 1e-6
            return EventStream(t, np.asarray(g["x"], np.int32),
                               np.asarray(g["y"], np.int32),
                               np.asarray(g["p"], np.int32))

    left = ev(events_left_path)
    right = ev(events_right_path)
    imu = None
    if imu_path:
        with h5py.File(imu_path, "r") as f:
            imu = ImuStream(np.asarray(f["t"], np.float64),
                            np.asarray(f["acc"]), np.asarray(f["gyr"]))
    return SequenceData(left, right, imu)


def load_mvsec_h5(data_path, gt_path=None) -> SequenceData:
    """MVSEC-format HDF5: davis/{left,right}/events (N, 4: x, y, t,
    p ∈ {-1, 1}), davis/left/imu (M, 6: ax ay az wx wy wz) + imu_ts,
    image_raw (+ _ts); ground truth from the companion _gt.hdf5
    (davis/left/pose (K, 4, 4) + pose_ts)."""
    import h5py

    with h5py.File(data_path, "r") as f:
        def ev(side):
            e = np.asarray(f[f"davis/{side}/events"])
            return EventStream(e[:, 2].astype(np.float64),
                               e[:, 0].astype(np.int32),
                               e[:, 1].astype(np.int32),
                               (e[:, 3] > 0).astype(np.int32))
        left = ev("left")
        right = ev("right") if "davis/right/events" in f else left
        imu = None
        if "davis/left/imu" in f:
            m = np.asarray(f["davis/left/imu"])
            ts = np.asarray(f["davis/left/imu_ts"])
            imu = ImuStream(ts.astype(np.float64), m[:, 0:3], m[:, 3:6])
        imgs_l = imgs_r = None
        if "davis/left/image_raw" in f:
            imgs_l = (np.asarray(f["davis/left/image_raw_ts"], np.float64),
                      np.asarray(f["davis/left/image_raw"]))
        if "davis/right/image_raw" in f:
            imgs_r = (np.asarray(f["davis/right/image_raw_ts"], np.float64),
                      np.asarray(f["davis/right/image_raw"]))
    gt = None
    if gt_path:
        with h5py.File(gt_path, "r") as f:
            T = np.asarray(f["davis/left/pose"])
            gt = (np.asarray(f["davis/left/pose_ts"], np.float64), T[:, :3, 3])
    return SequenceData(left, right, imu, imgs_l, imgs_r, gt)


def iterate_chunks(stream: EventStream, freq: float, capacity: int, device,
                   t_start=None, t_end=None) -> Iterator[Tuple[float, EventChunk]]:
    """Yield (t_frame, EventChunk on `device`) at the publish rate."""
    t = np.ascontiguousarray(stream.t, np.float64)
    if len(t) == 0 or freq <= 0:
        return
    t0 = float(t[0] if t_start is None else t_start)
    t1 = float(t[-1] if t_end is None else t_end)
    dt = 1.0 / freq
    n_frames = max(len(np.arange(t0, t1 + dt, dt)) - 1, 0)
    lo = int(np.searchsorted(t, t0, side="right"))
    edge = t0
    for _ in range(n_frames):
        edge += dt
        hi = int(lo + np.searchsorted(t[lo:], edge, side="right"))
        if hi == lo and hi >= len(t):
            break
        start = max(lo, hi - capacity)
        m = hi - start
        if m:
            T = np.zeros(capacity, np.float32)
            X = np.zeros(capacity, np.int32)
            Y = np.zeros(capacity, np.int32)
            P = np.zeros(capacity, np.int32)
            V = np.zeros(capacity, bool)
            T[:m] = t[start:hi].astype(np.float32)
            X[:m] = stream.x[start:hi]
            Y[:m] = stream.y[start:hi]
            P[:m] = stream.p[start:hi]
            V[:m] = True
            to = lambda a: torch.from_numpy(a).to(device)
            yield edge, EventChunk(t=to(T), x=to(X), y=to(Y), p=to(P),
                                   valid=to(V), n_host=m, n_offered=hi - lo)
        lo = hi
        if lo >= len(t):
            break


# events the native packetizer packs per call (iterate_chunks_fast): host
# memory stays at a few blocks of this size, whatever the stream's length
NATIVE_BLOCK_EVENTS = 1 << 20


def iterate_chunks_fast(stream: EventStream, freq: float, capacity: int,
                        device, t_start=None, t_end=None
                        ) -> Iterator[Tuple[float, EventChunk]]:
    """`iterate_chunks` through the native packetizer (io/native.py): each
    call packs a block of ticks (NATIVE_BLOCK_EVENTS // capacity of them,
    at least one) into padded arrays on the host, then each tick's chunk is
    copied to `device`.  A block starts at the last one's final edge, which
    the packetizer accumulates as `iterate_chunks` does, so the blocks
    yield the same (stamp, EventChunk) sequence as one call.  The events
    offered in a tick (`n_offered`) are counted on its edges by two
    binary searches."""
    from esvio_tpu_torch.io import native
    t = np.ascontiguousarray(stream.t, np.float64)
    if len(t) == 0 or freq <= 0:
        return
    x, y, p = (np.ascontiguousarray(a, np.int32)
               for a in (stream.x, stream.y, stream.p))
    t0 = float(t[0] if t_start is None else t_start)
    t1 = float(t[-1] if t_end is None else t_end)
    dt = 1.0 / freq
    n_frames = max(len(np.arange(t0, t1 + dt, dt)) - 1, 0)
    block = max(1, NATIVE_BLOCK_EVENTS // capacity)
    while n_frames > 0:
        stamps, ts, xs, ys, ps, vs = native.packetize(
            t, x, y, p, t0, freq, capacity, min(block, n_frames))
        lo = int(np.searchsorted(t, t0, side="right"))
        for k in range(len(stamps)):
            hi = int(np.searchsorted(t, stamps[k], side="right"))
            n_offered, lo = hi - lo, hi
            m = int(vs[k].sum())
            if m == 0:
                continue   # an empty tick is no chunk (see iterate_chunks)
            to = lambda a: torch.tensor(a[k], device=device)
            yield float(stamps[k]), EventChunk(t=to(ts), x=to(xs), y=to(ys),
                                               p=to(ps), valid=to(vs), n_host=m,
                                               n_offered=n_offered)
        if len(stamps) < min(block, n_frames):
            return                       # the stream ended inside the block
        n_frames -= len(stamps)
        t0 = float(stamps[-1])


def imu_between(imu: ImuStream, t0: float, t1: float):
    """IMU samples spanning (t0, t1] with boundary interpolation at t1
    (getMeasurements_event_image_imu, stereo_estimator_node.cpp:115-170,
    interpolation :324-348)."""
    i0 = np.searchsorted(imu.t, t0, side="right")
    i1 = np.searchsorted(imu.t, t1, side="right")
    ts = list(imu.t[i0:i1])
    accs = list(imu.acc[i0:i1])
    gyrs = list(imu.gyr[i0:i1])
    if i1 < len(imu.t) and i1 > 0 and imu.t[i1] > t1 > imu.t[i1 - 1]:
        w = (t1 - imu.t[i1 - 1]) / (imu.t[i1] - imu.t[i1 - 1])
        ts.append(t1)
        accs.append((1 - w) * imu.acc[i1 - 1] + w * imu.acc[i1])
        gyrs.append((1 - w) * imu.gyr[i1 - 1] + w * imu.gyr[i1])
    if not ts:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3))
    return np.asarray(ts), np.asarray(accs), np.asarray(gyrs)
