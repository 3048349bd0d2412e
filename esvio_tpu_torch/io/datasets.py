"""Sequence containers, event chunking and IMU slicing (port of the
pipeline's part of esvio_tpu/io/datasets.py, in numpy + torch).

`iterate_chunks` follows the JAX pipeline's production packetizer
(esvio_tpu/native/packetizer.cc): frame k holds the events in
(edge[k-1], edge[k]] with edges accumulated from t0 by 1/freq, newest
`capacity` kept; empty frames yield no chunk.  The file loaders (npz, HDF5,
rosbag) are not ported yet.
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
                                   valid=to(V), n_host=m)
        lo = hi
        if lo >= len(t):
            break


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
