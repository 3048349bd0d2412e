"""The period-shifted sensor stream and the window that measures it.

`PeriodicStream` hands one rendered period (harness/scene.py) over and over
with its stamps shifted by whole periods.  Events go through the port's own
chunker (`io/datasets.iterate_chunks_fast`, one call per period) and are
paired as `Pipeline.run` pairs them (`apps/pipeline._sync_pairs`).  The
IMU the pipeline reads is swapped, at each period's first tick, for the
three periods around it; frames and their stamps are indexable objects that
map a global frame index onto the period.  Host memory stays at one period.

`Window` is the iterator handed to `Pipeline.run` as `chunk_pairs`: during
warm-up it hands ticks over until the cell's warm-up test passes, then it
opens the window, stamps the moment the pipeline takes each tick, times
each pull from the chunker, and stops when `seconds` have passed (or, for
readings of correctness only, after `max_ticks` window ticks).
"""
from __future__ import annotations

import time

import numpy as np


class PeriodicStamps:
    """Frame stamps (m + 0.5) / frame_hz of an endless stream."""

    def __init__(self, frame_t: np.ndarray, period_s: float):
        self.frame_t = frame_t
        self.period_s = period_s

    def __len__(self):
        return 1 << 40

    def __getitem__(self, m):
        j, k = divmod(int(m), len(self.frame_t))
        return float(self.frame_t[k] + j * self.period_s)


class PeriodicFrames:
    """Frame m of an endless stream: frame m mod N of the period."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames

    def __len__(self):
        return 1 << 40

    def __getitem__(self, m):
        return self.frames[int(m) % len(self.frames)]


class PeriodicStream:
    def __init__(self, period, freq: float, capacity: int, device):
        from esvio_tpu_torch.io import datasets as ds
        self.ds = ds
        self.p = period
        self.freq = float(freq)
        self.capacity = int(capacity)
        self.device = device
        ticks = period.period_s * self.freq
        if abs(ticks - round(ticks)) > 1e-6:
            raise ValueError(f"a period of {period.period_s} s is not a whole "
                             f"number of ticks at {freq} Hz")
        self.ticks_per_period = int(round(ticks))
        # two stamp buffers per camera, used in turn: a period's stamps are
        # written into one while the chunker may still hold the other
        self._t_buf = [[np.empty_like(e[0]) for _ in range(2)]
                       for e in period.events]
        imgs_l = imgs_r = None
        if period.frames:
            stamps = PeriodicStamps(period.frame_t, period.period_s)
            imgs_l = (stamps, PeriodicFrames(period.frames[0]))
            imgs_r = (stamps, PeriodicFrames(period.frames[1]))
        empty = ds.EventStream(np.zeros(0), *(np.zeros(0, np.int32),) * 3)
        self.seq = ds.SequenceData(empty, empty, self.imu_around(0), imgs_l, imgs_r)

    def imu_around(self, j: int):
        """The IMU of periods j-1, j and j+1, shifted to their stamps."""
        t, acc, gyr = self.p.imu
        T = self.p.period_s
        return self.ds.ImuStream(
            np.concatenate([t + (j + d) * T for d in (-1, 0, 1)]),
            np.concatenate([acc] * 3), np.concatenate([gyr] * 3))

    def chunks(self, j: int, cam: int):
        t, x, y, p = self.p.events[cam]
        T = self.p.period_s
        tj = np.add(t, j * T, out=self._t_buf[cam][j % 2])
        # t_end half a tick before the period's end: the chunker's frame
        # count is then exactly ticks_per_period, whatever the rounding
        return self.ds.iterate_chunks_fast(
            self.ds.EventStream(tj, x, y, p), self.freq, self.capacity,
            self.device, t_start=j * T, t_end=(j + 1) * T - 0.5 / self.freq)

    def pairs(self):
        """((t_l, chunk_l), (t_r, chunk_r)) for ever."""
        from esvio_tpu_torch.apps.pipeline import _sync_pairs
        j = 0
        while True:
            self.seq.imu = self.imu_around(j)
            yield from _sync_pairs(self.chunks(j, 0), self.chunks(j, 1),
                                   0.5 / self.freq)
            j += 1


class WarmupError(RuntimeError):
    pass


class Window:
    """The chunk_pairs iterator that warms up, then measures.

    warm(): True once the pipeline is warm (checked each time the pipeline
    asks for a tick during warm-up).  on_tick(i): called before window tick
    i is handed over (the traced run starts and stops its profiler there).
    """

    def __init__(self, pairs, seconds: float, warm, max_warm_ticks: int,
                 on_tick=None, clock=time.perf_counter, max_ticks=None):
        self.pairs = pairs
        self.seconds = float(seconds)
        self.warm = warm
        self.max_warm_ticks = int(max_warm_ticks)
        self.on_tick = on_tick
        self.clock = clock
        self.max_ticks = max_ticks
        self.warm_ticks = 0
        self.opened = None       # clock at the window's first hand-over
        self.closed = None       # clock at the hand-over that ended it
        self.handover = []       # clock at each window tick's hand-over
        self.ingest_s = []       # seconds of each window tick's pull
        self.first_stamp = None  # sensor stamp of the first window tick

    def __iter__(self):
        it = iter(self.pairs)
        while True:
            t_a = self.clock()
            pair = next(it)
            t_b = self.clock()
            if self.opened is None:
                if not self.warm():
                    self.warm_ticks += 1
                    if self.warm_ticks > self.max_warm_ticks:
                        raise WarmupError(
                            f"not warm after {self.max_warm_ticks} ticks")
                    yield pair
                    continue
                self.opened = t_b
                self.first_stamp = pair[0][0]
            elif t_b - self.opened >= self.seconds or \
                    len(self.handover) == self.max_ticks:
                self.closed = t_b
                return
            if self.on_tick is not None:
                self.on_tick(len(self.handover))
            self.handover.append(t_b)
            self.ingest_s.append(t_b - t_a)
            yield pair

    def tick_seconds(self):
        """The wall time of each window tick: from its hand-over to the
        next one (the last one's to the close)."""
        marks = self.handover + [self.closed]
        return [b - a for a, b in zip(marks[:-1], marks[1:])]
