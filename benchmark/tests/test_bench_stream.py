"""The period-shifted stream: one rendered period handed over and over,
stamps strictly increasing, IMU and frames continuous across the seam."""
import copy
import math

import numpy as np
import pytest
import torch

from conftest import TINY
from harness import cell, reference, scene, stream

C = cell.load("tiny.esio", TINY, TINY)


@pytest.fixture(scope="module")
def period():
    tr = copy.deepcopy(C.traffic)
    tr["imu"]["acc_noise"] = tr["imu"]["gyr_noise"] = 0.0
    sc = dict(C.scene, frame_hz=15, img_fx=100.0, img_fy=100.0, img_cx=40.0,
              img_cy=30.0, img_width=80, img_height=60)
    return scene.render_period(sc, tr, 4294967311, "cpu"), tr


def test_the_period_closes(period):
    p, tr = period
    truth = reference.Truth(tr, p.tau)
    t = np.linspace(0.0, p.period_s, 37)
    R0, p0 = truth.pose(t)
    R1, p1 = truth.pose(t + p.period_s)
    assert np.abs(R0 - R1).max() < 1e-12 and np.abs(p0 - p1).max() < 1e-12
    with pytest.raises(ValueError):
        bad = copy.deepcopy(tr)
        bad["circuit"]["wobble_hz"] = [0.9, 1.5]
        scene.circuit_from(bad)


def test_generator_and_reference_agree_on_the_trajectory(period):
    p, tr = period
    cc = scene.circuit_from(tr)
    t = np.linspace(0.0, 2 * p.period_s, 101)
    R, pos, _ = scene.pose(cc, torch.tensor(t, dtype=torch.float64), p.tau)
    Rr, pr = reference.Truth(tr, p.tau).pose(t)
    assert np.abs(R.numpy() - Rr).max() < 1e-12
    assert np.abs(pos.numpy() - pr).max() < 1e-12


def test_events_lie_in_the_period_sorted(period):
    p, _ = period
    for t, x, y, pol in p.events:
        assert len(t) > 1000 and np.all(np.diff(t) >= 0)
        assert t[0] > 0.0 and t[-1] <= p.period_s
        assert x.min() >= 0 and x.max() < C.scene["width"]
        assert y.min() >= 0 and y.max() < C.scene["height"]
        assert set(np.unique(pol)) <= {0, 1}


def test_chunk_stamps_increase_across_seams(period):
    p, _ = period
    ps = stream.PeriodicStream(p, 15, C.deployment["event_capacity"], "cpu")
    n = 2 * ps.ticks_per_period + 5
    stamps = [pair[0][0] for pair, _ in zip(ps.pairs(), range(n))]
    assert len(stamps) == n
    d = np.diff(stamps)
    assert np.all(d > 0) and np.allclose(d, 1.0 / 15, atol=1e-9)


def test_imu_is_continuous_across_the_seam(period):
    p, _ = period
    ps = stream.PeriodicStream(p, 15, C.deployment["event_capacity"], "cpu")
    imu = ps.imu_around(3)
    dt = np.diff(imu.t)
    assert np.allclose(dt, 1.0 / 200, atol=1e-9)
    n = len(p.imu[0])
    for a in (imu.acc, imu.gyr):
        steps = np.abs(np.diff(a, axis=0)).max(1)
        inside = np.delete(steps, [n - 1, 2 * n - 1]).max()
        assert steps[n - 1] <= 1.5 * inside and steps[2 * n - 1] <= 1.5 * inside


def test_frames_are_indexed_onto_the_period(period):
    p, _ = period
    ps = stream.PeriodicStream(p, 15, C.deployment["event_capacity"], "cpu")
    stamps, frames = ps.seq.images_left
    N = len(p.frame_t)
    assert N == round(p.period_s * 15)
    for m in (0, 1, N - 1, N, N + 1, 5 * N + 3):
        assert frames[m].__array_interface__["data"] == \
            p.frames[0][m % N].__array_interface__["data"]
        assert math.isclose(stamps[m], (m + 0.5) / 15, abs_tol=1e-9)
    assert all(stamps[m + 1] > stamps[m] for m in range(3 * N))


def test_window_opens_when_warm_and_closes_after_its_seconds():
    clock = iter(np.arange(0.0, 1000.0, 0.25)).__next__
    warm = iter([False] * 3 + [True] * 100).__next__
    w = stream.Window(iter([((float(k), None), (float(k), None))
                            for k in range(200)]),
                      seconds=5.0, warm=warm, max_warm_ticks=10, clock=clock)
    got = list(w)
    assert w.warm_ticks == 3 and len(got) == 3 + len(w.handover)
    assert w.closed - w.opened >= 5.0
    ticks = w.tick_seconds()
    assert len(ticks) == len(w.handover) and math.isclose(sum(ticks), w.closed - w.opened)
    with pytest.raises(stream.WarmupError):
        list(stream.Window(iter([((0.0, None), (0.0, None))] * 50), 1.0,
                           lambda: False, 5, clock=clock))
