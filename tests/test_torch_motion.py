"""Parity: the port's IMU-aided motion correction
(esvio_tpu_torch/events/motion.py) against esvio_tpu/events/motion.py on
the CPU, float32 on both sides.

Tolerances: identity (exact) when ‖accel‖ ≤ 5 m/s²; when enabled, the
warped pixels exact up to events whose floor(x/z) flips by one pixel
because the two sides round the 3×3 products of K·Rᵀ·K⁻¹ in another
order.  Those are counted and bounded at 0.1 % of the events, each flip
at most one pixel.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from esvio_tpu.events import motion as jmotion
from esvio_tpu.events import sae as jsae
from esvio_tpu_torch.events import motion as tmotion
from esvio_tpu_torch.events import sae as tsae

F32 = np.float32


def _both(t, x, y, p, cap, fx, fy, cx, cy, omega, v_cur, v_prev, accel, t0,
          width, height):
    jc = jsae.chunk_from_arrays(t, x, y, p, capacity=cap)
    jout = jmotion.motion_correct_chunk(
        jc, fx, fy, cx, cy, *(jnp.asarray(F32(a)) for a in
                              (omega, v_cur, v_prev, accel)),
        t0, width=width, height=height)
    tc = tsae.chunk_from_arrays(t, x, y, p, capacity=cap)
    tout = tmotion.motion_correct_chunk(
        tc, fx, fy, cx, cy, *(torch.from_numpy(F32(a)) for a in
                              (omega, v_cur, v_prev, accel)),
        t0, width=width, height=height)
    assert tout.x.dtype == torch.int32
    return (np.asarray(jout.x), np.asarray(jout.y), tout.x.numpy(),
            tout.y.numpy(), np.asarray(jc.x), np.asarray(jc.y))


def test_identity_below_threshold():
    rng = np.random.default_rng(0)
    jx, jy, tx, ty, x0, y0 = _both(
        np.linspace(1.0, 1.05, 100), rng.integers(10, 150, 100),
        rng.integers(10, 100, 100), rng.integers(0, 2, 100), 128,
        200.0, 200.0, 80.0, 60.0, [0.0, 0.0, 1.0], [0.1, 0, 0], [0.1, 0, 0],
        [0.0, 0.0, 1.0], 1.0, 160, 120)
    for a in (jx, tx):
        np.testing.assert_array_equal(a, x0)
    for a in (jy, ty):
        np.testing.assert_array_equal(a, y0)


@pytest.mark.parametrize("H,W,n,f", [(120, 160, 20000, 200.0),
                                     (480, 640, 131072, 570.0)])
def test_warp_matches_up_to_counted_floor_flips(H, W, n, f):
    """The golden geometry, and DSEC (480x640, 131,072 events a tick)."""
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(1.0, 1.0 + 1 / 15, n))
    x = rng.integers(0, W, n)
    y = rng.integers(0, H, n)
    jx, jy, tx, ty, x0, y0 = _both(
        t, x, y, rng.integers(0, 2, n), n, f, f, W / 2, H / 2,
        [0.3, -0.5, 0.8], [0.4, -0.2, 0.1], [0.35, -0.25, 0.12],
        [0.5, 9.6, 1.2], 1.0, W, H)
    moved = (jx != x0) | (jy != y0)
    flips = (jx != tx) | (jy != ty)
    print(f"{H}x{W}: {int(moved.sum())} of {n} events warped, "
          f"{int(flips.sum())} floor flips")
    assert moved.sum() > 0.5 * n
    assert flips.sum() <= 1e-3 * n, int(flips.sum())
    assert np.abs(jx - tx).max() <= 1 and np.abs(jy - ty).max() <= 1
