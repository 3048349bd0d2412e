"""Parity: esvio_tpu_torch.imu.preintegration against
esvio_tpu.imu.preintegration, float32 on both sides.

Tolerances: Δp/Δv/Δq and the residual within 1e-5 relative to their scale
(float32 mid-point steps whose matrix products round in another order);
Jacobian and covariance within 1e-4 relative to their largest entry (they
are products of ~100 transition matrices).  sum_dt and the linearization
biases exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import np_f32, rel_err, to_torch
from esvio_tpu.imu import preintegration as jpre
from esvio_tpu_torch.imu import preintegration as tpre

FIELDS = ("delta_p", "delta_q", "delta_v", "jacobian", "covariance")


def _interval(rng, n=80, n_real=None):
    dts = np_f32(np.full(n, 0.005) + rng.uniform(-5e-4, 5e-4, n))
    acc = np_f32(rng.normal(0, 1.5, (n, 3)) + [0, 0, 9.8])
    gyr = np_f32(rng.normal(0, 0.4, (n, 3)))
    mask = np.arange(n) < (n if n_real is None else n_real)
    return dts, acc, gyr, mask


def _assert_preint_close(j, t):
    for f in FIELDS:
        tol = 1e-4 if f in ("jacobian", "covariance") else 1e-5
        assert rel_err(getattr(t, f).numpy(), getattr(j, f)) < tol, f
    np.testing.assert_allclose(t.sum_dt.numpy(), np.asarray(j.sum_dt),
                               rtol=1e-6)


def test_midpoint_step_matches(rng):
    K = 6
    v = lambda *s: np_f32(rng.normal(size=s))
    dt = np_f32(rng.uniform(0.002, 0.01, K))
    a0, g0, a1, g1, dp, dv, ba, bg = (v(K, 3) for _ in range(8))
    q = v(K, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    jac = np_f32(np.eye(15) + 0.01 * rng.normal(size=(K, 15, 15)))
    cov = np_f32(0.01 * np.eye(15) + np.zeros((K, 15, 15)))
    jnoise = jpre._noise_cov(jpre.make_imu_params(dtype=jnp.float32), jnp.float32)
    tnoise = tpre._noise_cov(tpre.make_imu_params(), torch.float32)
    for k in range(K):
        args = (dt[k], a0[k], g0[k], a1[k], g1[k], dp[k], q[k], dv[k], ba[k],
                bg[k], jac[k], cov[k])
        jo = jpre.midpoint_step(*(jnp.asarray(a) for a in args), jnoise)
        to = tpre.midpoint_step(*(torch.tensor(a) for a in args), tnoise)
        for a, b in zip(jo, to):
            assert rel_err(b.numpy(), a) < 1e-5


def test_preintegrate_and_batch_match(rng):
    jp, tp = jpre.make_imu_params(dtype=jnp.float32), tpre.make_imu_params()
    ivs = [_interval(rng, n_real=n_real) for n_real in (80, 55, 0, 30)]
    ba = np_f32(rng.normal(0, 0.05, (4, 3)))
    bg = np_f32(rng.normal(0, 0.01, (4, 3)))
    dts, acc, gyr, mask = (np.stack(x) for x in zip(*ivs))
    acc0, gyr0 = acc[:, 0], gyr[:, 0]
    jb = jpre.preintegrate_batch(*(jnp.asarray(a) for a in
                                   (dts, acc, gyr, acc0, gyr0, ba, bg)),
                                 jp, jnp.asarray(mask))
    tb = tpre.preintegrate_batch(*(torch.tensor(a) for a in
                                   (dts, acc, gyr, acc0, gyr0, ba, bg)),
                                 tp, torch.tensor(mask))
    _assert_preint_close(jb, tb)
    assert float(tb.sum_dt[2]) == 0.0           # an empty interval stays empty
    for k in (0, 1):
        args = (dts[k], acc[k], gyr[k], acc0[k], gyr0[k], ba[k], bg[k])
        j1 = jpre.preintegrate(*(jnp.asarray(a) for a in args), jp,
                               jnp.asarray(mask[k]))
        t1 = tpre.preintegrate(*(torch.tensor(a) for a in args), tp,
                               torch.tensor(mask[k]))
        _assert_preint_close(j1, t1)


def test_evaluate_matches(rng):
    jp, tp = jpre.make_imu_params(dtype=jnp.float32), tpre.make_imu_params()
    dts, acc, gyr, mask = _interval(rng, n=60)
    z = np.zeros(3, np.float32)
    args = (dts, acc, gyr, acc[0], gyr[0], z, z)
    j = jpre.preintegrate(*(jnp.asarray(a) for a in args), jp)
    t = to_torch(j, tpre.Preintegrated)
    q = lambda: (lambda v: np_f32(v / np.linalg.norm(v)))(rng.normal(size=4))
    st = [np_f32(rng.normal(size=3)), q(), np_f32(rng.normal(size=3)),
          np_f32(rng.normal(0, 0.05, 3)), np_f32(rng.normal(0, 0.01, 3)),
          np_f32(rng.normal(size=3)), q(), np_f32(rng.normal(size=3)),
          np_f32(rng.normal(0, 0.05, 3)), np_f32(rng.normal(0, 0.01, 3))]
    g = np_f32([0, 0, 9.80766])
    rj = np.asarray(jpre.evaluate(j, jnp.asarray(g), *(jnp.asarray(a) for a in st)))
    rt = tpre.evaluate(t, torch.tensor(g), *(torch.tensor(a) for a in st)).numpy()
    assert rel_err(rt, rj) < 1e-5


def test_preintegrate_batch_with_host_step_count(rng):
    """n_steps from the host (the longest interval's count, or any larger
    one) gives the all-steps result exactly: steps past the last real
    sample are no-ops."""
    tp = tpre.make_imu_params()
    ivs = [_interval(rng, n_real=n_real) for n_real in (20, 7, 0, 13)]
    dts, acc, gyr, mask = (torch.tensor(np.stack(x)) for x in zip(*ivs))
    ba = torch.tensor(np_f32(rng.normal(0, 0.05, (4, 3))))
    bg = torch.tensor(np_f32(rng.normal(0, 0.01, (4, 3))))
    args = (dts, acc, gyr, acc[:, 0], gyr[:, 0], ba, bg, tp, mask)
    want = tpre.preintegrate_batch(*args)
    for n in (20, 32, 80):
        got = tpre.preintegrate_batch(*args, n_steps=n)
        for f in FIELDS + ("sum_dt",):
            assert torch.equal(getattr(got, f), getattr(want, f)), (n, f)


@pytest.mark.parametrize("chunk", [16, 7])
def test_chunked_integration_matches_the_batch(rng, chunk):
    """integrate_steps a chunk at a time from a Carry (the tick graphs'
    head and more) gives preintegrate_batch's result exactly, also where
    the last chunk runs past the 80-sample buffers (chunk 7: 12 chunks)."""
    tp = tpre.make_imu_params()
    ivs = [_interval(rng, n_real=n_real) for n_real in (20, 7, 0, 80)]
    dts, acc, gyr, mask = (torch.tensor(np.stack(x)) for x in zip(*ivs))
    ba = torch.tensor(np_f32(rng.normal(0, 0.05, (4, 3))))
    bg = torch.tensor(np_f32(rng.normal(0, 0.01, (4, 3))))
    want = tpre.preintegrate_batch(dts, acc, gyr, acc[:, 0], gyr[:, 0], ba,
                                   bg, tp, mask)
    c = tpre.integrate_begin(acc[:, 0], gyr[:, 0], torch.float32)
    for _ in range(-(-80 // chunk)):
        c = tpre.integrate_steps(c, dts, acc, gyr, mask, ba, bg, tp, chunk)
    assert int(c.step) == -(-80 // chunk) * chunk
    got = tpre.integrate_end(c, ba, bg)
    for f in FIELDS + ("sum_dt", "linearized_ba", "linearized_bg"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
