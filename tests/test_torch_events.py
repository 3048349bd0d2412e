"""Parity: esvio_tpu_torch.events (SAE update, time surface, Arc* corner
mask = kernel K1's plain version, accept table, detect_corners) against
esvio_tpu.events, float32 inputs on both sides.

Tolerances: SAE tables, accepted masks, corner masks and detections are
exact.  Time surfaces are rounded f32 exponentials: an exp that differs by
one ulp between XLA and torch can move a pixel across a rounding boundary,
so the ±1 flips are counted and bounded, never hidden.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import chunk_pair, np_f32, to_torch
from esvio_tpu.events import corners as jcor
from esvio_tpu.events import corners_pallas
from esvio_tpu.events import sae as jsae
from esvio_tpu_torch.events import corners as tcor
from esvio_tpu_torch.events import sae as tsae

THR = 0.01


def _chunk(rng, H, W, E, t0, dt=0.05, valid_frac=0.9):
    t = np.sort(rng.uniform(t0, t0 + dt, E))
    return (t, rng.integers(0, W, E), rng.integers(0, H, E),
            rng.integers(0, 2, E), rng.random(E) < valid_frac)


def _run_both(rng, H, W, E, n_chunks=3):
    js = jsae.init_sae(H, W)
    ts = tsae.init_sae(H, W, "cpu")
    for k in range(n_chunks):
        jc, tc = chunk_pair(*_chunk(rng, H, W, E, 1.0 + 0.05 * k))
        js, ja = jsae.update_sae(js, jc, THR, return_accepted=True)
        ts, ta = tsae.update_sae(ts, tc, THR, return_accepted=True)
        yield js, ts, jc, tc, ja, ta


@pytest.mark.parametrize("H,W,E", [(64, 80, 3000), (50, 170, 20000)])
def test_update_sae_and_accepted_bit_exact(rng, H, W, E):
    for js, ts, _, _, ja, ta in _run_both(rng, H, W, E):
        assert np.array_equal(np.asarray(js.sae), ts.sae.numpy())
        assert np.array_equal(np.asarray(js.sae_latest), ts.sae_latest.numpy())
        assert np.array_equal(np.asarray(ja), ta.numpy())


def test_update_sae_batched_equals_per_camera(rng):
    """The tracker runs both cameras as one batch of 2."""
    H, W, E = 40, 60, 2000
    s0, s1 = tsae.init_sae(H, W, "cpu"), tsae.init_sae(H, W, "cpu")
    for k in range(2):
        _, c0 = chunk_pair(*_chunk(rng, H, W, E, 1.0 + 0.05 * k))
        _, c1 = chunk_pair(*_chunk(rng, H, W, E, 1.0 + 0.05 * k))
        sb = tsae.SAEState(sae=torch.stack([s0.sae, s1.sae]),
                           sae_latest=torch.stack([s0.sae_latest, s1.sae_latest]))
        cb = tsae.EventChunk(*(torch.stack([getattr(c0, f), getattr(c1, f)])
                               for f in ("t", "x", "y", "p", "valid")))
        sb, ab = tsae.update_sae(sb, cb, THR, return_accepted=True)
        s0, a0 = tsae.update_sae(s0, c0, THR, return_accepted=True)
        s1, a1 = tsae.update_sae(s1, c1, THR, return_accepted=True)
        assert torch.equal(sb.sae, torch.stack([s0.sae, s1.sae]))
        assert torch.equal(sb.sae_latest, torch.stack([s0.sae_latest, s1.sae_latest]))
        assert torch.equal(ab, torch.stack([a0, a1]))


def test_time_surface_flips_counted_and_bounded(rng):
    H, W = 64, 80
    flips = total = 0
    for js, ts, *_ in _run_both(rng, H, W, 3000):
        for t_now in (1.12, 1.2):
            j = np.asarray(jsae.time_surface(js, jnp.asarray(t_now, jnp.float32), 20.0))
            t = tsae.time_surface(ts, torch.tensor(t_now, dtype=torch.float32), 20.0).numpy()
            assert np.abs(j - t).max() <= 1.0
            flips += int((j != t).sum())
            total += j.size
    assert flips <= 1e-3 * total, (flips, total)


def test_harvest_filter_and_median_blur_match(rng):
    H, W = 40, 60
    for js, ts, jc, tc, *_ in _run_both(rng, H, W, 2000, n_chunks=2):
        assert np.array_equal(np.asarray(jsae.harvest_filter(js, jc)),
                              tsae.harvest_filter(ts, tc).numpy())
    img = np_f32(rng.integers(0, 256, (H, W)))
    for k in (1, 2):
        assert np.array_equal(np.asarray(jsae.median_blur(jnp.asarray(img), k)),
                              tsae.median_blur(torch.tensor(img), k).numpy())


def _corner_rich_sae(rng, H, W):
    """The corner-rich SAE of tests/test_corners_pallas.py."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    t1 = 1.0 + 0.002 * xx + 0.001 * yy
    t2 = 1.0 + 0.003 * (W - xx) + 0.0005 * yy
    s0 = np.maximum(t1, t2) + rng.normal(0, 1e-4, (H, W)).astype(np.float32)
    s0[rng.random((H, W)) < 0.05] = 0.0
    s0[rng.random((H, W)) < 0.01] = 2.0
    return np.stack([s0, s0 * 0.7]).astype(np.float32)


@pytest.mark.parametrize("H,W", [(64, 160), (50, 170), (260, 346)])
def test_corner_mask_accept_detect_bit_exact(rng, H, W):
    s = _corner_rich_sae(rng, H, W)
    lat = np_f32(s + rng.normal(0, 1e-3, s.shape))
    jst = jsae.SAEState(sae=jnp.asarray(s), sae_latest=jnp.asarray(lat))
    tst = to_torch(jst, tsae.SAEState)
    jm = np.asarray(jcor.corner_mask(jst, impl="xla"))
    tm = tcor.corner_mask(tst).numpy()
    assert jm.sum() > 100, "test surface has too few corners"
    assert np.array_equal(jm, tm)
    assert np.array_equal(np.asarray(jcor.accept_table(jst, impl="xla")),
                          tcor.accept_table(tst).numpy())
    E = 8192
    jc, tc = chunk_pair(np.sort(rng.uniform(1, 1.05, E)), rng.integers(0, W, E),
                        rng.integers(0, H, E), rng.integers(0, 2, E),
                        rng.random(E) < 0.95)
    jd = np.asarray(jcor.detect_corners(jst, jc, 10))
    td = tcor.detect_corners(tst, tc, 10).numpy()
    assert jd.sum() > 0
    assert np.array_equal(jd, td)


def test_corner_mask_matches_pallas_interior(rng):
    """Against the Pallas kernel itself (interpret mode): equal on the
    interior, where the two JAX versions agree (they differ only in the
    5-px border: the XLA path and the port wrap around)."""
    H, W = 64, 160
    s = _corner_rich_sae(rng, H, W)
    pal = np.asarray(corners_pallas.corner_mask_pallas(jnp.asarray(s),
                                                       interpret=True))
    tm = tcor.corner_mask_plain(torch.tensor(s)).numpy()
    B = corners_pallas.PAD + 1
    inner = np.s_[:, B:H - B, B:W - B]
    assert np.array_equal(pal[inner], tm[inner])

