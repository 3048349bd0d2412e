"""Parity: the port's greedy_spacing (esvio_tpu_torch.frontend.mask) and the
event tracker with spacing="greedy" against esvio_tpu, float32 inputs on
both sides.

Tolerances: keep masks, occupancy grids and packet ids exact.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import camera_pair, np_f32
from esvio_tpu.frontend import mask as jmask
from esvio_tpu.frontend import tracker as jtrk
from esvio_tpu_torch.frontend import mask as tmask
from esvio_tpu_torch.frontend import tracker as ttrk
from esvio_tpu_torch.io import datasets as tds


def _both(pri, xs, ys, valid, H, W, min_dist, max_keep, occupied=None):
    jo = None if occupied is None else jnp.asarray(occupied)
    to = None if occupied is None else torch.tensor(occupied)
    jk, jg = jmask.greedy_spacing(jnp.asarray(pri), jnp.asarray(xs),
                                  jnp.asarray(ys), jnp.asarray(valid), H, W,
                                  min_dist=min_dist, max_keep=max_keep,
                                  occupied=jo)
    tk, tg = tmask.greedy_spacing(torch.tensor(pri), torch.tensor(xs),
                                  torch.tensor(ys), torch.tensor(valid), H, W,
                                  min_dist=min_dist, max_keep=max_keep,
                                  occupied=to)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    return tk.numpy()


def test_greedy_spacing_matches(rng):
    """tests/test_frontend.py::test_greedy_spacing_properties' inputs."""
    n, H, W = 200, 100, 140
    xs = np_f32(rng.uniform(0, W - 1, n))
    ys = np_f32(rng.uniform(0, H - 1, n))
    pri = np_f32(rng.uniform(0, 10, n))
    valid = rng.random(n) > 0.1
    keep = _both(pri, xs, ys, valid, H, W, 10, 60)
    assert 10 < keep.sum() <= 60 and not np.any(keep & ~valid)
    keep2 = _both(np_f32([1.0, 5.0]), np_f32([50.0, 52.0]), np_f32([50.0, 50.0]),
                  np.ones(2, bool), H, W, 10, 10)
    assert keep2.tolist() == [False, True]


def test_greedy_spacing_matches_on_exact_ties(rng):
    """Track counts tie often: ties go by index, as a stable argsort orders
    them, and the budget max_keep binds."""
    n, H, W = 300, 60, 80
    xs = np_f32(rng.integers(0, W, n))
    ys = np_f32(rng.integers(0, H, n))
    pri = np_f32(1e6 + rng.integers(0, 3, n))
    valid = rng.random(n) > 0.2
    keep = _both(pri, xs, ys, valid, H, W, 6, 25)
    assert keep.sum() == 25


def test_greedy_spacing_matches_with_occupancy(rng):
    n, H, W = 250, 90, 120
    xs = np_f32(rng.uniform(0, W - 1, n))
    ys = np_f32(rng.uniform(0, H - 1, n))
    pri = np_f32(rng.uniform(0, 10, n))
    valid = rng.random(n) > 0.1
    occupied = np.zeros((H, W), bool)
    occupied[20:50, 30:90] = True
    occupied |= rng.random((H, W)) < 0.05
    keep = _both(pri, xs, ys, valid, H, W, 8, 80, occupied)
    xi = np.clip(np.round(xs).astype(int), 0, W - 1)
    yi = np.clip(np.round(ys).astype(int), 0, H - 1)
    assert keep.sum() > 10 and not occupied[yi[keep], xi[keep]].any()


def test_track_event_stereo_greedy_matches():
    """One event-tracker tick with spacing="greedy" on the golden's first
    chunks: the same packet (ids, valid, track counts) as the JAX
    tracker's.  One tick, because from the second on the tracked features'
    LK positions (within 2e-3 px of JAX's, tests/test_torch_frontend.py)
    enter the greedy mask rounded: on this sequence one lies 4.4e-4 px from
    a .5 boundary at the second tick, and the masks of the two packages
    agree on either package's inputs."""
    from synth_np import planar_vio_sequence_rot
    from esvio_tpu.events.sae import EventChunk as JChunk
    H, W = 120, 160
    seq, _, _ = planar_vio_sequence_rot(np.random.default_rng(0), H=H, W=W,
                                        duration=0.4)
    kw = dict(width=W, height=H, capacity=128, cand_capacity=512, max_cnt=60,
              min_dist=10, lk_iters=15, spacing="greedy")
    jcfg, tcfg = jtrk.TrackerConfig(**kw), ttrk.TrackerConfig(**kw)
    jc, tc = camera_pair(200.0, 200.0, W / 2, H / 2, W, H)
    js, ts = jtrk.init_state(jcfg), ttrk.init_state(tcfg, "cpu")
    cl = list(tds.iterate_chunks(seq.events_left, 15, 1 << 15, "cpu"))
    cr = list(tds.iterate_chunks(seq.events_right, 15, 1 << 15, "cpu"))
    as_j = lambda c: JChunk(*(jnp.asarray(getattr(c, f).numpy())
                              for f in ("t", "x", "y", "p", "valid")))
    t = cl[0][0]
    js, jp = jtrk.track_event_stereo(jcfg, jc, jc, js, as_j(cl[0][1]),
                                     as_j(cr[0][1]), t)
    ts, tp = ttrk.track_event_stereo(tcfg, tc, tc, ts, cl[0][1], cr[0][1], t)
    for f in ("ids", "valid", "track_cnt"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()), f
    assert int(np.asarray(jp.valid).sum()) > 10


def test_tracker_config_rejects_unknown_spacing():
    """A spacing other than the two the tracker runs is refused when the
    configuration is made, not run as the other one."""
    for spacing in ("grid", "greedy"):
        assert ttrk.TrackerConfig(spacing=spacing).spacing == spacing
    with pytest.raises(ValueError, match="spacing"):
        ttrk.TrackerConfig(spacing="gready")
