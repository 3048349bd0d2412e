"""Parity: esvio_tpu_torch.frontend (pyramid, LK, fundamental RANSAC, grid
spacing, the event tracker) against esvio_tpu.frontend, float32 on both
sides.

Tolerances: integer and boolean outputs (status, inlier masks, keep masks,
ids, valid flags) exact; LK positions within 2e-3 px and normalized
coordinates within 1e-5 (float32 GN iterations whose sums run in another
order); pyramids within 1e-4 of 255-scale intensities.

Over all 24 ticks of the golden sequence, one step at a time from the JAX
tracker's own state, the tracked features are counted, not required
equal: LK stops at |δ| < 0.01 px and RANSAC counts d² < 1 px², so one
float32 ulp of difference flips single features.  The JAX package is no
steadier against itself: run op by op (jax.disable_jit) instead of jitted,
its float32 tracker disagrees with its jitted self at 4 of the 24 ticks
(21 unmatched features), the port at 7 (34).  In float64 on both sides the
flips all but vanish (bounds below).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import camera_pair, np_f32, to_torch
from esvio_tpu.frontend import lk as jlk
from esvio_tpu.frontend import mask as jmask
from esvio_tpu.frontend import pyramid as jpyr
from esvio_tpu.frontend import ransac as jransac
from esvio_tpu.frontend import tracker as jtrk
from esvio_tpu.io import datasets as jds
from esvio_tpu_torch.core import prng
from esvio_tpu_torch.frontend import lk as tlk
from esvio_tpu_torch.frontend import mask as tmask
from esvio_tpu_torch.frontend import pyramid as tpyr
from esvio_tpu_torch.frontend import ransac as transac
from esvio_tpu_torch.frontend import tracker as ttrk
from esvio_tpu_torch.io import datasets as tds


def _smooth_image(rng, H, W, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xx = xx - shift[0]
    yy = yy - shift[1]
    img = np.zeros((H, W))
    for k in range(6):
        fx, fy, ph = rng.uniform(0.05, 0.2), rng.uniform(0.05, 0.2), rng.uniform(0, 6)
        img += np.sin(fx * xx + ph) * np.cos(fy * yy - ph)
    return np_f32(127.5 + 20.0 * img)


def test_pyramid_matches(rng):
    img = _smooth_image(rng, 60, 90)
    jp = jpyr.build_lk_pyramid(jnp.asarray(img), 4)
    tp = tpyr.build_lk_pyramid(torch.tensor(img), 4)
    for (a,), (b,) in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_lk_track_matches(rng):
    H, W = 96, 128
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    prev = _smooth_image(r1, H, W)
    cur = _smooth_image(r2, H, W, shift=(1.7, -1.2))
    pts = np_f32(np.stack([rng.uniform(12, W - 12, 40), rng.uniform(12, H - 12, 40)], -1))
    valid = rng.random(40) < 0.9
    jprev, jcur = jpyr.build_lk_pyramid(jnp.asarray(prev), 3), jpyr.build_lk_pyramid(jnp.asarray(cur), 3)
    tprev, tcur = tpyr.build_lk_pyramid(torch.tensor(prev), 3), tpyr.build_lk_pyramid(torch.tensor(cur), 3)
    jo, js = jlk.lk_track(jprev, jcur, jnp.asarray(pts), jnp.asarray(valid), iters=15)
    to, ts = tlk.lk_track(tprev, tcur, torch.tensor(pts), torch.tensor(valid), iters=15)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.asarray(js).sum() > 20
    np.testing.assert_allclose(to.numpy()[ts.numpy()], np.asarray(jo)[np.asarray(js)], atol=2e-3)


def _lk_inputs(rng, H=60, W=90, N=24):
    """Shifted smooth images as 3-level pyramids, N points (a few near the
    border) and a valid mask, for the plain-path LK tests."""
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    prev = tpyr.build_lk_pyramid(torch.tensor(_smooth_image(r1, H, W)), 3)
    cur = tpyr.build_lk_pyramid(torch.tensor(_smooth_image(r2, H, W, shift=(1.7, -1.2))), 3)
    pts = torch.tensor(np_f32(np.stack([rng.uniform(2, W - 2, N),
                                        rng.uniform(2, H - 2, N)], -1)))
    return prev, cur, pts, torch.tensor(rng.random(N) < 0.8)


def test_lk_per_lane_exit_is_exact(rng, monkeypatch):
    """Stopping each lane at its own convergence (K3's exit) gives the
    global exit's result: with the convergence check never true, every
    level loop runs all its iterations, and points and status are the same
    bits."""
    prev, cur, pts, valid = _lk_inputs(rng)
    want = tlk.lk_track(prev, cur, pts, valid, iters=15)
    calls = []
    monkeypatch.setattr(tlk, "to_host", lambda x: calls.append(1) or False)
    got = tlk.lk_track(prev, cur, pts, valid, iters=15)
    assert len(calls) == 2 * 15          # no early exit (level 2 < window)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 5


def test_lk_track_fb_on_cpu_is_the_two_plain_calls(rng):
    """The pair wrapper on CPU tensors: the forward call and the reverse
    check over the two finest levels from the original points, bit for
    bit."""
    prev, cur, pts, valid = _lk_inputs(rng)
    init = pts + 0.5
    got = tlk.lk_track_fb(prev, cur, pts, valid, pts_init=init, iters=15)
    fwd, st = tlk.lk_track(prev, cur, pts, valid, pts_init=init, iters=15)
    back, st_b = tlk.lk_track(cur[:2], prev[:2], fwd, st, pts_init=pts, iters=15)
    for a, b in zip(got, (fwd, st, back, st_b)):
        assert torch.equal(a, b)
    assert int(st_b.sum()) > 5


def _epipolar_pairs(rng, N=60, outliers=12):
    """Correspondences of a rotating/translating camera at virtual focal 460
    with a block of gross outliers."""
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                  rng.uniform(4, 8, N)], -1)
    ang = 0.03
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.2, 0.05, 0.0])
    X2 = X @ R.T + t
    p1 = X[:, :2] / X[:, 2:] * 460 + [173, 130]
    p2 = X2[:, :2] / X2[:, 2:] * 460 + [173, 130]
    p2[:outliers] += rng.uniform(-15, 15, (outliers, 2))
    return np_f32(p1), np_f32(p2)


def test_fundamental_ransac_injected_and_keyed_draws_match(rng):
    p1, p2 = _epipolar_pairs(rng)
    valid = np.ones(len(p1), bool)
    valid[-5:] = False
    jkey = jax.random.PRNGKey(11)
    # the draws the JAX version makes from this key ...
    order = np.argsort(~valid, kind="stable")
    n_valid = int(valid.sum())
    draws = np.asarray(jax.random.randint(jkey, (128, 8), 0, max(n_valid, 8)))
    tkey = prng.PRNGKey(11)
    # ... are the port's own draws
    assert np.array_equal(transac.draw_hypotheses(tkey, torch.tensor(valid), 128).numpy(),
                          draws)
    jin, jF = jransac.fundamental_ransac(jkey, jnp.asarray(p1), jnp.asarray(p2),
                                         jnp.asarray(valid), 1.0, 128)
    for d in (None, torch.tensor(draws)):
        tin, tF = transac.fundamental_ransac(tkey, torch.tensor(p1), torch.tensor(p2),
                                             torch.tensor(valid), 1.0, 128, draws=d)
        assert np.array_equal(np.asarray(jin), tin.numpy())
    # the clean points are inliers; of the 12 perturbed ones only those
    # whose random offset happened to land near their epipolar line are
    assert np.asarray(jin)[12:-5].all() and np.asarray(jin)[:12].sum() <= 2
    assert order.shape == valid.shape


def test_grid_spacing_matches(rng):
    N, H, W = 400, 120, 160
    xs = np_f32(rng.uniform(0, W - 1, N))
    ys = np_f32(rng.uniform(0, H - 1, N))
    pri = np_f32(rng.permutation(N))
    valid = rng.random(N) < 0.8
    jk, jo = jmask.grid_spacing(jnp.asarray(pri), jnp.asarray(xs), jnp.asarray(ys),
                                jnp.asarray(valid), H, W, 10, 60)
    tk, to = tmask.grid_spacing(torch.tensor(pri), torch.tensor(xs), torch.tensor(ys),
                                torch.tensor(valid), H, W, 10, 60)
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert 0 < tk.sum() <= 60


@pytest.fixture(scope="module")
def golden_prefix():
    """The first 0.4 s of the ESIO golden sequence (numpy synth)."""
    from synth_np import planar_vio_sequence_rot
    seq, _, _ = planar_vio_sequence_rot(np.random.default_rng(0), H=120, W=160,
                                        duration=0.4)
    return seq


def test_chunking_matches_native_packetizer(golden_prefix):
    """The port's numpy chunker = the JAX pipeline's packetizer."""
    for stream in (golden_prefix.events_left, golden_prefix.events_right):
        jl = list(jds.iterate_chunks_fast(stream, 15, 1 << 13))
        tl = list(tds.iterate_chunks(stream, 15, 1 << 13, "cpu"))
        assert len(jl) == len(tl) > 3
        for (ta, ca), (tb, cb) in zip(jl, tl):
            assert ta == tb
            for f in ("t", "x", "y", "p", "valid"):
                assert np.array_equal(np.asarray(getattr(ca, f)),
                                      getattr(cb, f).numpy())


def test_track_event_stereo_three_ticks(golden_prefix):
    H, W = 120, 160
    kw = dict(width=W, height=H, capacity=128, cand_capacity=512, max_cnt=60,
              min_dist=10, lk_iters=15)
    jcfg, tcfg = jtrk.TrackerConfig(**kw), ttrk.TrackerConfig(**kw)
    jc, tc = camera_pair(200.0, 200.0, W / 2, H / 2, W, H)
    js, ts = jtrk.init_state(jcfg), ttrk.init_state(tcfg, "cpu")
    cl = list(tds.iterate_chunks(golden_prefix.events_left, 15, 1 << 15, "cpu"))
    cr = list(tds.iterate_chunks(golden_prefix.events_right, 15, 1 << 15, "cpu"))
    from esvio_tpu.events.sae import EventChunk as JChunk
    as_j = lambda c: JChunk(*(jnp.asarray(getattr(c, f).numpy())
                              for f in ("t", "x", "y", "p", "valid")))
    for k in range(3):
        t = cl[k][0]
        js, jp = jtrk.track_event_stereo(jcfg, jc, jc, js, as_j(cl[k][1]),
                                         as_j(cr[k][1]), t)
        ts, tp = ttrk.track_event_stereo(tcfg, tc, tc, ts, cl[k][1], cr[k][1], t)
        for f in ("ids", "valid", "right_valid", "track_cnt"):
            assert np.array_equal(np.asarray(getattr(jp, f)),
                                  getattr(tp, f).numpy()), (k, f)
        assert int(np.asarray(jp.valid).sum()) > 10
        np.testing.assert_allclose(tp.uv.numpy(), np.asarray(jp.uv), atol=2e-3)
        np.testing.assert_allclose(tp.un.numpy(), np.asarray(jp.un), atol=1e-5)
        rv = np.asarray(jp.right_valid)
        np.testing.assert_allclose(tp.un_right.numpy()[rv],
                                   np.asarray(jp.un_right)[rv], atol=1e-5)
        assert np.array_equal(np.asarray(js.key).astype(np.int64), ts.key.numpy())
    # the converted JAX state drives the port's next tick like its own
    ts2 = to_torch(js, ttrk.TrackerState)
    for f in ("pts", "ids", "valid"):
        a, b = getattr(ts2, f).numpy(), getattr(ts, f).numpy()
        assert np.allclose(a, b, atol=2e-3), f


@pytest.fixture(scope="module")
def golden_ticks():
    """The 24 chunk pairs of the ESIO golden sequence (numpy synth)."""
    from synth_np import GOLDEN, planar_vio_sequence_rot
    seq, _, _ = planar_vio_sequence_rot(
        np.random.default_rng(0), H=GOLDEN["H"], W=GOLDEN["W"],
        focal=GOLDEN["focal"], duration=GOLDEN["duration"])
    return (list(tds.iterate_chunks(seq.events_left, 15, 1 << 15, "cpu")),
            list(tds.iterate_chunks(seq.events_right, 15, 1 << 15, "cpu")))


def _unmatched(uv_a, valid_a, uv_b, valid_b, tol=1e-2):
    """Features of either packet with no feature of the other within `tol`
    px (by position: one extra detection shifts every later new id)."""
    a, b = uv_a[valid_a], uv_b[valid_b]
    if len(a) == 0 or len(b) == 0:
        return len(a) + len(b)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    return int((d.min(1) > tol).sum() + (d.min(0) > tol).sum())


@pytest.mark.parametrize("dtype,max_ticks,max_features", [
    ("float32", 8, 40),       # measured: 7 ticks, 34 features
    ("float64", 1, 2),        # measured: 1 tick, 1 feature
])
def test_track_event_stereo_one_step_golden_ticks(golden_ticks, dtype,
                                                  max_ticks, max_features):
    """Each of the 24 golden ticks from the JAX tracker's state before it:
    the ticks whose tracked features differ, and how many differ."""
    H, W = 120, 160
    kw = dict(width=W, height=H, capacity=128, cand_capacity=512, max_cnt=60,
              min_dist=10, lk_iters=15)
    jcfg, tcfg = jtrk.TrackerConfig(**kw), ttrk.TrackerConfig(**kw)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    from esvio_tpu.core import camera as jcam
    from esvio_tpu.events.sae import EventChunk as JChunk
    from esvio_tpu_torch.core import camera as tcam
    jc = jcam.make_pinhole(200.0, 200.0, W / 2, H / 2, width=W, height=H,
                           dtype=jdt)
    tc = tcam.make_pinhole(200.0, 200.0, W / 2, H / 2, width=W, height=H,
                           dtype=tdt)
    as_j = lambda c: JChunk(jnp.asarray(c.t.numpy()).astype(jdt),
                            *(jnp.asarray(getattr(c, f).numpy())
                              for f in ("x", "y", "p", "valid")))
    as_t = lambda c: type(c)(c.t.to(tdt), c.x, c.y, c.p, c.valid)
    cl, cr = golden_ticks
    assert len(cl) == 24
    js = jtrk.init_state(jcfg, dtype=jdt)
    per_tick = []
    for (t, ch_l), (_, ch_r) in zip(cl, cr):
        _, tp = ttrk.track_event_stereo(tcfg, tc, tc,
                                        to_torch(js, ttrk.TrackerState),
                                        as_t(ch_l), as_t(ch_r), t)
        js, jp = jtrk.track_event_stereo(jcfg, jc, jc, js, as_j(ch_l),
                                         as_j(ch_r), t)
        assert int(np.asarray(jp.valid).sum()) >= 10
        per_tick.append(_unmatched(np.asarray(jp.uv), np.asarray(jp.valid),
                                   tp.uv.numpy(), tp.valid.numpy()))
    print(dtype, "unmatched features per tick", per_tick)
    assert sum(n > 0 for n in per_tick) <= max_ticks, per_tick
    assert sum(per_tick) <= max_features, per_tick
