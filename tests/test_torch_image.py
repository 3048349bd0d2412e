"""Parity: the port's image path (Shi-Tomasi, CLAHE, frame prep, the stereo
image tracker, CLAHE in the event tracker) against esvio_tpu, float32 on
both sides.

Tolerances:
  * shi_tomasi: candidate xy and valid exact where the responses are exact
    (ties broken by the lower flat index, as jax.lax.top_k does); on blob
    frames, as test_shi_tomasi_matches_on_blobs sets out; responses within
    1e-5 relative;
  * clahe: max abs 1e-3 on the 0-255 scale (float32 sums in another order);
  * frame prep (gray + antialiased bilinear resize): max abs 2e-3;
  * the trackers one step per tick from the JAX tracker's own state:
    features that one side has and the other has not within 1e-2 px (an
    LK convergence or RANSAC threshold decided on one float32 ulp, or two
    candidates of tied response swapped) are counted and bounded, as in
    test_torch_frontend.py; on the lanes where ids, valid, right_valid,
    track_cnt and position all agree, uv within 1e-3 px and un within 1e-5.
"""
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import camera_pair, np_f32, to_torch
from synth import blob_texture, sample_texture
from test_torch_frontend import _unmatched
from esvio_tpu.frontend import clahe as jclahe
from esvio_tpu.frontend import detect as jdetect
from esvio_tpu.frontend import tracker as jtrk
from esvio_tpu_torch.apps import pipeline as tpipe
from esvio_tpu_torch.frontend import clahe as tclahe
from esvio_tpu_torch.frontend import detect as tdetect
from esvio_tpu_torch.frontend import tracker as ttrk

H, W = 120, 160
DISPARITY = 5.0           # tests/test_image_tracker.py:10
LANE_FIELDS = ("ids", "valid", "right_valid", "track_cnt")


def _rect():
    """The rectangle of tests/test_image_tracker.py:14-15: four corners of
    exactly equal response."""
    img = np.zeros((H, W), np.float32)
    img[40:80, 50:110] = 180.0
    return img


def _blob_frame(seed):
    rng = np.random.default_rng(seed)
    tex, margin = blob_texture(rng, H, W, n_blobs=250)
    return np_f32(sample_texture(tex, margin, H, W, 0.3, 0.7))


def test_shi_tomasi_matches_on_exact_ties():
    """The rectangle's responses are exact in float32 on both sides, so
    the candidates are equal, the four tied corners in flat-index order."""
    img = _rect()
    jxy, jr, jok = (np.asarray(a) for a in jdetect.shi_tomasi(
        jnp.asarray(img), max_corners=32))
    txy, tr, tok = tdetect.shi_tomasi(torch.tensor(img), max_corners=32)
    assert np.array_equal(txy.numpy(), jxy) and np.array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-5, atol=0)
    assert txy.numpy()[:4].tolist() == [[50, 40], [109, 40], [50, 79], [109, 79]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shi_tomasi_matches_on_blobs(seed):
    """Blob frames: symmetric blobs give responses that are equal in exact
    arithmetic, and XLA rounds its fused box filter (1/3 taps) otherwise
    than a plain float32 sum, by an ulp at some pixels.  So the lists are
    compared as they can agree: every candidate found by one
    side alone is the twin of a candidate of the other side on an NMS
    plateau (within 1 px, response within 1e-5 relative; measured 1-4 per
    frame, all on the JAX side), and the common candidates come in the
    same order except where their responses tie within 1e-5 relative."""
    img = _blob_frame(seed)
    jxy, jr, jok = (np.asarray(a) for a in jdetect.shi_tomasi(
        jnp.asarray(img), max_corners=512))
    txy, tr, tok = (a.numpy() for a in tdetect.shi_tomasi(torch.tensor(img),
                                                          max_corners=512))
    jxy, jr, txy, tr = jxy[jok], jr[jok], txy[tok], tr[tok]
    assert len(jxy) >= 100
    jset, tset = set(map(tuple, jxy)), set(map(tuple, txy))
    alone = [(p, r, oxy, orr) for xy, rr, oxy, orr, other in
             ((jxy, jr, txy, tr, tset), (txy, tr, jxy, jr, jset))
             for p, r in zip(xy, rr) if tuple(p) not in other]
    assert len(alone) <= 0.03 * len(jxy), len(alone)
    for p, r, oxy, orr in alone:
        near = np.abs(oxy - p).max(1) <= 1
        assert near.any() and (np.abs(orr[near] - r) <= 1e-5 * r).any(), (p, r)
    jc = [k for k, p in enumerate(jxy) if tuple(p) in tset]
    tc = [k for k, p in enumerate(txy) if tuple(p) in jset]
    for a, b in zip(jc, tc):
        if (jxy[a] != txy[b]).any():
            assert abs(jr[a] - tr[b]) <= 1e-5 * jr[a], (jxy[a], txy[b])
    rj = dict(zip(map(tuple, jxy), jr))
    for p, r in zip(txy, tr):
        if tuple(p) in rj:
            assert abs(r - rj[tuple(p)]) <= 1e-5 * r, p
    print("seed", seed, "candidates", len(jxy), len(txy), "alone", len(alone))


@pytest.mark.parametrize("shape", [(120, 160), (123, 165)])
def test_clahe_matches(shape):
    h, w = shape
    rng = np.random.default_rng(h)
    tex, margin = blob_texture(rng, h, w, n_blobs=200)
    img = np_f32(0.6 * sample_texture(tex, margin, h, w, 0.5, 0.25)
                 + rng.uniform(0, 60, (h, w)))
    want = np.asarray(jclahe.clahe(jnp.asarray(img)))
    got = tclahe.clahe(torch.tensor(img)).numpy()
    assert np.abs(got - want).max() < 1e-3, np.abs(got - want).max()
    # the uncropped border keeps the input
    assert np.array_equal(got[h - h % 8:], img[h - h % 8:])
    # a batch equalizes each image alone
    both = tclahe.clahe(torch.tensor(np.stack([img, img[::-1].copy()]))).numpy()
    assert np.array_equal(both[0], got)


@pytest.mark.parametrize("src,dst,rgb", [
    ((1080, 1440), (260, 346), True),
    ((240, 320), (120, 160), True),
    ((120, 160), (240, 320), False),
])
def test_prep_frame_matches(src, dst, rgb):
    import esvio_tpu.apps.pipeline as jpipe
    rng = np.random.default_rng(src[0])
    frame = np_f32(rng.uniform(0, 255, src + ((3,) if rgb else ())))
    holder = types.SimpleNamespace(
        img_tracker_cfg=types.SimpleNamespace(height=dst[0], width=dst[1]))
    want = np.asarray(jpipe.Pipeline._prep_frame(holder, frame))
    got = tpipe.prep_frame(frame, dst[0], dst[1], "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == dst
    assert np.abs(got.numpy() - want).max() < 2e-3, np.abs(got.numpy() - want).max()


def _lanes_differ(jp, tp):
    """Lanes where any of LANE_FIELDS differs, or whose valid feature sits
    more than 1e-3 px away (two candidates of tied response swapped)."""
    diff = np.zeros(np.asarray(jp.valid).shape, bool)
    for f in LANE_FIELDS:
        diff |= np.asarray(getattr(jp, f)) != getattr(tp, f).numpy()
    far = np.abs(tp.uv.numpy() - np.asarray(jp.uv)).max(-1) > 1e-3
    return diff | (far & np.asarray(jp.valid))


def _check_floats(jp, tp, same):
    v = np.asarray(jp.valid) & same
    np.testing.assert_allclose(tp.uv.numpy()[v], np.asarray(jp.uv)[v], atol=1e-3)
    np.testing.assert_allclose(tp.un.numpy()[v], np.asarray(jp.un)[v], atol=1e-5)
    rv = np.asarray(jp.right_valid) & same
    np.testing.assert_allclose(tp.uv_right.numpy()[rv],
                               np.asarray(jp.uv_right)[rv], atol=1e-3)


@pytest.mark.parametrize("equalize,max_flips", [
    (False, 8),       # measured: 5, all in the first tick's detections
    (True, 8),        # measured: 0
])
def test_track_image_stereo_one_step_ticks(equalize, max_flips):
    """The 4 ticks of tests/test_image_tracker.py, each from the JAX image
    tracker's state before it."""
    rng = np.random.default_rng(0)
    tex, margin = blob_texture(rng, H, W, n_blobs=250)
    kw = dict(width=W, height=H, capacity=96, cand_capacity=256, max_cnt=50,
              min_dist=10, lk_iters=15, equalize=equalize)
    jcfg, tcfg = jtrk.TrackerConfig(**kw), ttrk.TrackerConfig(**kw)
    jc, tc = camera_pair(200.0, 200.0, W / 2, H / 2, W, H)
    js = jtrk.init_image_state(jcfg)
    ts0 = ttrk.init_image_state(tcfg, "cpu")
    assert int(ts0.next_id) == 1 << 24
    assert np.array_equal(ts0.key.numpy(), np.asarray(js.key).astype(np.int64))
    vel = np.array([30.0, 18.0])
    flips = []
    for k in range(4):
        off = vel * k * 0.05
        img_l = np_f32(sample_texture(tex, margin, H, W, off[0], off[1]))
        img_r = np_f32(sample_texture(tex, margin, H, W, off[0] + DISPARITY,
                                      off[1]))
        t = 1.0 + k * 0.05
        ts, tp = ttrk.track_image_stereo(
            tcfg, tc, tc, to_torch(js, ttrk.ImageTrackerState),
            torch.tensor(img_l), torch.tensor(img_r), t)
        js, jp = jtrk.track_image_stereo(jcfg, jc, jc, js, jnp.asarray(img_l),
                                         jnp.asarray(img_r), t)
        assert int(np.asarray(jp.valid).sum()) >= 20
        _check_floats(jp, tp, ~_lanes_differ(jp, tp))
        flips.append(_unmatched(np.asarray(jp.uv), np.asarray(jp.valid),
                                tp.uv.numpy(), tp.valid.numpy()))
        assert np.array_equal(ts.key.numpy(), np.asarray(js.key).astype(np.int64))
        assert (tp.ids.numpy()[tp.valid.numpy()] >= (1 << 24)).all()
    print("equalize", equalize, "unmatched features per tick", flips)
    assert sum(flips) <= max_flips, flips
    # the converted states round-trip
    from torch_parity import to_jax
    back = to_jax(ts, jtrk.ImageTrackerState)
    assert np.array_equal(np.asarray(back.ids), ts.ids.numpy())


def test_track_event_stereo_equalize_one_step_ticks():
    """CLAHE on the event tracker's time surfaces: three ticks of the golden
    prefix, each from the JAX tracker's state before it."""
    from esvio_tpu.events.sae import EventChunk as JChunk
    from esvio_tpu_torch.io import datasets as tds
    from synth_np import planar_vio_sequence_rot
    seq, _, _ = planar_vio_sequence_rot(np.random.default_rng(0), H=H, W=W,
                                        duration=0.3)
    kw = dict(width=W, height=H, capacity=128, cand_capacity=512, max_cnt=60,
              min_dist=10, lk_iters=15, equalize=True)
    jcfg, tcfg = jtrk.TrackerConfig(**kw), ttrk.TrackerConfig(**kw)
    jc, tc = camera_pair(200.0, 200.0, W / 2, H / 2, W, H)
    cl = list(tds.iterate_chunks(seq.events_left, 15, 1 << 15, "cpu"))
    cr = list(tds.iterate_chunks(seq.events_right, 15, 1 << 15, "cpu"))
    as_j = lambda c: JChunk(*(jnp.asarray(getattr(c, f).numpy())
                              for f in ("t", "x", "y", "p", "valid")))
    js = jtrk.init_state(jcfg)
    flips = []
    for k in range(3):
        t = cl[k][0]
        _, tp = ttrk.track_event_stereo(tcfg, tc, tc,
                                        to_torch(js, ttrk.TrackerState),
                                        cl[k][1], cr[k][1], t)
        js, jp = jtrk.track_event_stereo(jcfg, jc, jc, js, as_j(cl[k][1]),
                                         as_j(cr[k][1]), t)
        assert int(np.asarray(jp.valid).sum()) > 10
        _check_floats(jp, tp, ~_lanes_differ(jp, tp))
        flips.append(_unmatched(np.asarray(jp.uv), np.asarray(jp.valid),
                                tp.uv.numpy(), tp.valid.numpy()))
    print("event tracker with CLAHE, unmatched features per tick", flips)
    assert sum(flips) <= 10, flips        # measured: 6 over ticks 2-3


def test_entry_points_default_to_the_card():
    """Pipeline, Estimator and both trackers' state constructors run on the
    card unless the caller asks for the CPU; with no card they raise
    instead of falling back."""
    import inspect
    from esvio_tpu_torch.vio import estimator as test_
    for fn in (tpipe.Pipeline, test_.Estimator, ttrk.init_state,
               ttrk.init_image_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ttrk.init_image_state(ttrk.TrackerConfig(width=W, height=H))
