"""The port's fused steady tick (esvio_tpu_torch.vio.estimator._fused_tick)
against the JAX package's `_fused_tick`, against the port's own general
path, and its one-fetch invariant, on the CPU in float32.

One drive (the synthetic run of test_torch_vio.py, 15 frames) feeds the
same packets and IMU samples to three estimators: the JAX package's on its
default fused path, with its marginalization in float64 as the port takes
it (torch_parity.jax_marginalization_f64) and every `_fused_tick` call
recorded; the port's on its default fused path, its host reads counted on
every steady tick; the port's general path (fused=False).  A fourth, the
port's ESVIO estimator (mode "esvio"), also gets an image packet of the
same world on every frame but one steady frame, and initializes from its
image book; its host reads are counted on every steady tick too.

Tolerances:
  (a) one tick of each branch from the JAX call's own inputs: marg_old,
      n_trk, n_drop_e, fail, num and kf_valid exact; the window's P within
      1e-4 and V within 1e-3 (test_torch_vio's one tick from a JAX state);
      the prior as J0ᵀJ0 and J0ᵀr0 within 5 % (test_torch_solver.py);
  (b) port fused against port general, tick by tick: solver and marg flags
      equal, P and V within 2e-3, |q·q'| > 1 - 1e-5 (the JAX package's own
      gates between its two paths, tests/test_fused_tick.py:58-70);
  (c) exactly one host read per steady tick, over at least four, on ESIO
      ticks and on ESVIO ticks with and without a frame;
  (d) one tick with an image packet (has_img=True) from a recorded JAX call
      whose image book and packet mirror its event ones (ids offset by
      1 << 24), through the JAX and the port's `_fused_tick`: every integer
      and flag of post exact, P and V within 2e-3
      (tests/test_fused_tick.py:66-67).
"""
import dataclasses
import types

import numpy as np
import pytest
import jax
import torch

from torch_parity import jax_marginalization_f64, rel_err, to_torch
from test_estimator import BASELINE, make_world, packet_for_frame
from synth import simulate_trajectory
from esvio_tpu.vio import estimator as jest
from esvio_tpu_torch.imu import preintegration as tpre
from esvio_tpu_torch.solver import gauss_newton as tgn
from esvio_tpu_torch.solver import window as twin
from esvio_tpu_torch.vio import estimator as test_

N_FRAMES = 15
IMG_ID0 = 1 << 24
NO_FRAME = 13        # the steady frame of the ESVIO estimator without a frame
STATIC = ("has_img", "iters", "cauchy_c", "sc", "kf_ex_idx", "min_track")
READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def drive():
    with jax_marginalization_f64(), pytest.MonkeyPatch.context() as mp:
        # a fresh jit of the JAX fused tick, traced inside the context, whose
        # calls are recorded (inputs and outputs, on the host)
        fresh = _fresh_jax_fused_tick()
        calls = []

        def recording(*args, **kw):
            out = fresh(*args, **kw)
            calls.append((_host(args), kw, _host(out)))
            return out

        mp.setattr(jest, "_fused_tick", recording)
        out = _drive()
    out["calls"] = calls
    return out


def _fresh_jax_fused_tick():
    """A new jit of the JAX `_fused_tick` (traced where it is first called,
    so inside jax_marginalization_f64 it takes that marginalization)."""
    f = jest._fused_tick.__wrapped__
    return jax.jit(types.FunctionType(f.__code__, f.__globals__, "_fused_tick",
                                      f.__defaults__, f.__closure__),
                   static_argnames=STATIC)


def _image_packet(pkt):
    """An image packet of the same features as `pkt`, ids offset."""
    return types.SimpleNamespace(**{
        **vars(pkt), "ids": np.where(pkt.valid, pkt.ids + IMG_ID0, -1)})


def _drive():
    rng = np.random.default_rng(3)
    traj = simulate_trajectory(rng, n_frames=N_FRAMES, imu_per_frame=10,
                               frame_dt=0.05)
    lms = make_world(rng, traj)
    ex_p = np.array([[0, 0, 0], [0, 0, 0], [BASELINE, 0, 0], [BASELINE, 0, 0]],
                    float)
    ex_q = np.tile(np.array([1.0, 0, 0, 0]), (4, 1))
    kw = dict(mode="esio", evt_capacity=128, img_capacity=8, min_track_for_kf=15)
    je = jest.Estimator(jest.EstimatorConfig(**kw), ex_p, ex_q)
    tf = test_.Estimator(test_.EstimatorConfig(**kw), ex_p, ex_q, "cpu")
    tg = test_.Estimator(test_.EstimatorConfig(fused=False, **kw), ex_p, ex_q,
                         "cpu")
    tv = test_.Estimator(test_.EstimatorConfig(**{
        **kw, "mode": "esvio", "img_capacity": 128}), ex_p, ex_q, "cpu")
    out = dict(fused=[], general=[], reads=[], esvio=[], esvio_reads=[])
    seen, seen_img = set(), set()
    rng_img = np.random.default_rng(5)
    for f in range(N_FRAMES):
        if f > 0:
            for s in range(traj["imu_per_frame"]):
                i = (f - 1) * traj["imu_per_frame"] + s + 1
                for e in (je, tf, tg, tv):
                    e.process_imu(traj["dt"], traj["imu_acc"][i],
                                  traj["imu_gyr"][i])
        pkt, seen = packet_for_frame(traj, f, lms, seen, 0.3 / 460.0, rng)
        pkt_img, seen_img = packet_for_frame(traj, f, lms, seen_img,
                                             0.3 / 460.0, rng_img)
        je.process_packets(traj["t"][f], pkt)
        out["general"].append(tg.process_packets(traj["t"][f], pkt))
        out["fused"].append(_counted_tick(tf, out["reads"], traj["t"][f], pkt))
        out["esvio"].append(_counted_tick(
            tv, out["esvio_reads"], traj["t"][f], pkt,
            None if f == NO_FRAME else _image_packet(pkt_img)))
    out["esvio_book_img"] = tv.book_img
    return out


def _counted_tick(est, reads, t, *pkts):
    """est.process_packets(t, *pkts), its host reads appended to `reads`
    when the tick is a steady one."""
    steady = est.solver_flag == "NON_LINEAR" and est.frame_count == twin.WINDOW
    count = [0]
    with pytest.MonkeyPatch.context() as mp:
        for name in READS if steady else ():
            mp.setattr(torch.Tensor, name,
                       _counted(getattr(torch.Tensor, name), count))
        out = est.process_packets(t, *pkts)
    if steady:
        reads.append((count[0], pkts[-1] is not None if len(pkts) > 1 else None))
    return out


def _counted(real, count):
    def counted(self, *a, **k):
        count[0] += 1
        return real(self, *a, **k)
    return counted


def _port_tick(args, kw):
    """The port's _fused_tick on one recorded JAX call's inputs."""
    (ws, bi, be, prior, pe, pi, imu_dt, imu_acc, imu_gyr, a0s, g0s, mask,
     imu_valid, g, frozen, imu_params, min_par) = args
    t = lambda a: torch.from_numpy(np.array(a))
    n = int(np.nonzero(mask.any(0))[0].max()) + 1
    return test_._fused_tick(
        to_torch(ws, twin.WindowState), to_torch(bi, twin.FeatureBook),
        to_torch(be, twin.FeatureBook), to_torch(prior, tgn.Prior),
        tuple(t(a) for a in pe), tuple(t(a) for a in pi),
        *(t(a) for a in (imu_dt, imu_acc, imu_gyr, a0s, g0s, mask, imu_valid,
                         g, frozen)),
        to_torch(imu_params, tpre.ImuParams), t(min_par), **kw,
        n_steps=n)


def _normal(J0, r0):
    J0 = np.asarray(J0, np.float64)
    return J0.T @ J0, J0.T @ np.asarray(r0, np.float64)


@pytest.mark.parametrize("branch", ["MARGIN_OLD", "MARGIN_SECOND_NEW"])
def test_one_fused_tick_matches_jax(drive, branch):
    want_old = branch == "MARGIN_OLD"
    calls = [c for c in drive["calls"] if bool(c[2][4]["marg_old"]) == want_old]
    assert calls, f"the drive made no {branch} fused tick"
    args, kw, (jws, jbi, jbe, jprior, jpost) = calls[0]
    ws, bi, be, prior, post = _port_tick(args, kw)
    for k in ("marg_old", "n_trk", "n_drop_e", "fail", "num", "kf_valid"):
        assert np.array_equal(post[k], jpost[k]), k
    np.testing.assert_allclose(post["P"], jpost["P"], atol=1e-4)
    np.testing.assert_allclose(post["V"], jpost["V"], atol=1e-3)
    # the slid window and the new prior
    np.testing.assert_allclose(ws.P.numpy(), jws.P, atol=1e-4)
    np.testing.assert_allclose(ws.V.numpy(), jws.V, atol=1e-3)
    for f in ("ids", "active", "obs"):
        assert np.array_equal(getattr(be, f).numpy(), getattr(jbe, f)), f
    assert bool(prior.valid) == bool(jprior.valid)
    (A, b), (jA, jb) = _normal(prior.J0, prior.r0), _normal(jprior.J0, jprior.r0)
    assert rel_err(A, jA) < 5e-2 and rel_err(b, jb) < 5e-2


def test_fused_matches_general_path(drive):
    fused, general = drive["fused"], drive["general"]
    assert [o.solver_flag for o in fused] == [o.solver_flag for o in general]
    assert [o.marg_flag for o in fused] == [o.marg_flag for o in general]
    n = 0
    for of, og in zip(fused, general):
        if of.solver_flag != "NON_LINEAR":
            continue
        n += 1
        np.testing.assert_allclose(of.P, og.P, atol=2e-3)
        np.testing.assert_allclose(of.V, og.V, atol=2e-3)
        assert abs(float(np.dot(of.Q, og.Q))) > 1.0 - 1e-5, (of.Q, og.Q)
        assert (of.keyframe is None) == (og.keyframe is None)
    assert n >= 5


def test_fused_tick_makes_exactly_one_host_read(drive):
    reads = [n for n, _ in drive["reads"]]
    assert len(reads) >= 4, "never reached steady state"
    assert reads == [1] * len(reads), reads


def test_esvio_fused_tick_makes_exactly_one_host_read(drive):
    """ESVIO steady ticks, with a frame and without one (NO_FRAME)."""
    reads = drive["esvio_reads"]
    assert len(reads) >= 4, "the ESVIO estimator never reached steady state"
    assert [n for n, _ in reads] == [1] * len(reads), reads
    assert {has for _, has in reads} == {True, False}, reads
    assert all(o.solver_flag == "NON_LINEAR" for o in drive["esvio"][-4:])
    assert bool(drive["esvio_book_img"].active.any())


@pytest.mark.parametrize("branch", ["MARGIN_OLD", "MARGIN_SECOND_NEW"])
def test_one_fused_tick_with_image_packet_matches_jax(drive, branch):
    """A recorded ESIO call turned into an ESVIO one: the image book is the
    event book and the image packet the event packet, ids offset; the JAX
    `_fused_tick` (has_img=True, kf_ex_idx=0, marginalization in float64)
    against the port's on the same inputs."""
    want_old = branch == "MARGIN_OLD"
    calls = [c for c in drive["calls"] if bool(c[2][4]["marg_old"]) == want_old]
    assert calls, f"the drive made no {branch} fused tick"
    args, kw, _ = calls[0]
    args = list(args)
    be, pe = args[2], args[4]
    args[1] = dataclasses.replace(be, ids=np.where(be.ids >= 0, be.ids + IMG_ID0,
                                                   -1).astype(np.int32))
    args[5] = (np.where(pe[1], pe[0] + IMG_ID0, -1).astype(np.int32),) + pe[1:]
    kw = dict(kw, has_img=True, kf_ex_idx=0)
    with jax_marginalization_f64():
        jws, jbi, jbe, jprior, jpost = _host(_fresh_jax_fused_tick()(*args, **kw))
    ws, bi, be, prior, post = _port_tick(args, kw)
    assert bool(jpost["marg_old"]) == want_old
    for k in ("marg_old", "n_trk", "n_drop_e", "n_drop_i", "fail", "num",
              "kf_valid", "kf_obs", "kf_ids"):
        assert np.array_equal(post[k], jpost[k]), k
    assert (post["kf_ids"] >= IMG_ID0).sum() > 0
    np.testing.assert_allclose(post["P"], jpost["P"], atol=2e-3)
    np.testing.assert_allclose(post["V"], jpost["V"], atol=2e-3)
    for book, jbook in ((bi, jbi), (be, jbe)):
        for f in ("ids", "active", "obs"):
            assert np.array_equal(getattr(book, f).numpy(), getattr(jbook, f)), f
    assert bool(prior.valid) == bool(jprior.valid)


def test_post_packs_into_one_fetch():
    """pack_post/fetch_post: every dtype of the post dict through one byte
    buffer, unpacked into arrays that own their memory."""
    from esvio_tpu_torch.vio.fused_graph import fetch_post, pack_post
    rng = np.random.default_rng(0)
    post = dict(P=torch.tensor(rng.normal(size=(11, 3)).astype(np.float32)),
                ids=torch.tensor(rng.integers(-1, 99, 128).astype(np.int32)),
                obs=torch.tensor(rng.random((128, 11)) > 0.5)[:, 8],
                n=torch.tensor(7), flag=torch.tensor(True),
                x64=torch.tensor(rng.normal(size=4)))
    got = fetch_post(*pack_post(post))
    assert list(got) == list(post)
    for k, t in post.items():
        assert got[k].dtype == t.numpy().dtype and got[k].flags.owndata, k
        assert np.array_equal(got[k], t.numpy()), k


def test_steps_bucket():
    """The tick graphs' preintegration chunks for the longest interval's
    sample count: one at least (the head), then one per 16 samples."""
    assert [test_._preint_chunks(n) for n in (0, 1, 13, 16, 17, 40, 512)] \
        == [1, 1, 1, 1, 2, 3, 32]
