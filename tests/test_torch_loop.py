"""Parity: the port's loop-closure subsystem (esvio_tpu_torch/loop and
init/pnp.pnp_ransac) against esvio_tpu on the CPU, the same numpy-seeded
inputs through both.

Tolerances:
  * detect_fast: xy, valid and scores exact (differences, minimums and
    maximums are exact in float32, ties go to the lower flat index);
  * describe: bits exact up to flips of tests whose two smoothed samples
    differ by float32 rounding (the 5-tap box filter's sum order);
    counted, at most 0.1 % of the bits;
  * match, KeyFrameDB add/query/save/load: exact on the same descriptors;
  * pnp_ransac: the hypothesis draws bit for bit with jax.random.randint,
    R and t within 1e-5, inliers exact;
  * optimize_4dof / optimize_4dof_cg in float32 on both sides: yaw within
    1e-3 deg and t within 1e-4 m of the JAX solve (the same GN steps in
    another float32 summation order);
  * the whole LoopCloser on 30 rendered keyframes: the same loops (i_old,
    j_new), match ids and inlier counts; db.t_opt, the drift and the
    corrected odometry within 2e-3 (the JAX closer runs its PnP and its
    graph in float64 under the suite's x64, the port in float32).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import np_f32
from synth import blob_texture, sample_texture
from esvio_tpu.core import camera as jcamera
from esvio_tpu.init import pnp as jpnp
from esvio_tpu.loop import brief as jbrief
from esvio_tpu.loop import fast as jfast
from esvio_tpu.loop import keyframe_db as jkdb
from esvio_tpu.loop import loop_closure as jlc
from esvio_tpu.loop import pose_graph as jpg
from esvio_tpu_torch.core import camera as tcamera
from esvio_tpu_torch.core import prng
from esvio_tpu_torch.init import pnp as tpnp
from esvio_tpu_torch.loop import brief as tbrief
from esvio_tpu_torch.loop import fast as tfast
from esvio_tpu_torch.loop import keyframe_db as tkdb
from esvio_tpu_torch.loop import loop_closure as tlc
from esvio_tpu_torch.loop import pose_graph as tpg

H, W = 180, 240               # tests/test_loop.py:13-15
FOCAL = 200.0
PLANE_Z = 5.0
T = lambda a, dt=None: torch.from_numpy(np.array(a, copy=True)) if dt is None \
    else torch.from_numpy(np.array(a, copy=True)).to(dt)


def _square():
    img = np.zeros((H, W), np.float32)
    img[60:120, 80:160] = 200.0
    return img


def _blob_image(seed=0, off=(0.0, 0.0)):
    tex, margin = blob_texture(np.random.default_rng(seed), H, W, n_blobs=200)
    return np_f32(sample_texture(tex, margin, H, W, *off))


@pytest.mark.parametrize("name,threshold,k", [("square", 20, 64),
                                              ("blobs", 15, 128)])
def test_detect_fast_matches(name, threshold, k):
    img = _square() if name == "square" else _blob_image()
    jxy, js, jok = (np.asarray(a) for a in jfast.detect_fast(
        jnp.asarray(img), threshold, k))
    txy, ts, tok = (a.numpy() for a in tfast.detect_fast(T(img), threshold, k))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(txy, jxy)
    np.testing.assert_array_equal(ts, js)
    assert tok.sum() >= 4


def _describe_both(img, xy, ok):
    jd = np.asarray(jbrief.describe(jnp.asarray(img), jnp.asarray(xy),
                                    jnp.asarray(ok)))
    td = tbrief.describe(T(img), T(xy), T(ok)).numpy()
    return jd, td


def test_describe_bits_match_up_to_counted_flips():
    img = _blob_image()
    xy, _, ok = (np.asarray(a) for a in jfast.detect_fast(jnp.asarray(img), 15, 128))
    # the FAST keypoints, and sub-pixel points off the pixel grid
    pts = np.concatenate([xy, xy[:64] + np.float32([0.37, -0.61])])
    oks = np.concatenate([ok, ok[:64]])
    jd, td = _describe_both(img, np_f32(pts), oks)
    assert jd.dtype == td.dtype == np.int8
    np.testing.assert_array_equal(td[~oks], 1)
    flips = int((jd != td).sum())
    print(f"BRIEF bit flips: {flips} of {jd[oks].size}")
    assert flips <= 1e-3 * jd[oks].size, flips


def test_match_indices_exact():
    img0 = _blob_image(0)
    img1 = _blob_image(0, off=(3.0, -2.0))
    xy, _, ok = (np.asarray(a) for a in jfast.detect_fast(jnp.asarray(img0), 15, 128))
    da = np.asarray(jbrief.describe(jnp.asarray(img0), jnp.asarray(xy), jnp.asarray(ok)))
    db = np.asarray(jbrief.describe(jnp.asarray(img1), jnp.asarray(xy - np_f32([3, -2])),
                                    jnp.asarray(ok)))
    vb = ok.copy()
    vb[::7] = False
    ji, jo = (np.asarray(a) for a in jbrief.match(
        jnp.asarray(da), jnp.asarray(ok), jnp.asarray(db), jnp.asarray(vb), 80))
    ti, to = (a.numpy() for a in tbrief.match(T(da), T(ok), T(db), T(vb), 80))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(
        tbrief.hamming_matrix(T(da), T(db)).numpy(),
        np.asarray(jbrief.hamming_matrix(jnp.asarray(da), jnp.asarray(db))))
    assert jo.sum() >= 15


def test_keyframe_db_add_query_save_load(tmp_path):
    """Both databases fed the same descriptors give the same candidates,
    vocabulary and tf-idf state, and survive save/load."""
    rng = np.random.default_rng(3)
    base = rng.choice([-1, 1], (6, 300, 256)).astype(np.int8)
    dbs = [jkdb.KeyFrameDB(capacity=8, n_window=16, n_extra=300, skip_recent=5),
           tkdb.KeyFrameDB(capacity=8, n_window=16, n_extra=300, skip_recent=5)]
    answers = [[], []]
    for k in range(24):
        place = base[k % 6].copy()
        flip = rng.random(place.shape) < 0.08
        place[flip] *= -1
        win = place[:16]
        args = (float(k), rng.normal(size=3), np.array([1.0, 0, 0, 0]),
                rng.normal(size=(16, 3)), rng.normal(size=(16, 2)), win,
                np.ones(16, bool), rng.normal(size=(300, 2)), place,
                rng.random(300) < 0.9)
        for db, ans in zip(dbs, answers):
            i = db.add(*args)
            ans.append(db.query(i))
    assert answers[0] == answers[1]
    assert sum(a is not None for a in answers[1]) >= 5, answers[1]
    assert dbs[1].capacity == 32              # grew past capacity twice
    np.testing.assert_array_equal(dbs[1].words, dbs[0].words)
    np.testing.assert_array_equal(dbs[1].df, dbs[0].df)
    for db, name in zip(dbs, ("jax", "port")):
        db.save(str(tmp_path / f"{name}.npz"))
    j2 = jkdb.KeyFrameDB.load(str(tmp_path / "jax.npz"), skip_recent=5)
    t2 = tkdb.KeyFrameDB.load(str(tmp_path / "port.npz"), skip_recent=5)
    for name in ("stamp", "t_vio", "win_desc", "ext_desc", "hist", "words"):
        np.testing.assert_array_equal(getattr(t2, name), getattr(j2, name))
    assert [t2.query(i) for i in range(t2.count)] == \
        [j2.query(i) for i in range(j2.count)]


def _pnp_problem(seed, n=48, n_out=12):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 7, n)], -1)
    R_true = np.asarray(jpg.lie.so3_exp(jnp.asarray([0.05, -0.08, 0.03])))
    c_true = np.array([0.2, -0.1, 0.3])
    pc = (pts - c_true) @ R_true.T
    obs = pc[:, :2] / pc[:, 2:]
    obs[:n_out] += rng.normal(0, 0.2, (n_out, 2))        # outliers
    valid = np.ones(n, bool)
    valid[-4:] = False
    return (np_f32(pts), np_f32(obs), valid, np_f32(np.eye(3)),
            np_f32(np.zeros(3)))


def test_pnp_ransac_draws_and_pose():
    pts, obs, valid, R0, t0 = _pnp_problem(0)
    jkey = jax.random.PRNGKey(7)
    tkey = prng.PRNGKey(7)
    n_valid = int(valid.sum())
    jd = np.asarray(jax.random.randint(jkey, (100, 6), 0, jnp.asarray(n_valid)))
    td = prng.randint(tkey, (100, 6), 0, torch.tensor(n_valid)).numpy()
    np.testing.assert_array_equal(td, jd)
    jR, jt, jinl = (np.asarray(a) for a in jpnp.pnp_ransac(
        jkey, jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid),
        jnp.asarray(R0), jnp.asarray(t0)))
    tR, tt, tinl = (a.numpy() for a in tpnp.pnp_ransac(
        tkey, T(pts), T(obs), T(valid), T(R0), T(t0)))
    np.testing.assert_array_equal(tinl, jinl)
    np.testing.assert_allclose(tR, jR, atol=1e-5)
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    assert tinl.sum() >= 30


def _graph_args_test_loop():
    """tests/test_loop.py:50-82's drifted line with 10 loop edges."""
    K, n = 64, 40
    yaw = np.zeros(K)
    t = np.zeros((K, 3))
    gt = np.zeros((K, 3))
    for k in range(1, n):
        gt[k] = gt[k - 1] + np.array([0.5, 0, 0])
        t[k] = gt[k] + np.array([0.012, 0.008, 0.0]) * k
    pairs = [(i, n - 10 + i) for i in range(10)]
    return (yaw, t, np.zeros(K), np.zeros(K), np.arange(K) < n, 0,
            np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs]),
            np.stack([gt[j] - gt[i] for i, j in pairs]), np.zeros(10),
            np.ones(10, bool))


def _graph_args_scale():
    """The 256-node problem of tests/test_pose_graph_scale.py:69-86."""
    from test_pose_graph_scale import _drifting_loop_problem, _pad_edges
    K = 256
    (_, _, t_vio, yaw_vio, li, lj, lt, ly) = _drifting_loop_problem(
        np.random.default_rng(0), K, n_loops=12)
    li, lj, lt, ly, lv = _pad_edges(li, lj, lt, ly, 32)
    return (yaw_vio, t_vio, np.zeros(K), np.zeros(K), np.ones(K, bool),
            int(li[lv].min()), li, lj, lt, ly, lv)


def _graph_both(args, solver, **kw):
    yaw, t, pitch, roll, valid, first, li, lj, lt, ly, lv = args
    f32 = lambda a: jnp.asarray(np_f32(a))
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))
    jy, jt = getattr(jpg, solver)(
        f32(yaw), f32(t), f32(pitch), f32(roll), jnp.asarray(valid),
        i32(first), i32(li), i32(lj), f32(lt), f32(ly), jnp.asarray(lv), **kw)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    ty, tt = getattr(tpg, solver)(
        T(np_f32(yaw)), T(np_f32(t)), T(np_f32(pitch)), T(np_f32(roll)),
        T(valid), i64(first), i64(li), i64(lj), T(np_f32(lt)), T(np_f32(ly)),
        T(lv), **kw)
    assert ty.dtype == torch.float32 and np.asarray(jy).dtype == np.float32
    return np.asarray(jy), np.asarray(jt), ty.numpy(), tt.numpy()


@pytest.mark.parametrize("problem", ["test_loop", "scale256"])
@pytest.mark.parametrize("solver,kw", [("optimize_4dof", dict(iters=5)),
                                       ("optimize_4dof_cg",
                                        dict(iters=5, cg_iters=400))])
def test_pose_graph_matches(problem, solver, kw):
    args = _graph_args_test_loop() if problem == "test_loop" \
        else _graph_args_scale()
    jy, jt, ty, tt = _graph_both(args, solver, **kw)
    dyaw = np.abs(((ty - jy) + 180.0) % 360.0 - 180.0).max()
    print(f"{solver} {problem}: yaw {dyaw:.3g} deg, t {np.abs(tt - jt).max():.3g} m, "
          f"moved {np.abs(jt - args[1]).max():.3g} m, yaw moved "
          f"{np.abs(jy - np_f32(args[0])).max():.3g} deg")
    assert dyaw < 1e-3, dyaw
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert np.abs(jt - args[1]).max() > 0.01          # the solve moved poses


def _render_keyframes(n_kf=30):
    """The 30 keyframes of tests/test_loop.py:139-177 (out and back over a
    blob plane), their window points taken from ONE detect_fast so that
    both closers see the same inputs."""
    tex, margin = blob_texture(np.random.default_rng(0), H * 3, W * 3,
                               n_blobs=1500)
    jcam = jcamera.make_pinhole(fx=FOCAL, fy=FOCAL, cx=W / 2, cy=H / 2,
                                width=W, height=H)
    xs = np.concatenate([np.linspace(0, 1.6, n_kf // 2),
                         np.linspace(1.6, 0.02, n_kf - n_kf // 2)])
    pos = np.stack([xs, np.zeros(n_kf), np.zeros(n_kf)], 1)
    frames = []
    for k in range(n_kf):
        img = sample_texture(tex, margin, H, W, pos[k][0] * FOCAL / PLANE_Z + W,
                             pos[k][1] * FOCAL / PLANE_Z + H)
        xy, _, ok = jfast.detect_fast(jnp.asarray(img), 15, 128)
        xy_n, okn = np.asarray(xy), np.asarray(ok)
        rays = np.asarray(jcamera.lift_projective(jcam, jnp.asarray(xy_n)))
        drift = np.array([0.01, 0.005, 0.0]) * k
        frames.append(dict(img=img, xy=xy_n, ok=okn, P=pos[k] + drift,
                           pts_w=pos[k] + drift + rays * PLANE_Z,
                           ids=np.arange(k * 1000, k * 1000 + len(xy_n),
                                         dtype=np.int32)))
    return frames, jcam


def test_loop_closer_subsystem_matches():
    frames, jcam = _render_keyframes()
    tcam = tcamera.make_pinhole(FOCAL, FOCAL, W / 2, H / 2, width=W, height=H)
    kw = dict(fast_threshold=15, max_extra_corners=256, skip_recent=10)
    jl = jlc.LoopCloser(jlc.LoopConfig(**kw), cam=jcam)
    tl = tlc.LoopCloser(tlc.LoopConfig(**kw), cam=tcam, device="cpu")
    q_id = np.array([1.0, 0, 0, 0])
    infos = [[], []]
    for k, f in enumerate(frames):
        for lc, out in ((jl, infos[0]), (tl, infos[1])):
            got = lc.add_keyframe(float(k), f["P"], q_id, f["pts_w"], f["xy"],
                                  f["ok"], f["img"], ids=f["ids"])
            if got:
                out.append(got)
    print("loops", [(i["i_old"], i["j_new"], i["n_inliers"]) for i in infos[1]])
    assert len(infos[0]) >= 1
    assert [(i["i_old"], i["j_new"]) for i in infos[1]] == \
        [(i["i_old"], i["j_new"]) for i in infos[0]]
    for ji, ti in zip(*infos):
        assert ti["n_inliers"] == ji["n_inliers"]
        np.testing.assert_array_equal(ti["match_ids"], ji["match_ids"])
        np.testing.assert_allclose(ti["match_un_old"], ji["match_un_old"], atol=1e-6)
        np.testing.assert_allclose(ti["rel_t"], ji["rel_t"], atol=2e-3)
        assert abs(ti["rel_yaw"] - ji["rel_yaw"]) < 2e-2
    n = jl.db.count
    assert tl.db.count == n and tl.n_optimize >= 1
    np.testing.assert_allclose(tl.db.t_opt[:n], jl.db.t_opt[:n], atol=2e-3)
    np.testing.assert_allclose(tl.r_drift, jl.r_drift, atol=2e-3)
    np.testing.assert_allclose(tl.t_drift, jl.t_drift, atol=2e-3)
    P = np.array([0.3, -0.2, 0.1])
    for a, b in zip(tl.correct_odometry(P, q_id), jl.correct_odometry(P, q_id)):
        np.testing.assert_allclose(a, b, atol=2e-3)


@pytest.mark.slow
def test_port_loop_pipeline_meets_e2e_gates():
    """The port's whole pipeline on tests/test_e2e_loops.py's sequence with
    loop closure, fast relocalization and motion correction (chip_smoke's
    phase 12, here on the CPU): that test's gates, and at least one tick
    through the in-window relocalization solve, as the JAX package takes
    on this configuration (tests/jax_golden_spread.py loops 1)."""
    from synth_np import loop_gates, loop_pipeline
    make_pipeline, seq, gt_t, gt_P = loop_pipeline("cpu", motion_correction=True)
    pipe = make_pipeline()
    res = pipe.run(seq)
    g = loop_gates(res, gt_t, gt_P)
    assert g["ok"], g
    assert pipe.estimator.n_relo_solves >= 1
