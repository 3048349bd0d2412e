"""Parity: esvio_tpu_torch.vio (feature manager, stereo initialization,
the estimator's general path) and esvio_tpu_torch.init against the JAX
package, float32 on both sides, on the synthetic drive of
tests/test_estimator.py::test_esio_end_to_end with the JAX side at
fused=False.

Tolerances: solver flags, marginalization flags, book masks and counts
exact; one tick started from the JAX estimator's own NON_LINEAR state
within 1e-4 m; over the whole drive P within 2e-3 m, the tolerance that
tests/test_fused_tick.py:66-67 allows between the JAX package's own two
paths.  The port takes the marginalization's eigendecompositions in
float64 (see test_torch_solver.py), so the JAX side of the drive does too
(torch_parity.jax_marginalization_f64); triangulated depths and world
points within 1e-4 relative; the init solvers within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_parity import (estimator_to_torch, jax_marginalization_f64, np_f32,
                          rel_err, to_torch)
from test_estimator import BASELINE, make_world, packet_for_frame
from synth import simulate_trajectory
from esvio_tpu.init import alignment as jal
from esvio_tpu.init import pnp as jpnp
from esvio_tpu.init import relative_pose as jrp
from esvio_tpu.vio import estimator as jest
from esvio_tpu.vio import feature_manager as jfm
from esvio_tpu_torch.core import prng
from esvio_tpu_torch.init import alignment as tal
from esvio_tpu_torch.init import pnp as tpnp
from esvio_tpu_torch.init import relative_pose as trp
from esvio_tpu_torch.solver import window as twin
from esvio_tpu_torch.vio import estimator as test_
from esvio_tpu_torch.vio import feature_manager as tfm

N_FRAMES = 24
SNAP = 15          # the JAX state after this frame seeds a port estimator


@pytest.fixture(scope="module")
def drive():
    """Both estimators over the same packets; at frame SNAP a third, port
    estimator is cloned from the JAX one and runs the next tick."""
    with jax_marginalization_f64():
        return _drive()


def _drive():
    rng = np.random.default_rng(3)
    traj = simulate_trajectory(rng, n_frames=N_FRAMES, imu_per_frame=10,
                               frame_dt=0.05)
    lms = make_world(rng, traj)
    ex_p = np.array([[0, 0, 0], [0, 0, 0], [BASELINE, 0, 0], [BASELINE, 0, 0]],
                    float)
    ex_q = np.tile(np.array([1.0, 0, 0, 0]), (4, 1))
    kw = dict(mode="esio", evt_capacity=128, img_capacity=8, min_track_for_kf=15)
    je = jest.Estimator(jest.EstimatorConfig(fused=False, **kw), ex_p, ex_q)
    te = test_.Estimator(test_.EstimatorConfig(fused=False, **kw), ex_p, ex_q,
                         "cpu")
    out = dict(j=[], t=[], traj=traj)
    seen = set()
    k_imu = traj["imu_per_frame"]
    for f in range(N_FRAMES):
        if f > 0:
            for s in range(k_imu):
                i = (f - 1) * k_imu + s + 1
                for e in (je, te):
                    e.process_imu(traj["dt"], traj["imu_acc"][i],
                                  traj["imu_gyr"][i])
        pkt, seen = packet_for_frame(traj, f, lms, seen, 0.3 / 460.0, rng)
        if f == SNAP + 1:
            clone = estimator_to_torch(je)
            out["book"] = (je.book_evt, je.ws, pkt)
            out["clone"] = clone.process_packets(traj["t"][f], pkt)
        out["j"].append(je.process_packets(traj["t"][f], pkt))
        out["t"].append(te.process_packets(traj["t"][f], pkt))
    return out


def test_estimator_drive_matches_general_path(drive):
    jf = [o.solver_flag for o in drive["j"]]
    tf = [o.solver_flag for o in drive["t"]]
    assert jf == tf and "NON_LINEAR" in tf
    assert [o.marg_flag for o in drive["j"]] == [o.marg_flag for o in drive["t"]]
    dP = max(np.abs(a.P - b.P).max() for a, b in zip(drive["j"], drive["t"]))
    assert dP < 2e-3, dP
    # and the port is as accurate as the reference on this drive
    first = tf.index("NON_LINEAR")
    err = {k: max(np.linalg.norm(o.P - drive["traj"]["P"][f])
                  for f, o in enumerate(drive[k]) if f >= first)
           for k in ("j", "t")}
    assert err["t"] <= 1.2 * err["j"] + 1e-3, err


def test_one_tick_from_jax_nonlinear_state(drive):
    j, c = drive["j"][SNAP + 1], drive["clone"]
    assert c.solver_flag == j.solver_flag == "NON_LINEAR"
    assert c.marg_flag == j.marg_flag
    np.testing.assert_allclose(c.P, j.P, atol=1e-4)
    np.testing.assert_allclose(c.V, j.V, atol=1e-3)


def test_feature_manager_functions_match(drive):
    jbook, jws, pkt = drive["book"]
    tbook = to_torch(jbook, twin.FeatureBook)
    tws = to_torch(jws, twin.WindowState)
    Rrl, Trl = np.eye(3, dtype=np.float32), np_f32([-BASELINE, 0, 0])
    # insertion of the next packet
    args = (np.asarray(pkt.ids, np.int32), np.asarray(pkt.valid),
            np_f32(pkt.un), np_f32(pkt.vel), np.asarray(pkt.right_valid),
            np_f32(pkt.un_right), np_f32(pkt.vel_right), np.float32(0.0))
    fc = twin.WINDOW
    jb, jn, jd = jfm.insert_packet(jbook, *(jnp.asarray(a) for a in args), fc)
    tb, tn, td = tfm.insert_packet(tbook, *(torch.tensor(a) for a in args), fc)
    assert int(jn) == int(tn) and int(jd) == int(td)
    for f in dataclasses.fields(tb):
        a, b = np.asarray(getattr(jb, f.name)), getattr(tb, f.name).numpy()
        assert np.array_equal(a, b) if a.dtype.kind in "biu" else \
            np.allclose(a, b, atol=1e-6), f.name
    jp, jnum = jfm.mean_parallax(jb, fc)
    tp, tnum = tfm.mean_parallax(tb, fc)
    assert int(jnum) == int(tnum)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    # triangulation, world points
    js = jfm.triangulate_stereo_instant(jb, jnp.asarray(Rrl), jnp.asarray(Trl))
    ts = tfm.triangulate_stereo_instant(tb, torch.tensor(Rrl), torch.tensor(Trl))
    jm = jfm.triangulate_multiview(js, jws, 1)
    tm = tfm.triangulate_multiview(ts, tws, 1)
    for a, b in ((js, ts), (jm, tm)):
        assert np.array_equal(np.asarray(a.depth_valid), b.depth_valid.numpy())
        assert rel_err(b.inv_depth.numpy(), a.inv_depth) < 1e-4
    jz = jfm.stereo_depth_table(jb.un, jb.un_r, jb.stereo, jnp.asarray(Rrl),
                                jnp.asarray(Trl))
    tz = tfm.stereo_depth_table(tb.un, tb.un_r, tb.stereo, torch.tensor(Rrl),
                                torch.tensor(Trl))
    assert np.array_equal(np.asarray(jz) > 0, tz.numpy() > 0)
    assert rel_err(tz.numpy(), jz) < 1e-4
    jw, jv = jfm.world_points(jm, jws, 1)
    tw, tv = tfm.world_points(tm, tws, 1)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert rel_err(tw.numpy()[tv.numpy()], np.asarray(jw)[np.asarray(jv)]) < 1e-4
    # slides and failure removal
    a = (jws.P[0], jws.Q[0], jws.P[1], jws.Q[1], jws.ex_p[1], jws.ex_q[1])
    jo = jfm.slide_old(jm, *a)
    to = tfm.slide_old(tm, *(torch.tensor(np.asarray(x)) for x in a))
    j2 = jfm.slide_second_new(jm, twin.N_STATES - 1)
    t2 = tfm.slide_second_new(tm, twin.N_STATES - 1)
    jr, tr = jfm.remove_failures(jm), tfm.remove_failures(tm)
    for jx, tx in ((jo, to), (j2, t2), (jr, tr)):
        for f in ("ids", "active", "obs", "stereo", "depth_valid"):
            assert np.array_equal(np.asarray(getattr(jx, f)),
                                  getattr(tx, f).numpy()), f
        np.testing.assert_allclose(tx.inv_depth.numpy(), np.asarray(jx.inv_depth),
                                   rtol=1e-4, atol=1e-6)


def _two_views(rng, n=60):
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 7, n)], -1)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.15, 0.02, 0.03])
    X2 = X @ R.T + t
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0, 2e-4, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 2e-4, (n, 2))
    depth = np.where(rng.random(n) < 0.8, X[:, 2], -1.0)
    return np_f32(p1), np_f32(p2), np_f32(depth), X, R, t


def test_solve_relative_hybrid_matches(rng):
    p1, p2, depth, *_ = _two_views(rng)
    valid = np.ones(len(p1), bool)
    seed = (3 * 9973 + 17) & 0x7FFFFFFF         # the estimator's key rule
    jo = jrp.solve_relative_hybrid(jax.random.PRNGKey(seed), *(jnp.asarray(a)
                                   for a in (p1, p2, depth, valid)))
    to = trp.solve_relative_hybrid(prng.PRNGKey(seed), *(torch.tensor(a)
                                   for a in (p1, p2, depth, valid)))
    assert bool(jo[0]) and bool(to[0]) and int(jo[3]) == int(to[3])
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=1e-4)
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), atol=1e-4)


def test_pnp_gn_matches(rng):
    _, p2, _, X, R, t = _two_views(rng, n=40)
    P, O, V = jpnp.pad_points(list(X), list(p2), min_size=64)
    Pt, Ot, Vt = tpnp.pad_points(list(X), list(p2), min_size=64)
    assert np.array_equal(P, Pt) and np.array_equal(O, Ot) and np.array_equal(V, Vt)
    c = -R.T @ t                                   # camera centre in world
    R0, t0 = np_f32(np.eye(3)), np_f32(c + 0.05)
    jR, jt, je = jpnp.pnp_gn(*(jnp.asarray(np_f32(a)) for a in (P, O)),
                             jnp.asarray(V), jnp.asarray(R0), jnp.asarray(t0),
                             iters=15)
    tR, tt, te = tpnp.pnp_gn(*(torch.tensor(np_f32(a)) for a in (P, O)),
                             torch.tensor(V), torch.tensor(R0), torch.tensor(t0),
                             iters=15)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-3, atol=1e-6)


def test_alignment_matches(rng):
    """Gyro bias and gravity/velocity alignment on a window of noisy
    rotations and IMU deltas."""
    from esvio_tpu.core import lie as jlie
    n = 11
    Rs = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.1, (n, 3)))))
    dq = np_f32(np.asarray(jlie.rot_to_quat(jnp.asarray(
        np.einsum("kji,kjl->kil", Rs[:-1], Rs[1:])
        @ np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.01, (n - 1, 3)))))))))
    J = np_f32(rng.normal(0, 0.05, (n - 1, 3, 3)))
    Rs = np_f32(Rs)
    jb = jal.solve_gyroscope_bias(jnp.asarray(Rs), jnp.asarray(J), jnp.asarray(dq))
    tb = tal.solve_gyroscope_bias(torch.tensor(Rs), torch.tensor(J), torch.tensor(dq))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    T = np_f32(np.cumsum(rng.normal(0, 0.05, (n, 3)), 0))
    dp = np_f32(rng.normal(0, 0.05, (n - 1, 3)))
    dv = np_f32(rng.normal(0, 0.1, (n - 1, 3)) + [0, 0, 0.5])
    dts = np_f32(np.full(n - 1, 0.05))
    tic = np_f32([0.0, 0.0, 0.0])
    args = (Rs, T, dp, dv, dts, tic)
    jo = jal.linear_alignment_with_depth(*(jnp.asarray(a) for a in args), 9.80766)
    to = tal.linear_alignment_with_depth(*(torch.tensor(a) for a in args), 9.80766)
    assert bool(jo[0]) == bool(to[0])
    for a, b in zip(jo[1:], to[1:]):
        assert rel_err(b.numpy(), a) < 1e-3


def test_null_vector_matches_svd(rng):
    """The triangulations' null vector (float64 power method on adj(AᵀA),
    free of host syncs) against float64 SVD on multi-view DLT systems with
    noise, and SVD's identity on a zero system."""
    n, views = 200, 6
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(1, 7, (n, 1)),
                        np.ones((n, 1))], 1)
    rows = []
    for _ in range(views):
        R = rng.normal(0, 0.05, 3)
        Rm = np.eye(3) + np.array([[0, -R[2], R[1]], [R[2], 0, -R[0]],
                                   [-R[1], R[0], 0]])
        P = np.concatenate([Rm, rng.uniform(-0.3, 0.3, (3, 1))], 1)
        x = X @ P.T
        u = x[:, :2] / x[:, 2:] + rng.normal(0, 1e-3, (n, 2))
        rows += [u[:, 0:1] * P[2] - P[0], u[:, 1:2] * P[2] - P[1]]
    A = np_f32(np.stack(rows, 1))
    v = tfm._null_vector(torch.tensor(A)).numpy().astype(np.float64)
    want = np.linalg.svd(A.astype(np.float64))[2][:, -1]
    assert np.abs(np.abs(np.sum(v * want, -1)) - 1).max() < 1e-6
    zero = tfm._null_vector(torch.zeros((2, 4, 4))).numpy()
    assert np.array_equal(zero, np.tile([0.0, 0.0, 0.0, 1.0], (2, 1)))
