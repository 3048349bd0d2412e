"""Parity: the port's monocular initialization fallback (`init/sfm`,
`alignment.linear_alignment`, `Estimator._try_initialize_mono`) and online
camera-IMU rotation calibration (`init/ex_rotation`,
`relative_pose.solve_relative_rotation`, `Estimator._ex_rotation_step`)
against the JAX package, float32 inputs built on both sides.

Decisions exact: ok flags, the essential matrix's twin choice,
`find_frame_l`'s l, the calibration's acceptance tick and init True/False.
Floats: R and t within 1e-4; linear_alignment's g, v, s within rtol 1e-4;
construct's poses within 1e-3; the calibrated q within 1e-4 up to sign; the
window after the mono init (P, V, Q) within 2e-3, the tolerance the JAX
package allows between its own two paths (tests/test_fused_tick.py:66-67).
The drives are tests/test_estimator.py's mono and extrinsic ones
(tests/synth_np.estimator_drive); the port's whole drives are held to that
test's own gates.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import synth_np
from torch_parity import estimator_to_torch, np_f32, rel_err
from synth import simulate_trajectory
from esvio_tpu.core import lie as jlie
from esvio_tpu.imu import preintegration as jpre
from esvio_tpu.init import alignment as jal
from esvio_tpu.init import ex_rotation as jex
from esvio_tpu.init import relative_pose as jrp
from esvio_tpu.init import sfm as jsfm
from esvio_tpu.vio import estimator as jest
from esvio_tpu_torch.core import lie as tlie
from esvio_tpu_torch.core import prng
from esvio_tpu_torch.init import alignment as tal
from esvio_tpu_torch.init import ex_rotation as tex
from esvio_tpu_torch.init import relative_pose as trp
from esvio_tpu_torch.init import sfm as tsfm
from esvio_tpu_torch.vio import estimator as test_


def _two_view(rng, n=60, t21=(0.4, 0.1, -0.05), noise=2e-4):
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 10, n)], -1)
    R21 = synth_np.so3_exp(np.array([0.05, -0.08, 0.03]))
    X2 = pts @ R21.T + np.asarray(t21)
    p1 = pts[:, :2] / pts[:, 2:3] + rng.normal(0, noise, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:3] + rng.normal(0, noise, (n, 2))
    return np_f32(p1), np_f32(p2), R21


def _both(*arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.tensor(a) for a in arrays))


@pytest.mark.parametrize("seed,outliers", [(0, 0), (3, 16), (1, 0)])
def test_solve_relative_rt_matches(seed, outliers):
    """Seed 1's scene defeats the JAX package's RANSAC (no inliers): the
    port must fail it too; where both succeed, the same pose."""
    rng = np.random.default_rng(seed)
    p1, p2, _ = _two_view(rng, n=80)
    if outliers:
        bad = rng.choice(80, outliers, replace=False)
        p2[bad] += np_f32(rng.normal(0, 0.2, (outliers, 2)))
    valid = np.ones(80, bool)
    valid[-5:] = False
    ja, ta = _both(p1, p2, valid)
    jo = jrp.solve_relative_rt(jax.random.PRNGKey(seed), *ja)
    to = trp.solve_relative_rt(prng.PRNGKey(seed), *ta)
    assert bool(jo[0]) == bool(to[0]) == (seed != 1)
    assert int(jo[3]) == int(to[3])
    if bool(jo[0]):
        np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=1e-4)
        np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_relative_rotation_matches(seed):
    """Consecutive frames (near-zero translation): the twin of the larger
    trace, chosen as the JAX function chooses it."""
    rng = np.random.default_rng(seed)
    p1, p2, R21 = _two_view(rng, n=40, t21=(0.004, -0.002, 0.001))
    valid = np.ones(40, bool)
    ja, ta = _both(p1, p2, valid)
    jok, jR = jrp.solve_relative_rotation(jax.random.PRNGKey(seed), *ja)
    tok, tR = trp.solve_relative_rotation(prng.PRNGKey(seed), *ta)
    assert bool(jok) == bool(tok)
    # the twin: the decompositions' labels R1/R2 depend on the SVD's signs,
    # so the choice is held by value: both sides take the larger trace of
    # the same pair of twins
    jE, _ = jrp.essential_ransac(jax.random.PRNGKey(seed), *ja)
    tE, _ = trp.essential_ransac(prng.PRNGKey(seed), *ta)
    jtr = sorted(float(jnp.trace(R)) for R in jrp.decompose_essential(jE)[:2])
    ttr = sorted(float(torch.trace(R)) for R in trp.decompose_essential(tE)[:2])
    np.testing.assert_allclose(ttr, jtr, atol=1e-4)
    assert abs(float(np.trace(np.asarray(jR))) - jtr[1]) < 1e-5
    assert abs(float(torch.trace(tR)) - ttr[1]) < 1e-5
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    ang = np.degrees(np.arccos(np.clip((np.trace(tR.numpy() @ R21) - 1) / 2,
                                       -1, 1)))
    assert ang < 1.0, ang


def _alignment_inputs(seed):
    """tests/test_init.py's mono alignment problem in float32: the
    preintegrated intervals of a simulated trajectory and the camera
    positions in a visual frame scaled by 1/4."""
    traj = simulate_trajectory(np.random.default_rng(seed), n_frames=11)
    F, ipf = len(traj["P"]), traj["imu_per_frame"]
    dts = np.full((F - 1, ipf), traj["dt"])
    accs = np.stack([traj["imu_acc"][k * ipf + 1:(k + 1) * ipf + 1]
                     for k in range(F - 1)])
    gyrs = np.stack([traj["imu_gyr"][k * ipf + 1:(k + 1) * ipf + 1]
                     for k in range(F - 1)])
    a0 = np.stack([traj["imu_acc"][k * ipf] for k in range(F - 1)])
    g0 = np.stack([traj["imu_gyr"][k * ipf] for k in range(F - 1)])
    f32 = lambda a: jnp.asarray(np_f32(a))
    pres = jpre.preintegrate_batch(
        f32(dts), f32(accs), f32(gyrs), f32(a0), f32(g0),
        f32(np.zeros((F - 1, 3))), f32(np.zeros((F - 1, 3))),
        jpre.make_imu_params(dtype=jnp.float32), jnp.ones((F - 1, ipf), bool))
    Rs = np.stack([synth_np.quat_to_rot(q) for q in traj["Q"]])
    tic = np.array([0.05, -0.02, 0.01])
    T_cam = (traj["P"] + np.einsum("fij,j->fi", Rs, tic)) / 4.0
    return [np_f32(a) for a in (Rs, T_cam, pres.delta_p, pres.delta_v,
                                pres.sum_dt, tic)], traj


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_alignment_matches(seed):
    args, traj = _alignment_inputs(seed)
    jok, jg, jv, js = jal.linear_alignment(*(jnp.asarray(a) for a in args),
                                           9.80766)
    tok, tg, tv, ts = tal.linear_alignment(*(torch.tensor(a) for a in args),
                                           9.80766)
    assert bool(jok) == bool(tok)
    # rtol relative to each vector's largest component (g's x and y are
    # ~1e-4 of its z)
    assert rel_err(tg.numpy(), jg) < 1e-4
    assert rel_err(tv.numpy(), jv) < 1e-4
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)
    assert abs(float(ts) - 4.0) < 0.1             # and it finds the scale


def _sfm_problem(seed):
    """tests/test_init.py::test_global_sfm's scene: 8 frames, 50 landmarks
    (body = camera), obs (L, F, 2) float32."""
    rng = np.random.default_rng(seed)
    traj = simulate_trajectory(rng, n_frames=8)
    n_lm = 50
    lms = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-3, 3, n_lm),
                    rng.uniform(4, 9, n_lm)], -1)
    F = len(traj["P"])
    obs = np.zeros((n_lm, F, 2))
    vis = np.zeros((n_lm, F), bool)
    for f in range(F):
        pc = (lms - traj["P"][f]) @ synth_np.quat_to_rot(traj["Q"][f])
        obs[:, f] = pc[:, :2] / pc[:, 2:3]
        vis[:, f] = pc[:, 2] > 0.1
    return np_f32(obs), vis


@pytest.mark.parametrize("seed", [0, 3])
def test_global_sfm_matches(seed):
    obs, mask = _sfm_problem(seed)
    jl, jR, jt = jsfm.find_frame_l(jax.random.PRNGKey(3), obs, mask,
                                   parallax_px=1.0)
    tl, tR, tt = tsfm.find_frame_l(prng.PRNGKey(3), obs, mask, parallax_px=1.0)
    assert jl is not None and tl == jl
    np.testing.assert_allclose(tR, jR, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    # construct from the same relative pose on both sides
    jo = jsfm.construct(jax.random.PRNGKey(3), obs, mask, jl, jR, jt)
    to = tsfm.construct(prng.PRNGKey(3), obs, mask, jl, jR, jt)
    assert jo[0] and to[0]
    np.testing.assert_array_equal(to[4], jo[4])
    np.testing.assert_allclose(to[1], jo[1], atol=1e-3)
    np.testing.assert_allclose(to[2], jo[2], atol=1e-3)
    np.testing.assert_allclose(to[3][to[4]], jo[3][jo[4]], atol=1e-3)


def _calib_pairs(rng, N, axis_only=False):
    q_bc = synth_np.EX_CALIB_Q_BC
    R_bc = synth_np.quat_to_rot(q_bc)
    q_imu, q_cam = [], []
    for _ in range(N):
        w = rng.normal(0, 0.3, 3)
        if axis_only:
            w[:2] = 0.0
        Rb = synth_np.so3_exp(w)
        q_imu.append(synth_np._rot_to_quat(Rb))
        q_cam.append(synth_np._rot_to_quat(R_bc.T @ Rb @ R_bc))
    return np_f32(np.stack(q_cam)), np_f32(np.stack(q_imu))


@pytest.mark.parametrize("case", ["full", "masked", "single_axis", "few"])
def test_calibrate_ex_rotation_matches(case):
    rng = np.random.default_rng(4)
    N = {"few": 9}.get(case, 32)
    q_cam, q_imu = _calib_pairs(rng, N, axis_only=case == "single_axis")
    if case == "masked":
        q_cam[20:] = np_f32([1, 0, 0, 0])
        q_imu[20:] = np_f32([1, 0, 0, 0])
    valid = np.arange(N) < (20 if case == "masked" else N)
    ric0 = np_f32([1, 0, 0, 0])
    jq, jok, jS = jex.calibrate_ex_rotation(
        *(jnp.asarray(a) for a in (q_cam, q_imu, ric0)),
        valid=jnp.asarray(valid))
    tq, tok, tS = tex.calibrate_ex_rotation(
        *(torch.tensor(a) for a in (q_cam, q_imu, ric0)),
        valid=torch.tensor(valid))
    assert bool(jok) == bool(tok) == (case in ("full", "masked"))
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), rtol=1e-3, atol=1e-5)
    if bool(jok):
        s = np.sign(float(np.dot(tq.numpy(), np.asarray(jq))))
        np.testing.assert_allclose(s * tq.numpy(), np.asarray(jq), atol=1e-4)


def test_quat_left_right_match():
    q = np_f32(np.random.default_rng(0).normal(size=(5, 4)))
    np.testing.assert_allclose(tlie.quat_left(torch.tensor(q)).numpy(),
                               np.asarray(jlie.quat_left(jnp.asarray(q))),
                               atol=1e-7)
    np.testing.assert_allclose(tlie.quat_right(torch.tensor(q)).numpy(),
                               np.asarray(jlie.quat_right(jnp.asarray(q))),
                               atol=1e-7)


# ------------------------------------------------------------ estimator


def _jax_estimator(ex_p, ex_q, cfg_kw):
    return jest.Estimator(jest.EstimatorConfig(fused=False, **cfg_kw), ex_p,
                          ex_q)


def test_mono_init_from_jax_state():
    """The mono drive (stereo off) on the JAX estimator up to its init tick;
    there the stereo bootstrap fails on both sides, and the port, copied
    from the JAX estimator at that moment, initializes through its mono
    fallback as the JAX one does: the same decisions and the same window."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("mono", 11)
    je = _jax_estimator(ex_p, ex_q, cfg_kw)
    seen = {}
    real_stereo, real_mono = je._try_initialize, je._try_initialize_mono

    def stereo():
        te = estimator_to_torch(je)
        seen["stereo"] = (real_stereo(), te._try_initialize())
        seen["te"] = te
        return seen["stereo"][0]

    def mono():
        te = seen["te"]
        book, _ = te._loop_book()
        obs = book.un.numpy()
        mask = book.obs.numpy() & book.active.numpy()[:, None]
        seed = int(je.timestamps[0] * 1e3) & 0x7FFFFFFF
        seen["l"] = (jsfm.find_frame_l(jax.random.PRNGKey(seed), obs, mask)[0],
                     tsfm.find_frame_l(prng.PRNGKey(seed), obs, mask)[0])
        seen["mono"] = (real_mono(), te._try_initialize_mono())
        return seen["mono"][0]

    je._try_initialize, je._try_initialize_mono = stereo, mono
    je._triangulate = lambda: (_ for _ in ()).throw(StopIteration)
    for f, pkt in enumerate(packets):
        if f > 0:
            synth_np.feed_imu(je, traj, f)
        try:
            je.process_packets(traj["t"][f], pkt)
        except StopIteration:          # initialized: stop before its solve
            break
    assert f == test_.WINDOW and je.solver_flag == "NON_LINEAR"
    assert seen["stereo"] == (False, False)
    assert seen["l"][0] is not None and seen["l"][0] == seen["l"][1]
    assert seen["mono"] == (True, True)
    te = seen["te"]
    for name, tol in (("P", 2e-3), ("V", 2e-3), ("Q", 2e-3), ("Bg", 1e-4),
                      ("Ba", 0.0)):
        np.testing.assert_allclose(getattr(te.ws, name).numpy(),
                                   np.asarray(getattr(je.ws, name)), atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("require_stable", [False, True])
def test_ex_rotation_drive_matches_jax(require_stable):
    """The extrinsic drive (identity guess ~16° off) on both estimators in
    lock step up to the init tick: the same calibration pairs, the same
    acceptance tick, the same calibrated rotation, and both initialize on
    that tick (stopped there, before the window solve).  With
    ex_calib_require_stable the scale-invariant gate waits for 3
    consecutive solves within 1°: the same stability counts and candidates
    on every tick."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("ex_rotation")
    cfg_kw["ex_calib_require_stable"] = require_stable
    je = _jax_estimator(ex_p, ex_q, cfg_kw)
    te = test_.Estimator(test_.EstimatorConfig(fused=False, **cfg_kw), ex_p,
                         ex_q, "cpu")
    stop = lambda: (_ for _ in ()).throw(StopIteration)
    je._triangulate = te._triangulate = stop
    done = {"j": None, "t": None}
    stable_seen = []
    for f, pkt in enumerate(packets):
        flags = {}
        for k, e in (("j", je), ("t", te)):
            if f > 0:
                synth_np.feed_imu(e, traj, f)
            try:
                e.process_packets(traj["t"][f], pkt)
            except StopIteration:
                pass
            flags[k] = e.solver_flag
            if e._ex_calib_done and done[k] is None:
                done[k] = f
        assert len(je._calib_pairs) == len(te._calib_pairs), f
        for (jc, ji), (tc, ti) in zip(je._calib_pairs, te._calib_pairs):
            # one 50 ms interval's essential-matrix rotation, in float32
            s = np.sign(float(np.dot(jc, tc)))
            np.testing.assert_allclose(s * tc, jc, atol=1e-3)
            np.testing.assert_allclose(ti, ji, atol=1e-5)
        assert flags["j"] == flags["t"], f
        assert je._ex_calib_stable == te._ex_calib_stable, f
        assert (je._ex_calib_last_q is None) == (te._ex_calib_last_q is None)
        if je._ex_calib_last_q is not None:
            stable_seen.append(je._ex_calib_stable)
            jl, tl = je._ex_calib_last_q, te._ex_calib_last_q
            np.testing.assert_allclose(np.sign(float(jl @ tl)) * tl, jl,
                                       atol=1e-3)
        if flags["j"] == "NON_LINEAR" or (require_stable
                                          and done["j"] is not None):
            break
    # the acceptance tick; without the stability window both initialize on
    # it (with it, the drive stops there)
    assert done["j"] is not None and done["j"] == done["t"] == f
    # the stability window ran (and only with the option on)
    assert bool(stable_seen) == require_stable, stable_seen
    # the drive's calibrated rotations: their pairs differ by the float32
    # essential matrices above, so within 1e-3; the hand-eye solve itself
    # on the JAX side's pairs within 1e-4
    jq, tq = np.asarray(je.ws.ex_q[1]), te.ws.ex_q[1].numpy()
    np.testing.assert_allclose(np.sign(float(jq @ tq)) * tq, jq, atol=1e-3)
    qc, qi = (np_f32(np.stack([p[i] for p in je._calib_pairs]))
              for i in (0, 1))
    args = (qc, qi, np_f32([1, 0, 0, 0]))
    jq2 = jex.calibrate_ex_rotation(*(jnp.asarray(a) for a in args))[0]
    tq2 = tex.calibrate_ex_rotation(*(torch.tensor(a) for a in args))[0]
    np.testing.assert_allclose(tq2.numpy(), np.asarray(jq2), atol=1e-4)
    if not require_stable:   # else the Huber weights came from a candidate
        np.testing.assert_allclose(np.asarray(jq2), jq, atol=1e-6)


def _angle_deg(q, q_ref):
    from esvio_tpu_torch.core import lie_np
    d = lie_np.quat_mul(np.array([q[0], -q[1], -q[2], -q[3]]), q_ref)
    return 2 * np.degrees(np.arctan2(np.linalg.norm(d[1:]), abs(d[0])))


def test_port_mono_drive():
    """tests/test_estimator.py::test_mono_init_fallback on the port's fused
    default: NON_LINEAR through the mono fallback, the last frame within the
    test's 0.4 m."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("mono")
    est = test_.Estimator(test_.EstimatorConfig(**cfg_kw), ex_p, ex_q, "cpu")
    calls = []
    real = est._try_initialize_mono
    est._try_initialize_mono = lambda: calls.append(real()) or calls[-1]
    outs = []
    for f, pkt in enumerate(packets):
        if f > 0:
            synth_np.feed_imu(est, traj, f)
        outs.append(est.process_packets(traj["t"][f], pkt))
    assert True in calls and outs[-1].solver_flag == "NON_LINEAR"
    assert np.linalg.norm(outs[-1].P - traj["P"][-1]) < 0.4


def test_port_ex_rotation_drive():
    """tests/test_estimator.py::test_online_ex_rotation_calibration on the
    port's fused default: calibrated within 6° of the truth, NON_LINEAR only
    after the calibration, and the steady ticks on the fused path read the
    calibrated extrinsic."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("ex_rotation")
    est = test_.Estimator(test_.EstimatorConfig(**cfg_kw), ex_p, ex_q, "cpu")
    assert not est._ex_calib_done
    fused = []
    real = est._process_packets_fused
    est._process_packets_fused = lambda *a: fused.append(
        est.ws.ex_q[1].numpy().copy()) or real(*a)
    done_at, first_nl = None, None
    for f, pkt in enumerate(packets):
        if f > 0:
            synth_np.feed_imu(est, traj, f)
        out = est.process_packets(traj["t"][f], pkt)
        if est._ex_calib_done and done_at is None:
            done_at = f
            q_acc = est.ws.ex_q[1].numpy().copy()
        if out.solver_flag == "NON_LINEAR" and first_nl is None:
            first_nl = f
    assert done_at is not None and first_nl is not None and first_nl >= done_at
    assert _angle_deg(est.ws.ex_q[1].numpy().astype(float),
                      synth_np.EX_CALIB_Q_BC) < 6.0
    assert fused and _angle_deg(fused[0].astype(float), q_acc.astype(float)) < 1.0


def test_synth_np_matches_the_estimator_drives():
    """synth_np's trajectory, landmarks and packets against tests/synth.py
    and tests/test_estimator.py's helpers on the mono drive's seed."""
    from test_estimator import make_world, packet_for_frame
    a = simulate_trajectory(np.random.default_rng(7), n_frames=6,
                            imu_per_frame=10, frame_dt=0.05)
    b = synth_np.simulate_trajectory(np.random.default_rng(7), n_frames=6,
                                     imu_per_frame=10, frame_dt=0.05)
    for k in ("P", "Q", "V", "t", "imu_acc", "imu_gyr"):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-12, err_msg=k)
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    la, lb = make_world(ra, a), synth_np.make_world(rb, b)
    np.testing.assert_allclose(lb, la, atol=1e-12)
    pa, _ = packet_for_frame(a, 3, la, set(), 0.3 / 460.0, ra)
    pb, _ = synth_np.packet_for_frame(b, 3, lb, set(), 0.3 / 460.0, rb)
    np.testing.assert_array_equal(pb.ids, pa.ids)
    np.testing.assert_allclose(pb.un, pa.un, atol=1e-12)
    np.testing.assert_allclose(pb.un_right, pa.un_right, atol=1e-12)
