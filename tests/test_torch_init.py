"""Parity: the port's monocular initialization fallback (`init/sfm`,
`alignment.linear_alignment`) and online camera-IMU rotation calibration
(`init/ex_rotation`, `relative_pose.solve_relative_rotation`) against the
JAX package, function by function, float32 inputs built on both sides.
The estimator drives that run them are in test_torch_init_drives.py and
test_torch_init_ex_rotation.py.

Decisions exact: ok flags, the essential matrix's twin choice,
`find_frame_l`'s l.  Floats: R and t within 1e-4; linear_alignment's g, v,
s within rtol 1e-4; construct's poses within 1e-3; the calibrated q within
1e-4 up to sign.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import synth_np
from torch_parity import np_f32, rel_err
from synth import simulate_trajectory
from esvio_tpu.core import lie as jlie
from esvio_tpu.imu import preintegration as jpre
from esvio_tpu.init import alignment as jal
from esvio_tpu.init import ex_rotation as jex
from esvio_tpu.init import relative_pose as jrp
from esvio_tpu.init import sfm as jsfm
from esvio_tpu_torch.core import lie as tlie
from esvio_tpu_torch.core import prng
from esvio_tpu_torch.init import alignment as tal
from esvio_tpu_torch.init import ex_rotation as tex
from esvio_tpu_torch.init import relative_pose as trp
from esvio_tpu_torch.init import sfm as tsfm


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
