"""Parity: the port's in-window relocalization (gauss_newton
`_relo_family`, `relo_residuals`, `solve_window_relo`; the estimator's
`set_relo_frame` → `_prepare_relo` → `_finish_relo` path) against the JAX
package on the CPU, float32 on both sides.

Tolerances:
  * relo_residuals: 1e-5 relative; solve_window_relo: one LM step within
    5e-5 (state, relo P and Q, costs 1e-4 relative), four within 1e-2, the
    tolerances of test_torch_solver.py's solve_window (the same gauge null
    space before any prior);
  * the estimator drive of test_torch_vio.py on the general path, with a
    relocalization registered mid-drive (the JAX side takes its
    marginalization's eigendecompositions in float64, as the port does,
    torch_parity.jax_marginalization_f64): the same ticks carry
    Output.relo, rel_t and rel_q (up to sign) within 2e-3, rel_yaw within
    2e-3 deg, and P within 2e-3 m over the drive;
  * the port's fused path on the same drive: the relocalization tick
    takes the general path (solve_window_relo), the steady ticks before
    and after it the fused one, and its P and Output.relo stay within 2e-3
    of the port's general path.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import jax_marginalization_f64, make_problem, rel_err
from test_estimator import BASELINE, make_world, packet_for_frame
from synth import simulate_trajectory
from esvio_tpu.core import lie as jlie
from esvio_tpu.solver import gauss_newton as jgn
from esvio_tpu.vio import estimator as jest
from esvio_tpu_torch.solver import gauss_newton as tgn
from esvio_tpu_torch.vio import estimator as test_

N_FRAMES = 18      # RELO_AT and two steady ticks after it
RELO_AT = 16        # the frame whose tick registers the relocalization
FEW_AT = 13         # a relocalization with too few matches (no feedback)


def _relo_inputs(targs, n=20, cap=64):
    """Relo rows on the problem's event book: n gated lanes as an 'old
    keyframe' at window frame 3's pose sees their landmarks, and the relo
    pose seeded 2 cm off it."""
    from esvio_tpu_torch.core import lie as tlie
    from esvio_tpu_torch.vio import feature_manager as tfm
    state, book_evt = targs[0], targs[2]
    gate = tgn._book_gate(book_evt).numpy()
    pts, ok = (a.numpy() for a in tfm.world_points(book_evt, state, 1))
    sel = np.nonzero(gate & ok)[0][:n]
    lanes = np.full(cap, -1, np.int64)
    lanes[:len(sel)] = sel
    # camera of frame 3 (event extrinsic 1): world → body → camera
    R_b = tlie.quat_to_rot(state.Q[3]).numpy().astype(np.float64)
    R_c = tlie.quat_to_rot(state.ex_q[1]).numpy().astype(np.float64)
    pb = (pts[sel] - state.P[3].numpy()) @ R_b
    pc = (pb - state.ex_p[1].numpy()) @ R_c
    obs = np.zeros((cap, 2), np.float32)
    obs[:len(sel)] = pc[:, :2] / pc[:, 2:]
    valid = np.arange(cap) < len(sel)
    rP = state.P[3].numpy() + np.float32([0.02, -0.01, 0.01])
    return rP, state.Q[3].numpy(), obs, lanes, valid


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def test_relo_residuals_match(problem):
    jargs, targs = problem
    rP, rQ, obs, lanes, valid = _relo_inputs(targs)
    jr = jgn.relo_residuals(jargs[0], jargs[2], 1, jnp.asarray(rP),
                            jnp.asarray(rQ), jnp.asarray(obs),
                            jnp.asarray(lanes.astype(np.int32)),
                            jnp.asarray(valid))
    tr = tgn.relo_residuals(targs[0], targs[2], 1, torch.from_numpy(rP),
                            torch.from_numpy(rQ), torch.from_numpy(obs),
                            torch.from_numpy(lanes), torch.from_numpy(valid))
    assert rel_err(tr.numpy(), jr) < 1e-5
    assert np.abs(np.asarray(jr)[valid]).max() > 0


@pytest.mark.parametrize("iters,atol", [(1, 5e-5), (4, 1e-2)])
def test_solve_window_relo_matches(problem, iters, atol):
    jargs, targs = problem
    rP, rQ, obs, lanes, valid = _relo_inputs(targs)
    jo = jgn.solve_window_relo(
        *jargs, jnp.asarray(rP), jnp.asarray(rQ), jnp.asarray(obs),
        jnp.asarray(lanes.astype(np.int32)), jnp.asarray(valid),
        relo_book="evt", iters=iters)
    to = tgn.solve_window_relo(
        *targs, torch.from_numpy(rP), torch.from_numpy(rQ),
        torch.from_numpy(obs), torch.from_numpy(lanes),
        torch.from_numpy(valid), relo_book="evt", iters=iters)
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]),
                               rtol=1e-4 if iters == 1 else 1e-3)
    for f in ("P", "Q", "V", "Ba", "Bg"):
        np.testing.assert_allclose(getattr(to[0], f).numpy(),
                                   np.asarray(getattr(jo[0], f)), atol=atol,
                                   err_msg=f)
    np.testing.assert_allclose(to[4].numpy(), np.asarray(jo[4]), atol=atol)
    np.testing.assert_allclose(to[5].numpy(), np.asarray(jo[5]), atol=atol)
    assert np.abs(to[4].numpy() - rP).max() > 1e-5      # the block moved
    if iters == 1:
        np.testing.assert_allclose(to[2].inv_depth.numpy(),
                                   np.asarray(jo[2].inv_depth), atol=2e-4)


def _old_keyframe_view(traj, f, lms, ids):
    """Normalized observations of landmarks `ids` from an 'old keyframe'
    near frame f's pose (5 cm and 1° away), and that pose."""
    R = np.asarray(jlie.quat_to_rot(jnp.asarray(traj["Q"][f], jnp.float64)))
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, np.deg2rad(1.0)])))
    R_old = R @ dR
    P_old = traj["P"][f] + np.array([0.05, -0.03, 0.0])
    pc = (lms[ids] - P_old) @ R_old
    q_old = np.asarray(jlie.rot_to_quat(jnp.asarray(R_old)))
    return pc[:, :2] / pc[:, 2:], P_old, q_old


def _drive(fused_port: bool):
    """test_torch_vio.py's drive through the port, and with fused_port=False
    through the JAX general path beside it, with two relocalizations
    registered: at FEW_AT with 7 matches (the PnP fallback, which needs 15
    inliers: no feedback) and at RELO_AT with the features of the frame
    three ticks back."""
    rng = np.random.default_rng(3)
    traj = simulate_trajectory(rng, n_frames=N_FRAMES, imu_per_frame=10,
                               frame_dt=0.05)
    lms = make_world(rng, traj)
    ex_p = np.array([[0, 0, 0], [0, 0, 0], [BASELINE, 0, 0], [BASELINE, 0, 0]],
                    float)
    ex_q = np.tile(np.array([1.0, 0, 0, 0]), (4, 1))
    kw = dict(mode="esio", evt_capacity=128, img_capacity=8, min_track_for_kf=15)
    je = None if fused_port else jest.Estimator(
        jest.EstimatorConfig(fused=False, **kw), ex_p, ex_q)
    te = test_.Estimator(test_.EstimatorConfig(fused=fused_port, **kw), ex_p,
                         ex_q, "cpu")
    paths = []
    fused_call = te._process_packets_fused

    def spy(*a, **k):
        paths[-1] = "fused"
        return fused_call(*a, **k)

    te._process_packets_fused = spy
    ests = (te,) if je is None else (je, te)
    out = dict(j=[], t=[], paths=paths, pkts={})
    seen = set()
    k_imu = traj["imu_per_frame"]
    for f in range(N_FRAMES):
        if f > 0:
            for s in range(k_imu):
                i = (f - 1) * k_imu + s + 1
                for e in ests:
                    e.process_imu(traj["dt"], traj["imu_acc"][i],
                                  traj["imu_gyr"][i])
        pkt, seen = packet_for_frame(traj, f, lms, seen, 0.3 / 460.0, rng)
        out["pkts"][f] = pkt
        for at, n in ((FEW_AT, 7), (RELO_AT, 40)):
            if f == at:
                back = out["pkts"][f - 3]
                ids = back.ids[back.valid][:n]
                un, P_old, q_old = _old_keyframe_view(traj, f - 3, lms, ids)
                for e in ests:
                    e.set_relo_frame(traj["t"][f - 3], ids, un, P_old, q_old)
        paths.append("general")
        n_relo = te.n_relo_solves
        if je is not None:
            out["j"].append(je.process_packets(traj["t"][f], pkt))
        out["t"].append(te.process_packets(traj["t"][f], pkt))
        if te.n_relo_solves > n_relo:
            paths[-1] = "relo"
    return out


@pytest.fixture(scope="module")
def drives():
    with jax_marginalization_f64():
        return _drive(False), _drive(True)


def _relo_ticks(outs):
    return [f for f, o in enumerate(outs) if o.relo is not None]


def test_estimator_relo_drive_matches_jax(drives):
    d = drives[0]
    assert [o.solver_flag for o in d["t"]] == [o.solver_flag for o in d["j"]]
    assert [o.marg_flag for o in d["t"]] == [o.marg_flag for o in d["j"]]
    assert _relo_ticks(d["t"]) == _relo_ticks(d["j"]) == [RELO_AT]
    assert d["paths"][FEW_AT] == "general" and d["paths"][RELO_AT] == "relo"
    jr, tr = d["j"][RELO_AT].relo, d["t"][RELO_AT].relo
    assert tr["stamp"] == jr["stamp"] and tr["frame_stamp"] == jr["frame_stamp"]
    np.testing.assert_allclose(tr["relative_t"], jr["relative_t"], atol=2e-3)
    sign = np.sign(np.dot(tr["relative_q"], jr["relative_q"]))
    np.testing.assert_allclose(sign * tr["relative_q"], jr["relative_q"],
                               atol=2e-3)
    assert abs(tr["relative_yaw"] - jr["relative_yaw"]) < 2e-3
    np.testing.assert_allclose(tr["P_old"], jr["P_old"], atol=2e-3)
    dP = max(np.abs(a.P - b.P).max() for a, b in zip(d["j"], d["t"]))
    assert dP < 2e-3, dP


def test_fused_drive_routes_the_relo_tick_to_the_general_path(drives):
    g, f = drives
    paths = f["paths"]
    assert paths[RELO_AT] == "relo"
    assert paths[FEW_AT] == "general"       # a pending relo skips the fused tick
    first = [o.solver_flag for o in f["t"]].index("NON_LINEAR") + 1
    steady = [k for k in range(first, N_FRAMES) if k not in (FEW_AT, RELO_AT)]
    assert all(paths[k] == "fused" for k in steady), paths
    assert paths[RELO_AT + 1] == "fused"
    assert _relo_ticks(f["t"]) == [RELO_AT]
    np.testing.assert_allclose(f["t"][RELO_AT].relo["relative_t"],
                               g["t"][RELO_AT].relo["relative_t"], atol=2e-3)
    dP = max(np.abs(a.P - b.P).max() for a, b in zip(g["t"], f["t"]))
    assert dP < 2e-3, dP
