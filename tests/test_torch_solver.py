"""Parity: esvio_tpu_torch.solver (window algebra, normal equations,
kernel K2's plain version, the LM window solve, marginalization) against
esvio_tpu.solver, float32 on both sides.

Tolerances:
  * K2 / reduced_solve: relative error < 5e-5 against float64 numpy and
    against the JAX kernel in interpret mode and its XLA branch (the gate
    of tests/test_chol_pallas.py:39);
  * normal equations: 1e-4 relative to each block's largest entry (float32
    sums over ~10^4 factor rows taken in another order);
  * solve_window: one LM step within 5e-5, four within 1e-2 (the gauge
    null space before any prior amplifies float32 rounding, see the test);
  * marginalization: J0ᵀJ0 and J0ᵀr0 (J0 itself is only defined up to the
    eigenvector basis) within 5 % of the JAX package's float64 run — see
    test_marginalize_old_and_second_new_match for why not its float32
    run; lin and valid exact.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import assemble_cases as ac
from torch_parity import make_problem, np_f32, rel_err
from esvio_tpu.solver import chol_pallas
from esvio_tpu.solver import factors as jfac
from esvio_tpu.solver import gauss_newton as jgn
from esvio_tpu.solver import marginalization as jmarg
from esvio_tpu.solver import window as jwin
from esvio_tpu_torch.dist import dryrun
from esvio_tpu_torch.solver import chol_solve as tchol
from esvio_tpu_torch.solver import factors as tfac
from esvio_tpu_torch.solver import gauss_newton as tgn
from esvio_tpu_torch.solver import marginalization as tmarg
from esvio_tpu_torch.solver import window as twin


def _spd(seed, n_sys, jitter=50.0):
    """The SPD systems of tests/test_chol_pallas.py."""
    rng = np.random.default_rng(seed)
    n = chol_pallas.N
    G = rng.normal(0, 1, (n_sys, n, n)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", G, G) + jitter * np.eye(n, dtype=np.float32)
    b = rng.normal(0, 1, (n_sys, n)).astype(np.float32)
    lam = np.geomspace(1e-4, 10.0, n_sys).astype(np.float32)
    x_ref = np.stack([np.linalg.solve(
        (A[i] + lam[i] * np.eye(n)).astype(np.float64), b[i].astype(np.float64))
        for i in range(n_sys)])
    return A, b, lam, x_ref


def test_chol_solve_plain_matches_numpy_and_pallas_interpret():
    A, b, lam, x_ref = _spd(0, 4)
    x = tchol.chol_solve_batched(*(torch.tensor(a) for a in (A, b, lam))).numpy()
    assert rel_err(x, x_ref) < 5e-5
    xp = np.asarray(chol_pallas.chol_solve_batched(
        *(jnp.asarray(a) for a in (A, b, lam)), interpret=True))
    assert rel_err(x, xp) < 5e-5


def test_reduced_solve_matches_xla_branch_and_nan_contract():
    A, b, lam, _ = _spd(1, 2)
    for i in range(2):
        jdx, jfin = jgn.reduced_solve(jnp.asarray(A[i]), jnp.asarray(b[i]),
                                      float(lam[i]))
        tdx, tfin = tgn.reduced_solve(torch.tensor(A[i]), torch.tensor(b[i]),
                                      float(lam[i]))
        assert bool(jfin) and bool(tfin)
        assert rel_err(tdx.numpy(), jdx) < 5e-5
    # a non-SPD system: finite=False and a zero step, as in the JAX solver
    bad = A[0] - 500.0 * np.eye(A.shape[-1], dtype=np.float32)
    jdx, jfin = jgn.reduced_solve(jnp.asarray(bad), jnp.asarray(b[0]), 1e-4)
    tdx, tfin = tgn.reduced_solve(torch.tensor(bad), torch.tensor(b[0]), 1e-4)
    assert not bool(jfin) and not bool(tfin)
    assert not tdx.any()


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def test_window_algebra_matches(rng, problem):
    (jst, *_), (tst, *_) = problem
    dx = np_f32(rng.normal(0, 0.01, jwin.DIM_ALL))
    ja = jwin.apply_delta(jst, jnp.asarray(dx))
    ta = twin.apply_delta(tst, torch.tensor(dx))
    for f in ("P", "Q", "V", "Ba", "Bg", "ex_p", "ex_q"):
        np.testing.assert_allclose(getattr(ta, f).numpy(), np.asarray(getattr(ja, f)),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(twin.state_minus(ta, tst).numpy(),
                               np.asarray(jwin.state_minus(ja, jst)), atol=1e-5)
    jg = jwin.gauge_fix(ja, jst.P[0], jst.Q[0])
    tg = twin.gauge_fix(ta, tst.P[0], tst.Q[0])
    for f in ("P", "Q", "V"):
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                   atol=1e-5, err_msg=f)


def test_factor_jacobians_match(rng):
    L = 5
    v = lambda *s, sc=1.0: np_f32(rng.normal(0, sc, s))
    q = lambda: (lambda x: np_f32(x / np.linalg.norm(x, axis=-1, keepdims=True)))(
        rng.normal(size=(L, 4)) * [4, 1, 1, 1])
    args = (v(L, 3), q(), v(L, 3), q(), v(L, 3, sc=0.1), q(), v(L, 3, sc=0.1), q(),
            np_f32(rng.uniform(0.2, 0.5, L)), v(L, sc=0.01), v(L, 2, sc=0.2),
            v(L, 2, sc=0.1), v(L, sc=0.001), v(L, 2, sc=0.2), v(L, 2, sc=0.1),
            v(L, sc=0.001))
    jr, jJ = zip(*[jfac.proj22_jac(*(jnp.asarray(a[i]) for a in args))
                   for i in range(L)])
    tr, tJ = tfac.proj22_jac(*(torch.tensor(a) for a in args))
    assert rel_err(tr.numpy(), np.stack(jr)) < 1e-5
    assert rel_err(tJ.numpy(), np.stack(jJ)) < 1e-4


def _proj_rows(rng, L, case):
    """proj22_jac's arguments for L rows of one case."""
    v = lambda *s, sc=1.0: torch.tensor(np_f32(rng.normal(0, sc, s)))
    q = lambda: torch.tensor((lambda x: np_f32(
        x / np.linalg.norm(x, axis=-1, keepdims=True)))(
            rng.normal(size=(L, 4)) * [4, 1, 1, 1]))
    inv = np_f32(rng.uniform(1.5e-4, 1e-3, L) if case == "tiny_depth"
                 else rng.uniform(0.2, 0.5, L))
    args = [v(L, 3), q(), v(L, 3), q(), v(L, 3, sc=0.1), q(), v(L, 3, sc=0.1),
            q(), torch.tensor(inv), v(L, sc=0.01), v(L, 2, sc=0.2),
            v(L, 2, sc=0.1), v(L, sc=0.001), v(L, 2, sc=0.2), v(L, 2, sc=0.1),
            v(L, sc=0.001)]
    if case == "mono":          # ex1 := ex0
        args[6], args[7] = args[4], args[5]
    if case == "static":        # j := i, the right camera, td_j := td_i
        args[2], args[3], args[15] = args[0], args[1], args[12]
        args[13] = args[10] - 0.02
    return args


@pytest.mark.parametrize("case", ["random", "mono", "static", "tiny_depth",
                                  "masked_lanes", "imu"])
def test_closed_form_jacobians_match_forward_mode(rng, case):
    """Kernel K4's closed-form Jacobians (their plain mirrors in
    tests/assemble_cases.py) against the forward-mode ones within 1e-4
    relative: rows of the projection factor (random, mono with
    ex1 := ex0, static-stereo, inverse depth near the gate's 1e-4), a
    whole book's factor table with masked lanes (inactive, depth invalid,
    seen once, late start; the Cauchy weights, masks and mono fold
    applied), and the IMU factor off its linearization biases."""
    if case == "imu":
        st, _, _, pre, _, _, g = dryrun.make_problem(torch.float32, device="cpu")
        x = rng.normal(size=(twin.N_STATES, 4)) * [4, 1, 1, 1]
        st = dataclasses.replace(
            st, Q=torch.tensor(np_f32(x / np.linalg.norm(x, axis=-1, keepdims=True))),
            V=torch.tensor(np_f32(rng.normal(0, 1, (twin.N_STATES, 3)))),
            Ba=torch.tensor(np_f32(rng.normal(0, 0.05, (twin.N_STATES, 3)))),
            Bg=torch.tensor(np_f32(rng.normal(0, 0.02, (twin.N_STATES, 3)))))
        sq = tfac.imu_sqrt_info(pre.covariance)
        ins = tgn._imu_inputs(st)
        (r0, J0), (r1, J1) = (f(*ins, pre, g, sq) for f in (
            tfac.imu_residual_jac, ac.imu_residual_jac_closed))
    elif case == "masked_lanes":
        st, _, book, *_ = dryrun.make_problem(torch.float32, L_evt=32,
                                              device="cpu")
        obs = book.obs.clone()
        obs[4, 1:] = False                 # seen once
        obs[5, :9] = False                 # starts too late
        obs[6:, 0] = torch.tensor(rng.random(26) < 0.5)
        book = dataclasses.replace(
            book, obs=obs, stereo=obs & torch.tensor(rng.random(obs.shape) < 0.6),
            active=book.active & (torch.arange(32) != 2),
            depth_valid=book.depth_valid & (torch.arange(32) != 3),
            vel=torch.tensor(np_f32(rng.normal(0, 0.1, book.vel.shape))))
        st = dataclasses.replace(st, td=torch.tensor(0.003))
        (r0, J0, *_), (r1, J1, *_) = (
            tgn._proj_factor_table(st, book, 1, 3, 1.0, jac=j)
            for j in (tfac.proj22_jac, ac.proj22_jac_closed))
        assert int((J0 != 0).any(-1).any(-1).sum()) < 32 * 23
    else:
        args = _proj_rows(rng, 16, case)
        (r0, J0), (r1, J1) = (f(*args) for f in (tfac.proj22_jac,
                                                 ac.proj22_jac_closed))
    assert rel_err(r1.numpy(), r0.numpy()) < 1e-4
    assert rel_err(J1.numpy(), J0.numpy()) < 1e-4


def test_assemble_normal_reduced_matches(problem):
    jargs, targs = problem
    jsys = jgn.assemble_normal_reduced(*jargs)
    tsys = tgn.assemble_normal_reduced(*targs)
    for name, a, b in zip(("Hpp", "Hpl", "hll", "bp", "bl", "cost"), jsys, tsys):
        assert rel_err(b.numpy(), a) < 1e-4, name
    np.testing.assert_allclose(float(tgn.problem_cost(*targs)),
                               float(jgn.problem_cost(*jargs)), rtol=1e-4)


@pytest.mark.parametrize("iters,atol", [(1, 5e-5), (4, 1e-2)])
def test_solve_window_matches(problem, iters, atol):
    """Before any prior the reduced system has a gauge null space held
    only by λI (λ ≥ 3e-6), and this problem's observations are random, so
    float32 rounding is amplified step by step: one LM step (|dx| ≈ 0.04)
    agrees to 5e-5, four steps to 1e-2 on states of size ~0.2 while the
    costs still agree to 1e-3; inverse depths are compared after the first
    step only."""
    jargs, targs = problem
    jo = jgn.solve_window(*jargs, iters=iters)
    to = tgn.solve_window(*targs, iters=iters)
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]),
                               rtol=1e-4 if iters == 1 else 1e-3)
    for f in ("P", "Q", "V", "Ba", "Bg"):
        np.testing.assert_allclose(getattr(to[0], f).numpy(),
                                   np.asarray(getattr(jo[0], f)), atol=atol,
                                   err_msg=f)
    if iters == 1:
        np.testing.assert_allclose(to[2].inv_depth.numpy(),
                                   np.asarray(jo[2].inv_depth), atol=2e-4)
    else:
        assert to[3][-1] < to[3][0]              # LM decreased the cost


@pytest.fixture(scope="module")
def marg_problem():
    """The marginalization inputs of bench.py:371 (64 image, 128 event
    lanes), in float32 for both packages and in float64 for the JAX one."""
    from __graft_entry__ import _make_problem
    return make_problem(L_img=64, L_evt=128) + (
        _make_problem(jnp.float64, L_img=64, L_evt=128),)


def _normal(p):
    J0 = np.asarray(p.J0.detach().cpu() if isinstance(p.J0, torch.Tensor)
                    else p.J0, np.float64)
    r0 = np.asarray(p.r0.detach().cpu() if isinstance(p.r0, torch.Tensor)
                    else p.r0, np.float64)
    return J0.T @ J0, J0.T @ r0


def test_marginalize_old_and_second_new_match(marg_problem):
    """The pose-0 block of this system mixes bias random-walk weights
    (~1e9) with unobservable directions, and the prior keeps every
    eigenvalue above the absolute threshold 1e-8.  The JAX package takes
    those eigendecompositions in float32, which leaves it 140 % away from
    its own float64 run; the port takes them in float64 (marginalization.
    _eigh), so it is held to the JAX float64 run, within 5 % (its float32
    assembly remains).  lin and valid must equal the float32 JAX run's."""
    jargs, targs, jargs64 = marg_problem
    jp32 = jmarg.marginalize_old(*jargs)
    jp64 = jmarg.marginalize_old(*jargs64)
    tp = tmarg.marginalize_old(*targs)
    (A64, b64), (At, bt), (A32, _) = _normal(jp64), _normal(tp), _normal(jp32)
    assert rel_err(At, A64) < 5e-2 and rel_err(bt, b64) < 5e-2
    assert rel_err(At, A64) < rel_err(A32, A64) / 10
    for f in ("P", "Q", "V", "Ba", "Bg"):
        assert np.array_equal(getattr(tp.lin, f).numpy(),
                              np.asarray(getattr(jp32.lin, f))), f
    assert bool(tp.valid) == bool(jp32.valid)
    # the second-new marginalization of those priors
    s64 = jmarg.marginalize_second_new(jp64)
    st = tmarg.marginalize_second_new(tp)
    (A64, b64), (At, bt) = _normal(s64), _normal(st)
    assert rel_err(At, A64) < 5e-2 and rel_err(bt, b64) < 5e-2
    assert bool(st.valid)
