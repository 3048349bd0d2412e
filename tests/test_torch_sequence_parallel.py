"""Port parity of dist/sequence_parallel.py: a long log cut into
overlapping windows, the windows gathered and preintegrated as one batch,
triangulated and solved as one batch (solve_window_batched), and stitched
back — against esvio_tpu.dist.sequence_parallel on the same numpy log
(tests/synth_np.long_log, tests/test_sequence_parallel.py's build_long_log
at T = 20), float64."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads)
import synth_np

T = 20
BASELINE = synth_np.EST_BASELINE


@pytest.fixture(scope="module")
def log():
    return synth_np.long_log(np.random.default_rng(0), T=T, n_lm=120)


@pytest.fixture(scope="module")
def jax_run(log):
    """Every JAX-side run of this file: gather, the batched solve, stitch."""
    import jax.numpy as jnp
    from esvio_tpu.dist import sequence_parallel as jsp
    from esvio_tpu.imu import preintegration as jpre
    _, long_state, long_book = log
    starts = jsp.window_starts(T)
    params = jpre.make_imu_params(dtype=jnp.float64)
    gathered = jsp.gather_windows(long_state, long_book, starts, params,
                                  dtype=jnp.float64)
    g = jnp.asarray([0.0, 0.0, 9.80766], jnp.float64)
    st, be, costs = jsp.solve_windows_batched(
        *gathered, g, iters=8, rrl=jnp.eye(3, dtype=jnp.float64),
        trl=jnp.asarray([-BASELINE, 0.0, 0.0], jnp.float64))
    return dict(starts=starts, gathered=gathered, st=st, be=be, costs=costs,
                stitched=jsp.stitch(st, starts, T))


@pytest.fixture(scope="module")
def port_run(log):
    from esvio_tpu_torch.dist import sequence_parallel as tsp
    from esvio_tpu_torch.imu import preintegration as tpre
    _, long_state, long_book = log
    starts = tsp.window_starts(T)
    params = tpre.make_imu_params(dtype=torch.float64)
    gathered = tsp.gather_windows(long_state, long_book, starts, params,
                                  dtype=torch.float64, device="cpu")
    g = torch.tensor([0.0, 0.0, 9.80766], dtype=torch.float64)
    st, be, costs = tsp.solve_windows_batched(
        *gathered, g, iters=8, rrl=torch.eye(3, dtype=torch.float64),
        trl=torch.tensor([-BASELINE, 0.0, 0.0], dtype=torch.float64))
    return dict(starts=starts, gathered=gathered, st=st, be=be, costs=costs,
                stitched=tsp.stitch(st, starts, T))


@pytest.mark.parametrize("T_", [11, 12, 20, 38, 57])
def test_window_starts_match(T_):
    from esvio_tpu.dist import sequence_parallel as jsp
    from esvio_tpu_torch.dist import sequence_parallel as tsp
    for overlap in (1, 2, 3):
        np.testing.assert_array_equal(tsp.window_starts(T_, overlap),
                                      jsp.window_starts(T_, overlap))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_gather_windows_matches(jax_run, port_run):
    """Ints and bools exactly, floats within 1e-9 (the preintegration of
    the B × 10 intervals is one batch on the port side)."""
    for jobj, tobj in zip(jax_run["gathered"], port_run["gathered"]):
        pairs = ([("imu_valid", jobj, tobj)] if not dataclasses.is_dataclass(
            tobj) else [(k, _fields(jobj)[k], v) for k, v in _fields(tobj).items()])
        for name, a, b in pairs:
            a = np.asarray(a)
            b = b.numpy()
            assert a.shape == b.shape, name
            if b.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-9,
                                           err_msg=name)


def test_batched_solve_and_stitch_match(jax_run, port_run):
    """The triangulated, batch-solved windows and the stitched trajectory
    within 1e-6 (float64), the costs within tests/test_distributed.py:45's
    1e-5 (a rejected step's cost moves most).  tests/test_sequence_parallel.py's
    gates are for T = 38; chip_smoke.py holds the port to them there."""
    np.testing.assert_allclose(port_run["costs"].numpy(),
                               np.asarray(jax_run["costs"]), rtol=1e-5)
    np.testing.assert_allclose(port_run["st"].P.numpy(),
                               np.asarray(jax_run["st"].P), atol=1e-6)
    np.testing.assert_allclose(port_run["st"].V.numpy(),
                               np.asarray(jax_run["st"].V), atol=1e-6)
    np.testing.assert_array_equal(port_run["be"].depth_valid.numpy(),
                                  np.asarray(jax_run["be"].depth_valid))
    P_j, Q_j = jax_run["stitched"]
    P_t, Q_t = port_run["stitched"]
    np.testing.assert_allclose(P_t, P_j, atol=1e-6)
    # quaternions up to sign (core/lie_np keeps w >= 0)
    np.testing.assert_allclose(np.abs(np.sum(Q_t * Q_j, -1)), 1.0, atol=1e-9)


def test_stitch_matches_on_given_windows(jax_run):
    """stitch alone on the JAX solve's windows: the same trajectory within
    1e-9."""
    from esvio_tpu_torch.dist import sequence_parallel as tsp
    from esvio_tpu_torch.solver import window as twin
    st = torch_parity.to_torch(jax_run["st"], twin.WindowState)
    P_t, Q_t = tsp.stitch(st, jax_run["starts"], T)
    P_j, Q_j = jax_run["stitched"]
    np.testing.assert_allclose(P_t, P_j, atol=1e-9)
    np.testing.assert_allclose(np.abs(np.sum(Q_t * Q_j, -1)), 1.0, atol=1e-12)
