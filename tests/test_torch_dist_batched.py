"""Port parity of solver/gauss_newton.solve_window_batched: B = 3 windows
in one batched solve against the JAX `jax.vmap` of solve_window and
against single port solves, and its one batched Cholesky solve (one K2
launch on the card) per LM iteration."""
import numpy as np
import pytest
import torch

import synth_np
import torch_parity as tp

B = 3


def _problems(n=B):
    """n windows (seeds 0..n-1) as the port's arguments, and g."""
    probs = [synth_np.solver_window(seed, "cpu") for seed in range(n)]
    return [p for p, _ in probs], probs[0][1]


def stack_torch(probs, i):
    from esvio_tpu_torch.solver import window as twin
    return twin.tree_map(lambda *x: torch.stack(x), *[p[i] for p in probs])


@pytest.fixture(scope="module")
def jax_vmap():
    """The JAX-side run of this file (one compile): jax.vmap of
    solve_window over the B windows, float64."""
    import jax
    import jax.numpy as jnp
    from esvio_tpu.solver import gauss_newton as jgn
    probs, g = _problems()
    batched = tuple(stack_torch(probs, i) for i in range(6))
    g_j = jnp.asarray(g.numpy())
    vsolve = jax.jit(jax.vmap(lambda *a: jgn.solve_window(*a, g_j, iters=5)))
    return probs, g, batched, vsolve(*tp.window_args_to_jax(batched))


def _cast(tree, dtype):
    from esvio_tpu_torch.solver import window as twin
    return tuple(twin.tree_map(lambda x: x.to(dtype) if x.is_floating_point()
                               else x, a) for a in tree)


@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-6),
                                         (torch.float32, 2e-3)])
def test_batched_solve_matches_jax_vmap_and_single_solves(jax_vmap, dtype,
                                                          atol):
    """B = 3 windows in one batched solve against 3 single port solves
    within the repo's tolerances (P, V and the inverse depths: 1e-6 in
    float64; 2e-3 in float32, tests/test_fused_tick.py:66-67), and in
    float64 against the JAX vmap (one JAX compile for the file), the costs
    as tests/test_distributed.py:45 holds them (an atol floor where they
    converge to ~1e-11).  The float32 LM damps otherwise
    (gauss_newton.damping_schedule), so its path is held to the port's
    own float32 single solves."""
    from esvio_tpu_torch.solver import gauss_newton as tgn
    probs, g, batched, (st_j, _, be_j, costs_j) = jax_vmap
    targs = _cast(batched, dtype)
    g_t = g.to(dtype)
    st, _, be, costs = tgn.solve_window_batched(*targs, g_t, iters=5)
    assert costs.shape == (B, 5) and st.P.dtype == dtype
    if dtype == torch.float64:
        for f in ("P", "V"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(st_j, f)), atol=atol)
        np.testing.assert_allclose(be.inv_depth.numpy(),
                                   np.asarray(be_j.inv_depth), atol=atol)
        np.testing.assert_allclose(costs.numpy(), np.asarray(costs_j),
                                   rtol=1e-5, atol=1e-9)
    for b in range(B):
        s1, _, b1, c1 = tgn.solve_window(*_cast(probs[b], dtype), g_t,
                                         iters=5)
        for f in ("P", "V"):
            np.testing.assert_allclose(getattr(st, f)[b].numpy(),
                                       getattr(s1, f).numpy(), atol=atol)
        np.testing.assert_allclose(be.inv_depth[b].numpy(),
                                   b1.inv_depth.numpy(), atol=atol)


def test_batched_solve_launches_one_solve_per_iteration(monkeypatch):
    """The B reduced systems of an iteration go to the batched Cholesky
    solve together (one K2 launch on the card)."""
    from esvio_tpu_torch.dist import dryrun
    from esvio_tpu_torch.solver import gauss_newton as tgn
    calls = []
    real = tgn.chol_solve_batched
    monkeypatch.setattr(tgn, "chol_solve_batched",
                        lambda A, b, lam: calls.append(A.shape) or real(A, b, lam))
    args = dryrun.make_problem(torch.float32, L_img=8, L_evt=16, batch=4,
                               device="cpu")
    tgn.solve_window_batched(*args, iters=3)
    assert calls == [(4, 190, 190)] * 3
