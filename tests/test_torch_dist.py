"""Port parity of dist/: the one-process sharded solver (lm = 4, dp = 2)
against esvio_tpu.dist.distributed_ba on conftest's 8-device CPU mesh, the
two-process Gloo selftest of dist/multihost.py, and
dist/dryrun.dryrun_multichip."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_dist_batched import _problems, stack_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX-side run of this file (one compile): the shard_map solver on
    the ("dp" 2, "lm" 4) mesh, 2 iterations, float64, two windows."""
    import jax.numpy as jnp
    from esvio_tpu.dist import distributed_ba, sharding
    probs, g = _problems(2)
    batched = tuple(stack_torch(probs, i) for i in range(6))
    mesh = sharding.make_mesh(dp=2, lm=4)
    return batched, g, distributed_ba.make_sharded_solver(mesh, iters=2)(
        *tp.window_args_to_jax(batched), jnp.asarray(g.numpy()))


def test_sharded_solver_matches_jax(jax_sharded):
    """lm = 4 landmark shards × dp = 2 windows in one process against the
    JAX shard_map solver on the 8-device CPU mesh (float64, 2 iterations),
    and against the port's single-window solve, within
    tests/test_distributed.py:45-50's tolerances."""
    from esvio_tpu_torch.dist import distributed_ba, sharding
    from esvio_tpu_torch.solver import gauss_newton as tgn
    from esvio_tpu_torch.solver import window as twin
    batched, g, (st_j, _, be_j, costs_j) = jax_sharded
    targs, g_t = batched, g
    mesh = sharding.make_mesh(dp=2, lm=4)
    st, _, be, costs = distributed_ba.make_sharded_solver(mesh, iters=2)(
        *targs, g_t)
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_j), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(st.P.numpy(), np.asarray(st_j.P), atol=1e-6)
    np.testing.assert_allclose(be.inv_depth.numpy(),
                               np.asarray(be_j.inv_depth), atol=1e-6)
    single = tgn.solve_window(*(twin.tree_map(lambda x: x[0], a)
                                for a in targs), g_t, iters=2)
    np.testing.assert_allclose(costs[0].numpy(), single[3].numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(st.P[0].numpy(), single[0].P.numpy(),
                               atol=1e-6)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes_match_one_process():
    """python -m esvio_tpu_torch.dist.multihost --selftest in two Gloo
    processes on localhost (dp = 1, lm = 2, float64): both ranks print the
    same cost vector, equal to the one-process layout's within 1e-5."""
    from esvio_tpu_torch.dist import multihost, sharding
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "esvio_tpu_torch.dist.multihost",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(r), "--device", "cpu", "--dtype", "float64",
         "--selftest"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["mesh"] == {"dp": 1, "lm": 2} and o["backend"] == "gloo"
               for o in outs)
    assert outs[0]["costs"] == outs[1]["costs"]
    one = multihost.selftest(sharding.make_mesh(dp=1, lm=2), device="cpu",
                             dtype=torch.float64)
    np.testing.assert_allclose(np.asarray(outs[0]["costs"]), one, rtol=1e-5)
    assert multihost.initialize() is False
    assert multihost.make_hybrid_mesh(lm=4).shape == {"dp": 1, "lm": 4}


def test_dryrun_multichip():
    """dist/dryrun.dryrun_multichip(4): lm = 4 shards in one process, cost
    parity < 1e-3 against the single-window solve (asserted inside)."""
    from esvio_tpu_torch.dist import dryrun
    costs, rel, _ = dryrun.dryrun_multichip(4, "cpu", reps=1)
    assert costs.shape == (1, 2) and rel < 1e-3
