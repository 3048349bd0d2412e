"""Distributed bundle adjustment: landmark-sharded Schur reduction (port of
esvio_tpu/dist/distributed_ba.py).

  * landmark lanes of each feature book are sharded over the "lm" axis of
    the mesh — a landmark's residual rows live entirely on its shard, so
    the landmark elimination (the expensive part of Schur) is local;
  * each shard computes its partial reduced camera system
    Hr_k = Hpp_k − Hpl_k hll_k⁻¹ Hlp_k, and one sum over "lm" yields the
    global 190×190 reduced system;
  * the IMU and prior factors are counted once (shard 0);
  * independent windows batch over the "dp" axis: their reduced systems
    are solved together, one K2 launch per LM iteration, with λ and the
    accept test per window.

The LM policy is the single-window solve's (gauss_newton.lm_iterate); the
sharded solver only lays the problem out by shard and passes the sum over
"lm".  Unlike the JAX module, which re-assembles at the accepted state and
takes the trial cost by `problem_cost`, it carries the accepted system
(deferred acceptance, as the single solve does): the same steps and costs
up to rounding, one assembly per iteration.

In one process (dist/sharding.make_mesh without a process group) every
shard is a slice of a leading axis and the whole (dp, lm) batch is
assembled in one call; across processes each rank assembles its own
shard and the sums are all-reduces in the "lm" group.
"""
from __future__ import annotations

import dataclasses

import torch

from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver.window import tree_map
from esvio_tpu_torch.dist.sharding import Mesh


def make_sharded_solver(mesh: Mesh, iters: int = 8, cauchy_c: float = 1.0):
    """Build the distributed solver over `mesh` (axes "dp", "lm").

    Returned fn, every argument but g with a leading batch axis dp:
      (state, book_img, book_evt, preints, imu_valid, prior, g)
        → (state', book_img', book_evt', costs (dp, iters))
    The books' lane axes must be divisible by mesh.lm.  Every process
    passes the whole problem and gets the whole result back."""
    lm = mesh.lm
    ds, ls = mesh.local("dp"), mesh.local("lm")

    def shard_book(book):
        """(dp, L, ...) → this process's (dp_local, lm_local, L/lm, ...)."""
        L = book.un.shape[1]
        assert L % lm == 0, f"lane axis {L} not divisible by lm={lm}"
        return tree_map(lambda x: x[ds].reshape(
            (-1, lm, L // lm) + x.shape[2:])[:, ls], book)

    def unshard_book(book):
        book = tree_map(lambda x: mesh.gather(x, "lm", 1), book)
        book = tree_map(lambda x: x.reshape((x.shape[0], -1) + x.shape[3:]),
                        book)
        return tree_map(lambda x: mesh.gather(x, "dp", 0), book)

    def solve(state, book_img, book_evt, preints, imu_valid, prior, g):
        dev = state.P.device
        n_lm = ls.stop - ls.start
        on_shard = lambda x: x.expand((x.shape[0], n_lm) + x.shape[2:])
        local = lambda x: x[ds][:, None]          # (dp_local, 1, ...)
        # the state with a unit shard axis; books, IMU and prior per shard,
        # the IMU and prior on shard 0 only
        state = tree_map(local, state)
        bi, be = shard_book(book_img), shard_book(book_evt)
        first = torch.arange(ls.start, ls.stop, device=dev) == 0
        pre_s = tree_map(lambda x: on_shard(local(x)), preints)
        iv_s = on_shard(local(imu_valid)) & first[None, :, None]
        prior_s = tree_map(lambda x: on_shard(local(x)), prior)
        prior_s = dataclasses.replace(prior_s, valid=prior_s.valid & first)

        def assemble(st, bi_, be_):
            return gn.assemble_normal_reduced(
                tree_map(on_shard, st), bi_, be_, pre_s, iv_s, prior_s, g,
                cauchy_c)

        # the dp reduced systems of an iteration in one solve (one K2
        # launch); λ and the accept test per window
        state, bi, be, costs = gn.lm_iterate(state, bi, be, assemble, iters,
                                             reduce=mesh.sum_lm)
        state = tree_map(lambda x: mesh.gather(x[:, 0], "dp", 0), state)
        costs = mesh.gather(costs[:, 0], "dp", 0)
        return state, unshard_book(bi), unshard_book(be), costs

    return solve
