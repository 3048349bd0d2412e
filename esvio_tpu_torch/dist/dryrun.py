"""The sharded solve's dry run: a small deterministic window problem and one
landmark-sharded × window-batched solve held to the single-window solve
(a numpy/torch copy of __graft_entry__._make_problem and
dryrun_multichip).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from esvio_tpu_torch.imu import preintegration as pre
from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver import window as win


def make_problem(dtype=torch.float32, L_img=8, L_evt=64, batch=None,
                 device="cuda"):
    """(state, book_img, book_evt, preints, imu_valid, prior, g) of a small
    synthetic sliding-window BA problem (seed 0); with `batch`, every
    argument but g stacked `batch` times along a leading axis."""
    rng = np.random.default_rng(0)
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=device)
    state = win.init_window(device, dtype)
    state = dataclasses.replace(
        state, P=t(np.cumsum(rng.normal(0, 0.02, (win.N_STATES, 3)), axis=0)))

    n_lm = L_evt // 2
    un = rng.normal(0, 0.2, (L_evt, win.N_STATES, 2))
    live = np.arange(L_evt) < n_lm
    live2 = np.repeat(live[:, None], win.N_STATES, 1)
    book_evt = dataclasses.replace(
        win.empty_book(L_evt, device, dtype),
        un=t(un), un_r=t(un - 0.02), obs=t(live2, torch.bool),
        stereo=t(live2, torch.bool), inv_depth=t(np.full(L_evt, 0.25)),
        depth_valid=t(live, torch.bool), active=t(live, torch.bool))
    book_img = win.empty_book(L_img, device, dtype)

    params = pre.make_imu_params(dtype=dtype, device=device)
    K, N = win.WINDOW, 32
    acc = rng.normal(0, 0.3, (K, N, 3)) + np.array([0, 0, 9.80766])
    gyr = rng.normal(0, 0.2, (K, N, 3))
    preints = pre.preintegrate_batch(
        torch.full((K, N), 0.005, dtype=dtype, device=device), t(acc),
        t(gyr), t(acc[:, 0]), t(gyr[:, 0]),
        torch.zeros((K, 3), dtype=dtype, device=device),
        torch.zeros((K, 3), dtype=dtype, device=device), params,
        torch.ones((K, N), dtype=torch.bool, device=device))

    iv = torch.ones((K,), dtype=torch.bool, device=device)
    prior = gn.empty_prior(device, dtype)
    g = t([0.0, 0.0, 9.80766])
    args = (state, book_img, book_evt, preints, iv, prior)
    if batch is not None:
        args = tuple(win.tree_map(lambda x: torch.stack([x] * batch), a)
                     for a in args)
    return args + (g,)


def dryrun_multichip(n_devices: int, device="cuda", reps: int = 3):
    """One landmark-sharded ("lm") × window-batched ("dp") solve of
    n_devices shards in the one-process layout, and its cost parity
    (relative < 1e-3) against the single-window solve of the same
    problem.  Returns (costs (dp, 2), relative error, ms per solve)."""
    from esvio_tpu_torch.dist import distributed_ba, sharding

    lm = min(math.gcd(n_devices, 8), 4)   # cap so dp is exercised at n=8
    dp = n_devices // lm
    mesh = sharding.make_mesh(dp=dp, lm=lm)
    solver = distributed_ba.make_sharded_solver(mesh, iters=2)
    args = make_problem(torch.float32, batch=dp, device=device)
    costs = solver(*args)[3].cpu().numpy()
    assert np.isfinite(costs).all(), costs

    ref = gn.solve_window(*make_problem(torch.float32, device=device),
                          iters=2)
    costs_ref = ref[3].cpu().numpy()
    rel = np.abs(costs[0] - costs_ref) / np.maximum(np.abs(costs_ref), 1e-3)
    assert rel.max() < 1e-3, (costs[0], costs_ref)

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver(*args)
    out[3].cpu()
    step_ms = (time.perf_counter() - t0) / reps * 1000.0
    print(f"dryrun_multichip ok: mesh dp={dp} lm={lm}, costs={costs[0]}, "
          f"lm1-parity rel={rel.max():.2e}, step={step_ms:.1f} ms "
          f"({dp * 1000.0 / step_ms:.1f} windows/s on {device})")
    return costs, float(rel.max()), step_ms

