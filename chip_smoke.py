#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (esvio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

It builds the port's CUDA kernels from csrc/ with nvcc (one process per
source, all at once, printing ptxas's registers and spills), holds each
kernel against its plain PyTorch version on the card and times it four
ways by CUDA events: bare (the C entry point alone, launches captured in a
CUDA graph), as the main path calls it (the wrapper), the plain version,
and the one PyTorch call that computes the same function where there is
one.  (chip_ab.py times other versions of the kernel sources against
these in turns.)
It then drives the ESIO pipeline (stereo events + IMU -> trajectory)
through `Pipeline.run` at the golden and at the bench size on the default
fused path (segment A of every steady estimator tick a CUDA graph replay),
times the event front end at DAVIS346 and DSEC size, drives the bench size
once more on the general path (fused=False), and replays that run's
estimator calls to hold the graph replay against the eager fused tick and
to count, per steady tick of each path, host syncs (sync debug mode) and
device operations (torch.profiler), with the card's idle share.  Then the
ESVIO pipeline (stereo events + stereo frames + IMU, system_mode 1) at the
golden and at the bench size, its frames rendered at twice the tracker's
size and resized on the card, and the image tracker's tick at DAVIS346 and
DSEC frame size.  Then loop closure: the e2e loop sequence
(tests/test_e2e_loops.py) with loop closure, fast relocalization and IMU
motion correction on (every closed loop fed back through the estimator's
in-window relocalization solve, which takes the general path for that
tick), bench.py's 240x320 pipeline with loop closure against the same
run without it, and the 4-DoF pose graph's CG solve at 6144 keyframes
with motion correction at DSEC size.  It checks every result.  One line
per phase, then a JSON line with the kernels, then as the last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed check raises, so the script exits non-zero and prints no last
line; it also exits non-zero when no CUDA device is visible or when the
port's package is not beside it.  It imports neither jax nor esvio_tpu:
the synthetic sequences come from tests/synth_np.py (numpy only).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_NPZ = os.path.join(ROOT, "tests", "golden", "esio_planar_rot.npz")
GOLDEN_ESVIO_NPZ = os.path.join(ROOT, "tests", "golden", "esvio_planar_rot.npz")

# Max position deviation from the golden trajectory once yaw and translation,
# the four degrees of freedom VIO cannot observe, are aligned onto it: the
# golden test's 0.05 m (tests/test_golden_trace.py:83).  Unaligned, the
# port's own front end misses it: float32 rounding flips single features,
# the stereo initialization fixes another gauge and every later pose carries
# it (PERF.md, "Golden gates").  The NON_LINEAR stamps and the ATE gate are
# the golden test's own (tests/test_golden_trace.py:78-86).
GOLDEN_MAX_DEV_M = 0.05
# The ESVIO golden (phase 9) is held to what the JAX package itself meets on
# it (tests/jax_golden_spread.py: its default path on the CPU, with its own
# RANSAC key and with keys 1-6): the stamps and the ATE gate at every key;
# after the yaw + translation alignment it lands 0.0253-0.0763 m from the
# golden (0.0480 m with its own key, over 0.05 m at 4 of the 7 keys), so
# the port's aligned deviation is held to that spread's largest.  Unaligned
# it misses the golden's 0.05 m at 5 of the 7 keys (0.0654 m with its own).
ESVIO_GOLDEN_MAX_DEV_M = 0.0763
ESVIO_ATE_MAX_M = 0.3     # tests/test_pipeline.py:157-158


def log(msg):
    print(msg, flush=True)


def _timed(fn, reps, warmup=3):
    """Mean ms of fn() over `reps` launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The card's peaks (H100 SXM data sheet, at 700 W): float32 FMA outside the
# tensor cores (two FLOP each), and HBM.  Float compares and minimums issue
# at 64 per clock per SM on sm_90, half the FMA's rate (CUDA C++ Programming
# Guide, throughput of native arithmetic instructions): their peak is that
# times the SMs times the card's maximum SM clock, read in phase 1.
PEAK_F32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12      # B/s
CMP_PER_CLOCK_PER_SM = 64


def _bound(n_bytes, n_ops, peak_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_device():
    """Build every kernel, one nvcc per source, all started together; returns
    the card's peak rate of float compares and minimums (per second)."""
    import torch
    from esvio_tpu_torch import _kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    mhz = float(clock.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak_cmp = CMP_PER_CLOCK_PER_SM * sms * mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}, {sms} SMs at most {mhz:.0f} MHz: "
        f"{peak_cmp / 1e12:.2f} T float compares/s")
    secs, nvcc_log = _kernels.build(force=True)
    for line in nvcc_log.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
            log(f"  {line.strip()}")
    for k in _kernels.KERNELS:
        k.fn()
    log(f"phase 1 device: ok, {len(_kernels.KERNELS)} sources built by nvcc "
        f"in {secs:.1f} s")
    return peak_cmp


# ---------------------------------------------------------------- phase 2
def _texture(H, W, seed):
    """Binary blobs: smoothed noise thresholded at its upper quartile."""
    import numpy as np
    noise = np.random.default_rng(seed).normal(0, 1, (H, W))
    k = np.ones(7) / 7.0
    for ax in (0, 1):
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, noise)
    return (noise > np.percentile(noise, 75)).astype(np.float32)


def _sae_from_events(H, W, device, seed, steps=24):
    """A realistic SAE: blobs of a texture translating over the sensor,
    their edge events fed through update_sae on the card."""
    import numpy as np
    from esvio_tpu_torch.events import sae as sae_mod
    rng = np.random.default_rng(seed)
    pad = 2 * steps + 8
    tex = _texture(H + pad, W + pad, seed)
    state = sae_mod.init_sae(H, W, device)
    t = 1.0
    prev = tex[:H, :W]
    for s in range(1, steps):
        cur = tex[s:s + H, 2 * s:2 * s + W]
        yy, xx = np.nonzero(cur != prev)
        pol = (cur[yy, xx] > prev[yy, xx]).astype(np.int32)
        order = rng.permutation(len(yy))
        ts = np.sort(rng.uniform(t, t + 0.004, len(yy)))
        ch = sae_mod.chunk_from_arrays(ts, xx[order], yy[order], pol[order],
                                       capacity=max(len(yy), 1),
                                       device=device)
        state, _ = sae_mod.update_sae(state, ch, 0.01)
        prev = cur
        t += 0.005
    return state


# the (H, W) of phase 2: a narrow strip, golden, bench, DAVIS346, DSEC
K1_SHAPES = [(50, 170), (120, 160), (240, 320), (260, 346), (480, 640)]

# float compares and minimums per pixel of the arc test, both circles:
# argmax pass N-1, then 3 per step of the first phase and 4 per step of
# the second (corners._newest_segment_size)
K1_OPS_PER_PX = sum((n - 1) + 3 * (lo - 1) + 4 * (n - lo)
                    for n, lo in ((16, 4), (20, 5)))


def phase_corner_mask(device, shapes, main_shape, peak_cmp):
    import torch
    from esvio_tpu_torch import _kernels
    from esvio_tpu_torch.events import corners
    from esvio_tpu_torch.utils.metrics import graph_ms
    rows = {}
    for H, W in shapes:
        st = _sae_from_events(H, W, device, seed=H * W)
        sae = st.sae
        got = corners.corner_mask_cuda(sae)
        want = corners.corner_mask_plain(sae)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        n_corner = int(want.sum())
        if got.dtype != torch.bool or n_diff or n_corner == 0:
            raise AssertionError(f"K1 at (2, {H}, {W}): {n_diff} pixels differ "
                                 f"from the plain version, {n_corner} corners, "
                                 f"dtype {got.dtype}")
        P = sae.shape[0]
        fn = _kernels.CORNER_MASK.fn()
        out = torch.empty((P, H, W), dtype=torch.bool, device=device)
        launch = lambda: fn(sae.data_ptr(), out.data_ptr(), P, H, W,
                            _kernels.stream_ptr(device))
        ms = graph_ms(launch, reps=200)
        wrapper_ms = _timed(lambda: corners.corner_mask_cuda(sae), reps=200)
        plain_ms = _timed(lambda: corners.corner_mask_plain(sae), reps=20)
        bound_ms, bound_by = _bound(P * H * W * (4 + 1), P * H * W * K1_OPS_PER_PX,
                                    peak_cmp)
        rows[(H, W)] = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                            max_abs_err=0.0)
        log(f"  K1 corner_mask (2, {H}, {W}): equal everywhere, {n_corner} "
            f"corner pixels; bare {ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}, {bound_ms / ms:.2%} reached)")
    log("phase 2 corner mask K1: ok")
    return rows[main_shape]


# ---------------------------------------------------------------- phase 3
def _spd_problem(seed, n_sys, n=190, jitter=50.0):
    """The SPD systems of tests/test_chol_pallas.py, with float64 answers."""
    import numpy as np
    rng = np.random.default_rng(seed)
    G = rng.normal(0, 1, (n_sys, n, n)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", G, G) + jitter * np.eye(n, dtype=np.float32)
    b = rng.normal(0, 1, (n_sys, n)).astype(np.float32)
    lam = np.geomspace(1e-4, 10.0, n_sys).astype(np.float32)
    return A, b, lam


def _jacobi_problem(seed, n=190):
    """An ill-conditioned system as solve_window hands it to K2: raw
    H = D JᵀJ D with D over 1e-3..1e3 (condition ~1e12), Jacobi-scaled to a
    unit diagonal (gauss_newton.py:334-356), damped by the LM's λ₀ = 1e-4."""
    import numpy as np
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1, (400, n))
    D = np.geomspace(1e-3, 1e3, n)
    H = (D[:, None] * (J.T @ J) * D[None, :]).astype(np.float32)
    g = rng.normal(0, 1, n).astype(np.float32)
    d_inv = (1.0 / np.sqrt(np.diag(H))).astype(np.float32)
    Hs = (H * d_inv[None, :] * d_inv[:, None]).astype(np.float32)
    return Hs[None], (g * d_inv)[None], np.full(1, 1e-4, np.float32)


def _x64(A, b, lam):
    import numpy as np
    n = A.shape[-1]
    return np.stack([np.linalg.solve(
        A[i].astype(np.float64) + float(lam[i]) * np.eye(n), b[i].astype(np.float64))
        for i in range(A.shape[0])])


def phase_chol(device):
    import numpy as np
    import torch
    from esvio_tpu_torch import _kernels
    from esvio_tpu_torch.solver import chol_solve as cs
    from esvio_tpu_torch.utils.metrics import graph_ms
    fn = _kernels.CHOL_SOLVE.fn()
    n = cs.N
    rows = {}
    cases = [(f"B={B}", *_spd_problem(seed=B, n_sys=B)) for B in (1, 4, 8)]
    cases.append(("Jacobi-scaled B=1", *_jacobi_problem(seed=3)))
    for label, A, b, lam in cases:
        x_ref = _x64(A, b, lam)
        B = A.shape[0]
        At, bt, lt = (torch.tensor(a, device=device) for a in (A, b, lam))
        x = cs.chol_solve_cuda(At, bt, lt)
        xp = cs.chol_solve_plain(At, bt, lt)
        torch.cuda.synchronize()
        x, xp = x.cpu().numpy(), xp.cpu().numpy()
        scale = np.abs(x_ref).max()
        rel = float(np.abs(x - x_ref).max() / scale)
        rel_plain = float(np.abs(xp - x_ref).max() / scale)
        if not (rel < 5e-5 and np.abs(x - xp).max() / scale < 5e-5):
            raise AssertionError(f"K2 {label}: rel err {rel:.2e} vs float64, "
                                 f"plain {rel_plain:.2e}")
        if label.startswith("Jacobi"):
            log(f"  K2 chol_solve {label} (raw condition ~1e12): rel err "
                f"{rel:.2e} vs float64, plain {rel_plain:.2e}")
            continue
        xo = torch.empty((B, n), device=device)
        launch = lambda: fn(At.data_ptr(), bt.data_ptr(), lt.data_ptr(),
                            xo.data_ptr(), B, _kernels.stream_ptr(device))
        ms = graph_ms(launch, reps=100)
        wrapper_ms = _timed(lambda: cs.chol_solve_cuda(At, bt, lt), reps=200)
        plain_ms = _timed(lambda: cs.chol_solve_plain(At, bt, lt), reps=200)
        Ad = At + lt[:, None, None] * torch.eye(n, device=device)
        lib_solve = _timed(lambda: torch.linalg.solve(Ad, bt), reps=200)
        lib_chol = _timed(lambda: torch.cholesky_solve(
            bt[..., None], torch.linalg.cholesky_ex(Ad)[0]), reps=200)
        flops = B * (2 * n ** 3 / 3 + 2 * n ** 2)
        bound_ms, bound_by = _bound(4 * B * (n * n + 2 * n + 1), flops, PEAK_F32)
        row = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                   library_ms=min(lib_solve, lib_chol), bound_ms=bound_ms,
                   bound_by=bound_by, max_abs_err=float(np.abs(x - xp).max()))
        rows[B] = row
        log(f"  K2 chol_solve {label} N=190: rel err {rel:.2e} vs float64 "
            f"(plain {rel_plain:.2e}); bare {ms:.4f} ms, wrapper "
            f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{row['library_ms']:.4f} ms (solve {lib_solve:.4f}, cholesky_ex + "
            f"cholesky_solve {lib_chol:.4f}), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}, {bound_ms / ms:.2%} reached)")
    # the NaN contract: an indefinite system comes back non-finite, its
    # neighbour stays finite
    A, b, lam = _spd_problem(seed=2, n_sys=2)
    A[1] -= 500.0 * np.eye(190, dtype=np.float32)
    x = cs.chol_solve_cuda(*(torch.tensor(a, device=device) for a in (A, b, lam)))
    x = x.cpu().numpy()
    if not (np.isfinite(x[0]).all() and not np.isfinite(x[1]).all()):
        raise AssertionError("K2: indefinite system did not give a "
                             "non-finite row beside a finite one")
    log("  K2 indefinite system: non-finite row, neighbour finite")
    log("phase 3 Cholesky solve K2: ok")
    return rows[1]


# ---------------------------------------------------------------- phase 4/5
def _graph_use(pipe):
    """(captures, replays) of the pipeline's fused-tick CUDA graphs; fails
    unless the steady ticks went through graph replays."""
    gr = pipe.estimator._graphs
    if gr is None or gr.n_replays == 0 or gr.n_captures == 0:
        raise AssertionError("no steady estimator tick was a CUDA graph replay")
    return gr.n_captures, gr.n_replays


def phase_golden(device):
    import torch
    from synth_np import GOLDEN, golden_gates, vio_pipeline
    from esvio_tpu_torch import _kernels
    make_pipeline, seq, gt_t, gt_P = vio_pipeline(device, **GOLDEN)
    pipe = make_pipeline()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = _kernels.CORNER_MASK.launches
    k2 = _kernels.CHOL_SOLVE.launches
    g = golden_gates(res, gt_t, gt_P, GOLDEN_NPZ)
    ticks = res.metrics["ticks"]
    caps, reps = _graph_use(pipe)
    log(f"  golden ESIO 120x160 1.6 s (fused): {ticks:.0f} ticks in {wall:.2f} s "
        f"({ticks / wall:.2f} ticks/s, cold), {g['n_stamps']} NON_LINEAR "
        f"stamps (golden {g['n_golden']}), max dev {g['max_dev_4dof']:.4f} m "
        f"after yaw {g['yaw_deg']:.2f} deg + shift {g['shift_m']:.4f} m "
        f"({g['max_dev']:.4f} m unaligned), ATE {g['ate']:.4f} m (golden "
        f"{g['ate_golden']:.4f} m); launches K1 {k1}, K2 {k2}; fused-tick "
        f"graphs: {caps} captured, {reps} replays")
    if not g["stamps_ok"]:
        raise AssertionError("golden: NON_LINEAR stamps differ")
    if not g["ate_ok"]:
        raise AssertionError(f"golden: ATE {g['ate']:.4f} m > 1.5 x golden + 0.01")
    if not g["max_dev_4dof"] < GOLDEN_MAX_DEV_M:
        raise AssertionError(f"golden: max deviation {g['max_dev_4dof']:.4f} m "
                             "after the yaw + translation alignment")
    if k1 != ticks or k2 == 0:
        raise AssertionError(f"golden: K1 launched {k1} times for {ticks:.0f} "
                             f"tracker ticks, K2 {k2} times")
    log("phase 4 golden pipeline: ok")


def _bench_run(pipe, seq, gt_t, gt_P, label):
    """Run one 240x320 pipeline, check its trajectory, log its rates."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    res = pipe.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = res.metrics["ticks"]
    n_nl = len(res.stamps)
    if n_nl == 0 or res.n_restarts:
        raise AssertionError(f"240x320 pipeline ({label}): {n_nl} NON_LINEAR "
                             f"ticks, {res.n_restarts} restarts")
    P = np.asarray(res.P)
    if not np.isfinite(P).all() or P.shape != (n_nl, 3):
        raise AssertionError(f"240x320 pipeline ({label}): bad trajectory "
                             f"{P.shape}")
    ate = res.ate(gt_t, gt_P)
    rate = ticks / wall
    log(f"  ESIO 240x320 2.4 s ({label}): {ticks:.0f} ticks, {n_nl} NON_LINEAR, "
        f"ATE {ate:.4f} m, {rate:.2f} ticks/s, realtime x{rate / 15.0:.3f} "
        f"at 15 Hz; estimator {res.stage_times['estimator']['mean_ms']:.1f} "
        f"ms/tick; stage ms/tick {json.dumps(res.stage_times)}")
    return dict(ticks=ticks, ate=ate, rate=rate, n_nl=n_nl)


def phase_bench_pipeline(device):
    """The bench.py pipeline (240x320, focal 320, 2.4 s) on the default fused
    path: the main path whose kernel launches the JSON line reports."""
    from synth_np import BENCH, vio_pipeline
    from esvio_tpu_torch import _kernels
    make_pipeline, seq, gt_t, gt_P = vio_pipeline(device, **BENCH)
    make_pipeline().run(seq)                     # cold run: first launches
    pipe = make_pipeline()
    _kernels.reset_launch_counts()
    run = _bench_run(pipe, seq, gt_t, gt_P, "fused, warm")
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    caps, reps = _graph_use(pipe)
    log(f"  launches {launches}; fused-tick graphs: {caps} captured, "
        f"{reps} replays")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    log("phase 5 240x320 pipeline: ok")
    run["sequence"] = (seq, gt_t, gt_P)
    return launches, run


def phase_general_pipeline(device, run5):
    """The same 240x320 run (phase 5's sequence) on the general path
    (fused=False), with every estimator call recorded for phase 8."""
    from synth_np import BENCH, vio_pipeline
    ate_fused = run5["ate"]
    make_pipeline, seq, gt_t, gt_P = vio_pipeline(
        device, fused=False, sequence=run5["sequence"], **BENCH)
    pipe = make_pipeline()
    calls = _record_calls(pipe.estimator)
    ate = _bench_run(pipe, seq, gt_t, gt_P, "general, warm")["ate"]
    if abs(ate - ate_fused) > 0.01:
        raise AssertionError(f"ATE general {ate:.4f} m, fused {ate_fused:.4f} m")
    log("phase 7 240x320 pipeline, general path: ok")
    return pipe, calls


# ---------------------------------------------------------------- phase 8
def _record_calls(est):
    """Record the estimator calls a pipeline makes, packets cloned, into a
    list of ticks, each a list of (method name, args)."""
    import dataclasses
    ticks = [[]]

    def wrap(name):
        real = getattr(est, name)

        def recorded(*args):
            args = tuple(dataclasses.replace(a, **{
                f.name: getattr(a, f.name).clone()
                for f in dataclasses.fields(a)})
                if dataclasses.is_dataclass(a) else a for a in args)
            ticks[-1].append((name, args))
            if name == "update_latest":
                ticks.append([])
            return real(*args)
        setattr(est, name, recorded)

    for name in ("process_imu_and_predict", "process_packets", "update_latest"):
        wrap(name)
    return ticks


def _play(est, tick):
    """One recorded tick into `est`; returns its process_packets Output."""
    out = None
    for name, args in tick:
        r = getattr(est, name)(*args)
        if name == "process_packets":
            out = r
    return out


def _steady(est):
    from esvio_tpu_torch.vio import estimator as est_mod
    return est.solver_flag == "NON_LINEAR" and est.frame_count == est_mod.WINDOW


def _clone(est, **cfg):
    """A new estimator on est's state (its own graphs), cfg fields replaced."""
    import copy
    import dataclasses
    from esvio_tpu_torch.vio import estimator as est_mod
    from esvio_tpu_torch.vio.fused_graph import clone_state
    c = est_mod.Estimator(dataclasses.replace(est.cfg, **cfg),
                          est.ws.ex_p.cpu().numpy(), est.ws.ex_q.cpu().numpy(),
                          est.device, imu_params=est.imu_params)
    for name in ("ws", "book_img", "book_evt", "prior"):
        setattr(c, name, clone_state(getattr(est, name)))
    for name in ("frame_count", "solver_flag", "timestamps", "imu_dt", "imu_acc",
                 "imu_gyr", "imu_n", "acc0", "gyr0", "first_imu", "last_marg",
                 "failures", "_prior_valid", "_seen_img", "_post", "n_solves",
                 "lanes_dropped", "_latest", "_imu_replay"):
        setattr(c, name, copy.deepcopy(getattr(est, name)))
    return c


def _syncs(est, ticks):
    """Host syncs per tick of `ticks` played into est (sync debug mode), and
    the source lines that made them."""
    import collections
    import warnings
    import torch
    where = collections.Counter()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for tick in ticks:
                _play(est, tick)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            path = os.path.relpath(w.filename, ROOT)
            if path.startswith(".."):                  # outside the repo
                path = "/".join(w.filename.split(os.sep)[-3:])
            where[f"{path}:{w.lineno}"] += 1
    return sum(where.values()) / len(ticks), where


def _device_ops(est, ticks):
    """(device operations per tick, busy ms, wall ms) of `ticks` played into
    est under torch.profiler (CUDA activity): kernels, copies and fills;
    busy is the union of their intervals, wall the profiled host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tick in ticks:
            _play(est, tick)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(spans) / len(ticks), busy / 1e3, wall * 1e3


def phase_fused_tick(calls):
    """Replays phase 7's estimator calls into fresh fused estimators: the
    graph replay against the eager fused tick over 3 steady ticks from one
    state; host syncs, device operations and the card's idle share per
    steady tick, fused against general."""
    import dataclasses
    import numpy as np
    import torch
    from esvio_tpu_torch.vio import estimator as est_mod
    pipe, ticks = calls
    ticks = [t for t in ticks if t]
    est = est_mod.Estimator(dataclasses.replace(pipe.est_cfg, fused=True),
                            *pipe._ex, pipe.device, imu_params=pipe._imu_params)
    k, warm = 0, 0
    while warm < 4:                               # 4 warm steady ticks
        warm += _steady(est)
        _play(est, ticks[k])
        k += 1
    blocks = [ticks[k + 3 * i:k + 3 * i + 3] for i in range(4)]
    if len(blocks[-1]) < 3:
        raise AssertionError(f"{len(ticks)} ticks: too few steady ones")

    # graph replay against the eager fused tick, from one state
    eager = _clone(est)
    eager._graphs = None
    worst = 0.0
    for tick in blocks[0]:
        if not _steady(est):
            raise AssertionError("phase 8 left the steady state")
        a, b = _play(est, tick), _play(eager, tick)
        for f in ("P", "Q", "V"):
            worst = max(worst, float(np.abs(getattr(a, f) - getattr(b, f)).max()))
        for f in ("marg_old", "n_trk", "n_drop_e", "fail", "num", "kf_ids",
                  "kf_obs", "kf_valid"):
            if not np.array_equal(est._post[f], eager._post[f]):
                raise AssertionError(f"graph replay and eager tick differ in {f}")
        if a.marg_flag != b.marg_flag:
            raise AssertionError("graph replay and eager tick: marg flags differ")
    if worst > 1e-6:
        raise AssertionError(f"graph replay vs eager tick: {worst:.3e} on P/Q/V")
    log(f"  graph replay vs eager fused tick, 3 steady ticks: max |diff| of "
        f"P, Q, V {worst:.3e}, integer post fields equal")

    # host syncs per steady tick
    general = _clone(est, fused=False)
    s_f, where_f = _syncs(est, blocks[1])
    s_g, where_g = _syncs(general, blocks[1])
    log(f"  host syncs per steady tick: fused {s_f:.2f} ({dict(where_f)}), "
        f"general {s_g:.2f} (top {where_g.most_common(6)})")

    # device operations, busy share, estimator ms per steady tick
    general = _clone(est, fused=False)
    n_f, busy_f, wall_f = _device_ops(est, blocks[2])
    n_g, busy_g, wall_g = _device_ops(general, blocks[2])
    seg_b = [0.0]
    real_b = est_mod._fused_segment_b

    def timed_b(*args):
        t1 = time.perf_counter()
        out = real_b(*args)
        torch.cuda.synchronize()
        seg_b[0] += time.perf_counter() - t1
        return out

    est_mod._fused_segment_b = timed_b
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tick in blocks[3]:
            _play(est, tick)
        torch.cuda.synchronize()
    finally:
        est_mod._fused_segment_b = real_b
    ms_f = (time.perf_counter() - t0) * 1e3 / 3
    log(f"  device operations per steady tick: fused {n_f:.0f}, general "
        f"{n_g:.0f}; busy {busy_f / 3:.1f} of {wall_f / 3:.1f} ms profiled "
        f"wall per tick (idle {1 - busy_f / wall_f:.1%}) fused, "
        f"{busy_g / 3:.1f} of {wall_g / 3:.1f} ms (idle "
        f"{1 - busy_g / wall_g:.1%}) general")
    log(f"  fused steady tick unprofiled {ms_f:.1f} ms (IMU feed, update_latest "
        f"included), of which segment B {seg_b[0] * 1e3 / 3:.1f} ms; idle "
        f"{1 - busy_f / 3 / ms_f:.1%} of it at the profiled busy time")
    if n_f == 0 or n_g == 0:
        raise AssertionError("the profiler saw no device operation")
    log("phase 8 fused tick: ok")


# ---------------------------------------------------------------- phase 6
def _texture_chunks(H, W, E, hz, ticks, device, disparity=0, sub=4):
    """Per tick, E events of a blob texture sliding 1 px per 1/(sub*hz) s:
    events sampled at the pixels its edges cross, polarity by the sign of
    the change; `disparity` shifts the view as a right camera would."""
    import numpy as np
    from esvio_tpu_torch.events import sae as sae_mod
    tex = _texture(H, W + sub * ticks + disparity + 2, seed=7)
    rng = np.random.default_rng(disparity + 1)
    view = lambda s: tex[:, s + disparity:s + disparity + W]
    out = []
    for k in range(ticks):
        ts, xs, ys, ps = [], [], [], []
        for j in range(sub):
            s = k * sub + j
            diff = view(s + 1) - view(s)
            yy, xx = np.nonzero(diff)
            ts.append(np.full(len(yy), 1.0 + (s + 1) / (sub * hz)))
            xs.append(xx)
            ys.append(yy)
            ps.append((diff[yy, xx] > 0).astype(np.int32))
        t, x, y, p = (np.concatenate(a) for a in (ts, xs, ys, ps))
        pick = np.sort(rng.integers(0, len(t), E))
        jitter = rng.uniform(-0.25, 0.0, E) / (sub * hz)
        out.append(sae_mod.chunk_from_arrays(
            np.sort(t[pick] + jitter), x[pick], y[pick], p[pick], capacity=E,
            device=device))
    return out


def _frontend_ms(device, H, W, E, hz, fx, dist=(0.0, 0.0, 0.0, 0.0), iters=10):
    """ms per event-tracker tick at (H, W) with E events per camera per
    tick, after a warm-up, on the tracker settings of bench.py."""
    import torch
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    cfg = trk.TrackerConfig(width=W, height=H, capacity=256,
                            cand_capacity=1024, max_cnt=150, min_dist=10)
    cam = camera.make_pinhole(fx, fx, W / 2, H / 2, dist, width=W, height=H,
                              device=device)
    ticks = iters + 3
    left = _texture_chunks(H, W, E, hz, ticks, device)
    right = _texture_chunks(H, W, E, hz, ticks, device, disparity=4)
    state = trk.init_state(cfg, device)
    for k in range(ticks):
        if k == 3:                                        # after the warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        state, pkt = trk.track_event_stereo(cfg, cam, cam, state, left[k],
                                            right[k], 1.0 + (k + 1) / hz)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / iters * 1e3
    if not torch.isfinite(pkt.un[pkt.valid]).all():
        raise AssertionError(f"front end {H}x{W}: non-finite feature")
    return ms, int(pkt.valid.sum())


def phase_frontend(device):
    ms, n = _frontend_ms(device, 260, 346, 1 << 16, 15, 226.38,
                         dist=(-0.048, 0.011, -0.0002, 0.0001))
    log(f"  DAVIS346 260x346, 65536 events/camera/tick: {ms:.2f} ms/tick "
        f"({n} tracked features)")
    ms2, n2 = _frontend_ms(device, 480, 640, 1 << 17, 10, 560.0)
    log(f"  DSEC 480x640, 131072 events/camera/tick: {ms2:.2f} ms/tick "
        f"({n2} tracked features)")
    if n == 0 or n2 == 0:
        raise AssertionError("the front end tracked no feature")
    log("phase 6 real-size front end: ok")


# ---------------------------------------------------------------- phase 9/10
def _solved(book):
    """Active lanes of a feature book with a valid depth."""
    return int((book.active & book.depth_valid).sum())


def _image_graphs(pipe):
    """(captures, replays, replays of keys with has_img=True / False) of
    the pipeline's fused-tick graphs."""
    caps, reps = _graph_use(pipe)
    by_key = pipe.estimator._graphs.replays_by_key()
    img = sum(n for kw, n in by_key if kw["has_img"])
    no_img = sum(n for kw, n in by_key if not kw["has_img"])
    return caps, reps, img, no_img


def phase_esvio_golden(device):
    """The ESVIO golden (tests/test_golden_trace.py:31-64, frames at 15 Hz)
    on the fused default."""
    import torch
    from synth_np import GOLDEN, golden_gates, vio_pipeline
    from esvio_tpu_torch import _kernels
    make_pipeline, seq, gt_t, gt_P = vio_pipeline(device, mode="esvio",
                                                    **GOLDEN)
    pipe = make_pipeline()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = _kernels.CORNER_MASK.launches
    k2 = _kernels.CHOL_SOLVE.launches
    g = golden_gates(res, gt_t, gt_P, GOLDEN_ESVIO_NPZ)
    ticks = res.metrics["ticks"]
    caps, reps, img, no_img = _image_graphs(pipe)
    est = pipe.estimator
    si, se = _solved(est.book_img), _solved(est.book_evt)
    log(f"  golden ESVIO 120x160 1.6 s, frames 15 Hz (fused): {ticks:.0f} ticks "
        f"in {wall:.2f} s ({ticks / wall:.2f} ticks/s, cold), {g['n_stamps']} "
        f"NON_LINEAR stamps (golden {g['n_golden']}), max dev "
        f"{g['max_dev_4dof']:.4f} m after yaw {g['yaw_deg']:.2f} deg + shift "
        f"{g['shift_m']:.4f} m (gate {ESVIO_GOLDEN_MAX_DEV_M} m, the JAX "
        f"package's own spread; {g['max_dev']:.4f} m unaligned, not gated: the "
        f"JAX package misses 0.05 m too), ATE {g['ate']:.4f} m (golden "
        f"{g['ate_golden']:.4f} m); solved lanes image {si}, event {se}; "
        f"launches K1 {k1}, K2 {k2}; fused-tick graphs: {caps} captured, "
        f"{reps} replays ({img} with a frame, {no_img} without)")
    if not g["stamps_ok"]:
        raise AssertionError("ESVIO golden: NON_LINEAR stamps differ")
    if not g["ate_ok"]:
        raise AssertionError(f"ESVIO golden: ATE {g['ate']:.4f} m > 1.5 x golden "
                             "+ 0.01")
    if not g["max_dev_4dof"] <= ESVIO_GOLDEN_MAX_DEV_M:
        raise AssertionError(f"ESVIO golden: max deviation {g['max_dev_4dof']:.4f}"
                             " m after the yaw + translation alignment")
    if si == 0 or se == 0:
        raise AssertionError(f"ESVIO golden: solved lanes image {si}, event {se}")
    if img == 0:
        raise AssertionError("ESVIO golden: no graph keyed has_img=True replayed")
    if k1 != ticks or k2 == 0:
        raise AssertionError(f"ESVIO golden: K1 launched {k1} times for "
                             f"{ticks:.0f} tracker ticks, K2 {k2} times")
    log("phase 9 ESVIO golden pipeline: ok")


def phase_esvio_bench(device):
    """ESVIO at the bench geometry (bench.py:330-357: 240x320, focal 320;
    1.6 s instead of 2.4 to keep the script's time) with frames rendered at
    480x640 (focal 640, the same field of view), which the pipeline resizes
    on the card to the image tracker's 240x320; one steady frame is
    dropped, so that tick takes the no-frame graph.  A cold run, then the
    warm run whose launches the JSON line reports."""
    import numpy as np
    import torch
    from synth_np import BENCH, vio_pipeline
    from esvio_tpu_torch import _kernels
    make_pipeline, seq, gt_t, gt_P = vio_pipeline(
        device, mode="esvio", img_H=480, img_W=640, **dict(BENCH, duration=1.6))
    drop = len(seq.images_left[0]) - 5
    for side in ("images_left", "images_right"):
        t_f, frames = getattr(seq, side)
        setattr(seq, side, (np.delete(t_f, drop), np.delete(frames, drop, 0)))
    make_pipeline().run(seq)                     # cold run: first launches
    pipe = make_pipeline()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    ticks = res.metrics["ticks"]
    n_nl = len(res.stamps)
    P = np.asarray(res.P)
    ate = res.ate(gt_t, gt_P) if n_nl else float("inf")
    caps, reps, img, no_img = _image_graphs(pipe)
    est = pipe.estimator
    si, se = _solved(est.book_img), _solved(est.book_evt)
    st = res.stage_times
    rate = ticks / wall
    log(f"  ESVIO 240x320 1.6 s, frames 480x640 at 15 Hz resized on the card "
        f"(fused, warm): {ticks:.0f} ticks, {n_nl} NON_LINEAR, ATE {ate:.4f} m, "
        f"{rate:.2f} ticks/s, realtime x{rate / 15.0:.3f} at 15 Hz; ms/tick "
        f"frontend_event {st['frontend_event']['mean_ms']:.1f}, frontend_image "
        f"{st['frontend_image']['mean_ms']:.1f} ({st['frontend_image']['n']} "
        f"frames), estimator {st['estimator']['mean_ms']:.1f}; solved lanes "
        f"image {si}, event {se}; launches {launches}; fused-tick graphs: "
        f"{caps} captured, {reps} replays ({img} with a frame, {no_img} without)")
    if n_nl == 0 or res.n_restarts or not np.isfinite(P).all():
        raise AssertionError(f"ESVIO 240x320: {n_nl} NON_LINEAR ticks, "
                             f"{res.n_restarts} restarts, finite {np.isfinite(P).all()}")
    if not ate < ESVIO_ATE_MAX_M:
        raise AssertionError(f"ESVIO 240x320: ATE {ate:.4f} m")
    if si == 0 or se == 0:
        raise AssertionError(f"ESVIO 240x320: solved lanes image {si}, event {se}")
    if img == 0 or no_img == 0:
        raise AssertionError(f"ESVIO 240x320: graph replays with a frame {img}, "
                             f"without {no_img}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the ESVIO path never ran: {launches}")
    log("phase 10 ESVIO 240x320 pipeline: ok")
    return launches, ticks


# ---------------------------------------------------------------- phase 11
def _image_frontend_ms(device, H, W, iters=8):
    """ms per image-tracker tick at (H, W) after two warm-up ticks, on the
    inputs and tracker settings of bench.py:277-311 (smoothed noise, views
    shifted (0, 0), (1, 2), (2, 4))."""
    import numpy as np
    import torch
    from numpy.lib.stride_tricks import sliding_window_view
    from esvio_tpu_torch.core import camera
    from esvio_tpu_torch.frontend import tracker as trk
    cfg = trk.TrackerConfig(width=W, height=H, capacity=256,
                            cand_capacity=1024, max_cnt=150, min_dist=30)
    cam = camera.make_pinhole(1100.0, 1100.0, W / 2, H / 2, width=W, height=H,
                              device=device)
    base = np.random.default_rng(3).uniform(0, 255, (H + 8, W + 8)) \
        .astype(np.float32)
    k = np.ones(25, np.float32) / 25
    sm = sliding_window_view(base, (5, 5)).reshape(H + 4, W + 4, 25) @ k
    frames = [torch.tensor(sm[dy:dy + H, dx:dx + W], device=device)
              for (dy, dx) in ((0, 0), (1, 2), (2, 4))]
    state = trk.init_image_state(cfg, device)
    for k_ in range(2):
        state, pkt = trk.track_image_stereo(cfg, cam, cam, state, frames[k_],
                                            frames[k_ + 1], 1.0 + k_ * 0.1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k_ in range(iters):
        state, pkt = trk.track_image_stereo(cfg, cam, cam, state,
                                            frames[k_ % 2], frames[k_ % 2 + 1],
                                            1.2 + k_ * 0.1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / iters * 1e3
    n = int(pkt.valid.sum())
    if n == 0 or not torch.isfinite(pkt.un[pkt.valid]).all():
        raise AssertionError(f"image front end {H}x{W}: {n} features, or "
                             "non-finite ones")
    return ms, n


def phase_image_frontend(device):
    for (H, W), label in (((260, 346), "DAVIS346"), ((1080, 1440), "DSEC")):
        ms, n = _image_frontend_ms(device, H, W)
        log(f"  image front end {label} {H}x{W}: {ms:.2f} ms/tick ({n} tracked "
            f"features)")
    log("phase 11 real-size image front end: ok")


# ---------------------------------------------------------------- phase 12/13
def _instrument_loops(pipe):
    """Count and time (synchronised) the loop closer's keyframe begins,
    commits and 4-DoF solves of a pipeline; returns the dict it fills."""
    import torch
    lc = pipe.loop_closer
    st = {k: [0, 0.0] for k in ("begin", "begun", "commit", "optimize")}

    def timed(name, real):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            st[name][0] += 1
            st[name][1] += time.perf_counter() - t0
            if name == "begin" and out is not None:
                st["begun"][0] += 1
            return out
        return run

    lc.begin_keyframe = timed("begin", lc.begin_keyframe)
    lc.commit_keyframe = timed("commit", lc.commit_keyframe)
    lc._optimize = timed("optimize", lc._optimize)
    return st


def _ms_per(st, name):
    n, s = st[name]
    return s / n * 1e3 if n else float("nan")


def _record_relo_route(pipe):
    """Per estimator tick: (took the relo solve, was a graph replay, ms of
    process_packets, synchronised)."""
    import torch
    est = pipe.estimator
    real = est.process_packets
    route = []

    def run(*args, **kw):
        relo0, rep0 = est.n_relo_solves, est._graphs.n_replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        route.append((est.n_relo_solves > relo0, est._graphs.n_replays > rep0,
                      (time.perf_counter() - t0) * 1e3))
        return out

    est.process_packets = run
    return route


def phase_loops(device):
    """tests/test_e2e_loops.py's configuration on the card (synth_np.
    loop_pipeline: ESIO 120x160, 3.6 s, smooth texture, IMU biases) with
    loop closure, fast relocalization and motion correction: this slice's
    main path.  Gates of that test, and at least one relocalization tick
    (the JAX package takes 5 on this configuration on the CPU, with motion
    correction; tests/jax_golden_spread.py loops 1), each followed by a
    graph replay once the window is steady again."""
    import torch
    from synth_np import loop_gates, loop_pipeline
    from esvio_tpu_torch import _kernels
    make_pipeline, seq, gt_t, gt_P = loop_pipeline(device, motion_correction=True)
    pipe = make_pipeline()
    st = _instrument_loops(pipe)
    route = _record_relo_route(pipe)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    g = loop_gates(res, gt_t, gt_P)
    ticks = res.metrics["ticks"]
    est = pipe.estimator
    relo_ticks = [k for k, r in enumerate(route) if r[0]]
    # the first steady tick after a relocalization tick replays its graph
    after = [route[k + 1][1] for k in relo_ticks
             if k + 1 < len(route) and not route[k + 1][0]]
    mean = lambda v: sum(v) / len(v) if v else float("nan")
    relo_ms = mean([r[2] for r in route if r[0]])
    replay_ms = mean([r[2] for r in route if r[1]])
    sm = res.stage_times
    log(f"  loops ESIO 120x160 3.6 s, loop closure + fast reloc + motion "
        f"correction (fused): {ticks:.0f} ticks in {wall:.2f} s "
        f"({ticks / wall:.2f} ticks/s, cold); ms/tick frontend_event "
        f"{sm['frontend_event']['mean_ms']:.1f}, estimator "
        f"{sm['estimator']['mean_ms']:.1f}; loop_closure "
        f"{sm['loop_closure']['mean_ms']:.1f} ms per call "
        f"({sm['loop_closure']['n']} calls); keyframes begun {st['begun'][0]}, "
        f"committed {st['commit'][0]}, 4-DoF solves {st['optimize'][0]}; "
        f"{g['loops']} loops; relocalization ticks {len(relo_ticks)} "
        f"(general path) at {relo_ticks}, the next steady tick a graph "
        f"replay {sum(after)} of {len(after)}; process_packets {relo_ms:.1f} "
        f"ms per relocalization tick, {replay_ms:.1f} ms per graph-replay "
        f"tick; graphs {est._graphs.n_captures} "
        f"captured, {est._graphs.n_replays} replays; launches {launches}")
    log(f"  gates (tests/test_e2e_loops.py:69-88): restarts {g['restarts']}, "
        f"{g['n_stamps']} NON_LINEAR stamps (>= 30), ATE {g['ate']:.4f} m "
        f"(< 0.3), loop ATE {g['ate_loop']:.4f} m (<= {g['ate_loop_gate']:.4f})")
    if not g["ok"]:
        raise AssertionError(f"loops: gates of tests/test_e2e_loops.py missed: {g}")
    if not relo_ticks or not all(after):
        raise AssertionError(f"loops: relocalization ticks {relo_ticks}, graph "
                             f"replays after them {after}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the loop path never ran: {launches}")
    log("phase 12 loop closure + relocalization + motion correction: ok")
    return launches, ticks


def phase_loops_bench(device, ref):
    """bench.py's pipeline_run exactly (bench.py:330-357: 240x320, focal 320,
    2.4 s, loop_closure=1, no fast relocalization, the fused default),
    against phase 5's loop-off run of the same geometry in this call:
    without fast relocalization the loops do not feed back into P, so the
    stamps are phase 5's and the ATE within 0.01 m of it (phase 7's
    tolerance between the two estimator paths)."""
    import numpy as np
    import torch
    from synth_np import BENCH, vio_pipeline
    from esvio_tpu_torch import _kernels
    make_pipeline, seq, gt_t, gt_P = vio_pipeline(
        device, loop_closure=1, sequence=ref["sequence"], **BENCH)
    pipe = make_pipeline()
    st = _instrument_loops(pipe)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    ticks = res.metrics["ticks"]
    n_nl = len(res.stamps)
    ate = res.ate(gt_t, gt_P) if n_nl else float("inf")
    rate = ticks / wall
    log(f"  ESIO 240x320 2.4 s with loop closure (bench.py pipeline_run; "
        f"fused): {ticks:.0f} ticks, {n_nl} NON_LINEAR, ATE {ate:.4f} m, "
        f"{rate:.2f} ticks/s against {ref['rate']:.2f} without loop closure "
        f"(phase 5, this call), realtime x{rate / 15.0:.3f}; ms/tick "
        f"frontend_event {res.stage_times['frontend_event']['mean_ms']:.1f}, "
        f"estimator {res.stage_times['estimator']['mean_ms']:.1f}; "
        f"loop_closure ms per keyframe begun {_ms_per(st, 'begin'):.2f} "
        f"({st['begun'][0]} of {st['begin'][0]}), per commit "
        f"{_ms_per(st, 'commit'):.2f} ({st['commit'][0]}, solves included), "
        f"per 4-DoF solve {_ms_per(st, 'optimize'):.2f} ({st['optimize'][0]}); "
        f"{res.n_loops} loops; launches {launches}")
    P = np.asarray(res.P)
    if n_nl != ref["n_nl"] or res.n_restarts or not np.isfinite(P).all():
        raise AssertionError(f"240x320 with loops: {n_nl} NON_LINEAR stamps "
                             f"(phase 5: {ref['n_nl']}), {res.n_restarts} restarts")
    if not abs(ate - ref["ate"]) <= 0.01:
        raise AssertionError(f"240x320 with loops: ATE {ate:.4f} m, phase 5 "
                             f"{ref['ate']:.4f} m")
    if st["begun"][0] == 0 or st["commit"][0] == 0:
        raise AssertionError("240x320 with loops: no keyframe reached the "
                             "loop closer")
    log("phase 13 240x320 pipeline with loop closure: ok")
    return launches, ticks


# ---------------------------------------------------------------- phase 14
def _drifting_loop_problem(rng, K, n_loops, drift_per_step=0.002):
    """tests/test_pose_graph_scale.py's problem in numpy: a square walked
    twice with drifting VIO, loop edges measuring the true relative pose."""
    import numpy as np
    from esvio_tpu_torch.core import lie_np
    side = max(4, K // 8)
    t_gt = np.zeros((K, 3))
    yaw_gt = np.zeros(K)
    p = np.zeros(3)
    yaw = 0.0
    for k in range(K):
        t_gt[k] = p
        yaw_gt[k] = yaw
        p = p + 0.05 * np.array([np.cos(np.deg2rad(yaw)),
                                 np.sin(np.deg2rad(yaw)), 0])
        if (k + 1) % side == 0:
            yaw += 90.0
    drift = np.cumsum(rng.normal(0, drift_per_step, (K, 3))
                      + [[drift_per_step, 0, 0]], 0)
    t_vio = t_gt + drift
    yaw_vio = yaw_gt + np.cumsum(rng.normal(0, 0.01, K) + 0.002)
    period = 4 * side
    li, lj, lt, ly = [], [], [], []
    for j in rng.choice(np.arange(period, K), min(n_loops, K - period),
                        replace=False):
        i = j - period
        Ri = lie_np.ypr_to_rot([yaw_gt[i], 0.0, 0.0])
        lt.append(Ri.T @ (t_gt[j] - t_gt[i]))
        ly.append(yaw_gt[j] - yaw_gt[i])
        li.append(i)
        lj.append(j)
    return yaw_vio, t_vio, np.array(li), np.array(lj), np.array(lt), np.array(ly)


def _graph_args(device, yaw, t, valid, first, li, lj, lt, ly, lv):
    import numpy as np
    import torch
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    K = len(yaw)
    return (f(yaw), f(t), f(np.zeros(K)), f(np.zeros(K)),
            torch.tensor(valid, device=device), i(first), i(li), i(lj), f(lt),
            f(ly), torch.tensor(lv, device=device))


def phase_pose_graph_and_motion(device):
    """optimize_4dof_cg at bench.py's bench_pose_graph shape
    (bench.py:391-420: 8192 padded nodes, 6144 live, 128 loop edges,
    iters=5, cg_iters=100): ms per solve (median of 3 after a warm-up)
    and host syncs per solve; CG against the dense solve on
    tests/test_pose_graph_scale.py:69-86's 256-node problem (yaw within
    0.05 deg, t within 0.01 m); motion_correct_chunk at 131,072 events
    (DSEC, 480x640) on the card against the same call on the CPU (at
    most 0.1 % of the warped pixels may differ, floor() of a float32
    quotient)."""
    import statistics
    import warnings
    import numpy as np
    import torch
    from esvio_tpu_torch.events import motion
    from esvio_tpu_torch.events import sae
    from esvio_tpu_torch.loop import pose_graph
    K = 1 << 13
    n = K - K // 4
    rng = np.random.default_rng(2)
    yaw = np.zeros(K)
    t = np.zeros((K, 3))
    yaw[:n] = np.cumsum(rng.normal(0, 0.05, n))
    t[:n] = np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    E = 128
    li = rng.integers(0, n // 2, E)
    lj = li + n // 2
    args = _graph_args(device, yaw, t, np.arange(K) < n, int(li.min()), li, lj,
                       rng.normal(0, 0.1, (E, 3)), rng.normal(0, 0.5, E),
                       np.ones(E, bool))
    solve = lambda: pose_graph.optimize_4dof_cg(*args, iters=5, cg_iters=100)
    out = solve()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = solve()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    moved = float((out[1] - args[1]).abs().max())
    log(f"  pose graph CG, {n} live of {K} nodes, {E} loop edges, 5 GN x 100 "
        f"CG iterations: {ms:.2f} ms per solve (median of {times}), "
        f"{syncs} host syncs per solve, finite {bool(torch.isfinite(out[1]).all())}, "
        f"poses moved up to {moved:.3f} m; under the reference's 2 s optimize "
        f"cadence: {ms < 2000.0}")
    if not torch.isfinite(out[1]).all() or not moved > 0:
        raise AssertionError("pose graph CG: non-finite or unmoved poses")

    K2 = 256
    yaw_v, t_v, li, lj, lt, ly = _drifting_loop_problem(
        np.random.default_rng(0), K2, n_loops=12)
    pad = lambda a, shape, dt: np.concatenate(
        [np.asarray(a, dt), np.zeros((32 - len(a),) + shape, dt)])
    lv = np.arange(32) < len(li)
    args = _graph_args(device, yaw_v, t_v, np.ones(K2, bool), int(li.min()),
                       pad(li, (), np.int64), pad(lj, (), np.int64),
                       pad(lt, (3,), float), pad(ly, (), float), lv)
    yd, td = pose_graph.optimize_4dof(*args, iters=5)
    yc, tc = pose_graph.optimize_4dof_cg(*args, iters=5, cg_iters=400)
    dyaw = float((((yc - yd) + 180.0) % 360.0 - 180.0).abs().max())
    dt_ = float((tc - td).abs().max())
    log(f"  pose graph CG against dense, 256 nodes, 12 loops, cg_iters 400: "
        f"yaw {dyaw:.2e} deg (< 0.05), t {dt_:.2e} m (< 0.01)")
    if not (dyaw < 0.05 and dt_ < 0.01):
        raise AssertionError(f"pose graph: CG and dense differ by {dyaw} deg, "
                             f"{dt_} m")

    H, W, N = 480, 640, 131072
    rng = np.random.default_rng(1)
    ts = np.sort(rng.uniform(1.0, 1.0 + 1 / 10, N))
    xs, ys = rng.integers(0, W, N), rng.integers(0, H, N)
    ps = rng.integers(0, 2, N)
    imu = dict(omega=np.float32([0.3, -0.5, 0.8]),
               v_cur=np.float32([0.4, -0.2, 0.1]),
               v_prev=np.float32([0.35, -0.25, 0.12]),
               accel=np.float32([0.5, 9.6, 1.2]))
    outs = {}
    for dev in (device, torch.device("cpu")):
        ch = sae.chunk_from_arrays(ts, xs, ys, ps, N, device=dev)
        call = lambda ch=ch, dev=dev: motion.motion_correct_chunk(
            ch, 570.0, 570.0, W / 2, H / 2,
            *(torch.from_numpy(imu[k]).to(dev) for k in imu), 1.0,
            width=W, height=H)
        outs[dev.type] = call()
        if dev.type == "cuda":
            warp_ms = _timed(call, reps=20)
    got, want = outs["cuda"], outs["cpu"]
    diff = int(((got.x.cpu() != want.x) | (got.y.cpu() != want.y)).sum())
    warped = int(((want.x != torch.from_numpy(xs.astype(np.int32)))
                  | (want.y != torch.from_numpy(ys.astype(np.int32)))).sum())
    log(f"  motion correction DSEC 480x640, {N} events: {warped} warped, "
        f"{diff} differ between the card and the CPU "
        f"({diff / N:.4%}, gate 0.1 %); {warp_ms:.3f} ms per chunk on the card")
    if diff > 1e-3 * N or warped < N // 2:
        raise AssertionError(f"motion correction: {diff} events differ, "
                             f"{warped} warped")
    log("phase 14 pose graph and motion correction at real size: ok")
    return ms, syncs


def _phase(fn, *args):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "esvio_tpu_torch")):
        print("chip_smoke: esvio_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import esvio_tpu_torch
    from esvio_tpu_torch import _kernels
    esvio_tpu_torch.disable_tf32()
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    peak_cmp = _phase(phase_device)
    k1 = _phase(phase_corner_mask, device, K1_SHAPES, (240, 320), peak_cmp)
    k2 = _phase(phase_chol, device)
    _phase(phase_golden, device)
    launches, run5 = _phase(phase_bench_pipeline, device)
    _phase(phase_frontend, device)
    calls = _phase(phase_general_pipeline, device, run5)
    _phase(phase_fused_tick, calls)
    _phase(phase_esvio_golden, device)
    launches_v, ticks_v = _phase(phase_esvio_bench, device)
    _phase(phase_image_frontend, device)
    launches_l, ticks_l = _phase(phase_loops, device)
    launches_lb, ticks_lb = _phase(phase_loops_bench, device, run5)
    _phase(phase_pose_graph_and_motion, device)

    # launches: the loop run of phase 12 (this slice's main path); beside
    # them the 240x320 run with loop closure (phase 13), the ESVIO bench
    # run (phase 10) and the ESIO one (phase 5)
    kernels = []
    for k, row in ((_kernels.CORNER_MASK, k1), (_kernels.CHOL_SOLVE, k2)):
        kernels.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches_l[k.name],
            launches_per_tick=launches_l[k.name] / ticks_l,
            launches_loops_240x320=launches_lb[k.name],
            launches_per_tick_loops_240x320=launches_lb[k.name] / ticks_lb,
            launches_esvio=launches_v[k.name],
            launches_per_tick_esvio=launches_v[k.name] / ticks_v,
            launches_esio=launches[k.name],
            launches_per_tick_esio=launches[k.name] / run5["ticks"], **row))
    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
