"""Checkpoint / resume of the whole VIO estimator state (port of
esvio_tpu/vio/checkpoint.py).

The reference only persists the pose graph (savePoseGraph/loadPoseGraph,
pose_graph.cpp:705-830); here the whole estimator checkpoints into one npz:
window states, feature books, the marginalization prior (with its
linearization point), the IMU buffers and the bookkeeping scalars, so a
session can stop and continue bit for bit mid-sequence.

The file carries the JAX package's keys (`ws.*`, `book_img.*`,
`book_evt.*`, `prior.*`, the IMU buffers, the scalars), so each package
loads the other's file.  The state that only the port keeps (the failure
and solve counters, the online extrinsic calibration, the pending
relocalization, the IMU-rate state and the last tick's fetched window)
goes under the top-level prefix `torch.`, which the JAX loader does not
read; a file without it (one the JAX package wrote) loads with that state
at its fresh-estimator values.

An estimator whose fused-tick CUDA graphs are already captured holds its
window, books and prior in the graphs' static buffers: a load copies the
loaded state into those buffers (`TickGraphs.adopt`), so the next steady
tick replays the captured graph on the loaded state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from esvio_tpu_torch.solver import gauss_newton as gn
from esvio_tpu_torch.solver import window as win
from esvio_tpu_torch.vio.estimator import Estimator

_PORT = "torch."
_POST = ("P", "Q", "V", "Ba", "Bg")
_LATEST = ("P", "Q", "V", "Ba", "Bg", "acc", "gyr")
_RELO = ("ids", "un", "P", "Q")


def _flatten(prefix, tree, out):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(f"{prefix}{f.name}.", getattr(tree, f.name), out)
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy()


def _rebuild(cls, prefix, data, dtype, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        arr = data[f"{prefix}{f.name}"]
        kwargs[f.name] = torch.as_tensor(
            arr, dtype=dtype if arr.dtype.kind == "f" else None, device=device)
    return cls(**kwargs)


def save_estimator(est: Estimator, path):
    out = {}
    _flatten("ws.", est.ws, out)
    _flatten("book_img.", est.book_img, out)
    _flatten("book_evt.", est.book_evt, out)
    _flatten("prior.", est.prior, out)
    out["frame_count"] = est.frame_count
    out["solver_flag"] = {"INITIAL": 0, "NON_LINEAR": 1}[est.solver_flag]
    out["timestamps"] = est.timestamps
    out["imu_dt"] = est.imu_dt
    out["imu_acc"] = est.imu_acc
    out["imu_gyr"] = est.imu_gyr
    out["imu_n"] = est.imu_n
    out["acc0"] = est.acc0
    out["gyr0"] = est.gyr0
    out["first_imu"] = est.first_imu

    p = _PORT
    for name in ("last_marg", "failures", "n_solves", "n_relo_solves",
                 "lanes_dropped"):
        out[p + name] = getattr(est, name)
    out[p + "prior_valid"] = est._prior_valid
    out[p + "seen_img"] = est._seen_img
    out[p + "ex_calib_done"] = est._ex_calib_done
    out[p + "ex_calib_stable"] = est._ex_calib_stable
    out[p + "calib_pairs"] = np.asarray(est._calib_pairs, float).reshape(-1, 2, 4)
    if est._ex_calib_last_q is not None:
        out[p + "ex_calib_last_q"] = est._ex_calib_last_q
    if est._post is not None:
        for n in _POST:
            out[f"{p}post.{n}"] = est._post[n]
    if est._latest is not None:
        out[p + "latest.t"] = est._latest["t"]
        for n in _LATEST:
            out[f"{p}latest.{n}"] = est._latest[n]
    rep = est._imu_replay
    out[p + "imu_replay.t"] = np.asarray([r[0] for r in rep], float)
    out[p + "imu_replay.acc"] = np.asarray([r[1] for r in rep], float).reshape(-1, 3)
    out[p + "imu_replay.gyr"] = np.asarray([r[2] for r in rep], float).reshape(-1, 3)
    if est._relo is not None:
        out[p + "relo.stamp"] = est._relo["stamp"]
        for n in _RELO:
            out[f"{p}relo.{n}"] = est._relo[n]
    np.savez_compressed(path, **out)


def load_estimator(est: Estimator, path):
    """Restore the state in place into an Estimator of the same config,
    freshly built or already run."""
    z = dict(np.load(path, allow_pickle=False).items())
    dt, dev = est.cfg.dtype, est.device
    ws = _rebuild(win.WindowState, "ws.", z, dt, dev)
    book_img = _rebuild(win.FeatureBook, "book_img.", z, dt, dev)
    book_evt = _rebuild(win.FeatureBook, "book_evt.", z, dt, dev)
    prior = gn.Prior(
        J0=torch.as_tensor(z["prior.J0"], dtype=dt, device=dev),
        r0=torch.as_tensor(z["prior.r0"], dtype=dt, device=dev),
        lin=_rebuild(win.WindowState, "prior.lin.", z, dt, dev),
        valid=torch.as_tensor(z["prior.valid"], device=dev))
    state = (ws, book_img, book_evt, prior)
    if est._graphs is not None and est._graphs.state is not None:
        state = est._graphs.adopt(state)     # the captured graphs' buffers
    est.ws, est.book_img, est.book_evt, est.prior = state
    est.frame_count = int(z["frame_count"])
    est.solver_flag = ["INITIAL", "NON_LINEAR"][int(z["solver_flag"])]
    est.timestamps = z["timestamps"].copy()
    est.imu_dt = z["imu_dt"].copy()
    est.imu_acc = z["imu_acc"].copy()
    est.imu_gyr = z["imu_gyr"].copy()
    est.imu_n = z["imu_n"].copy()
    est.acc0 = z["acc0"].copy()
    est.gyr0 = z["gyr0"].copy()
    est.first_imu = bool(z["first_imu"])
    est._update_stereo_extrinsics()

    p = _PORT
    get = lambda name, default: z[p + name] if p + name in z else default
    est._prior_valid = bool(get("prior_valid", z["prior.valid"]))
    est.last_marg = int(get("last_marg", 0))
    for name in ("failures", "n_solves", "n_relo_solves", "lanes_dropped"):
        setattr(est, name, int(get(name, 0)))
    est._seen_img = bool(get("seen_img", False))
    est._ex_calib_done = bool(get("ex_calib_done",
                                  est.cfg.estimate_extrinsic != 2))
    est._ex_calib_stable = int(get("ex_calib_stable", 0))
    est._calib_pairs = [(a.copy(), b.copy())
                        for a, b in get("calib_pairs", np.zeros((0, 2, 4)))]
    q = get("ex_calib_last_q", None)
    est._ex_calib_last_q = None if q is None else q.copy()
    est._post = {n: z[f"{p}post.{n}"].copy() for n in _POST} \
        if f"{p}post.P" in z else None
    est._latest = None
    if p + "latest.t" in z:
        est._latest = dict(t=float(z[p + "latest.t"]),
                           **{n: z[f"{p}latest.{n}"].copy() for n in _LATEST})
    est._imu_replay = [
        (float(t), a.copy(), w.copy()) for t, a, w in zip(
            get("imu_replay.t", ()), get("imu_replay.acc", ()),
            get("imu_replay.gyr", ()))]
    est._relo = None
    if p + "relo.stamp" in z:
        est._relo = dict(stamp=float(z[p + "relo.stamp"]),
                         **{n: z[f"{p}relo.{n}"].copy() for n in _RELO})
    return est
