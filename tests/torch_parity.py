"""Shared helpers of the parity tests between esvio_tpu (JAX) and
esvio_tpu_torch (PyTorch): state converters in both directions, and the
torch thread cap for the suite's parallel workers.

State crosses between the two implementations as numpy arrays: a JAX
registered-dataclass pytree and its port dataclass have the same field
names, so `to_torch` / `to_jax` convert field by field (recursing into
nested states).  Converted: SAEState, EventChunk, TrackerState and
ImageTrackerState (with their PRNG keys), FeaturePacket, WindowState,
FeatureBook, Prior, Preintegrated, ImuParams, and CameraModel of every
kind (`camera_to_torch`, `camera_to_jax`); `window_args_to_torch`
and `window_args_to_jax` convert a window solve's arguments, batched
or not.  `np_render_for_jax` renders a synthetic sequence for the JAX
pipeline with the numpy renderer.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

# tier-1 runs several pytest workers; keep each worker's torch small
torch.set_num_threads(2)


def np_f32(x):
    return np.asarray(x, np.float32)


def _t(a, device="cpu"):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_torch(obj, cls, device="cpu"):
    """JAX pytree dataclass → port dataclass `cls` (same field names)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(obj, f.name):
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _convert_nested(v, device)
        elif isinstance(v, (tuple, list)):
            kw[f.name] = [tuple(_t(x, device) for x in lvl) for lvl in v]
        elif v is None or isinstance(v, (int, float, str)):
            kw[f.name] = v
        else:
            kw[f.name] = _t(v, device)
    return cls(**kw)


def _convert_nested(v, device):
    from esvio_tpu_torch.events import sae as tsae
    from esvio_tpu_torch.solver import window as twin
    name = type(v).__name__
    cls = {"SAEState": tsae.SAEState, "WindowState": twin.WindowState}[name]
    return to_torch(v, cls, device)


def to_jax(obj, cls):
    """Port dataclass → JAX pytree dataclass `cls` (same field names)."""
    import jax.numpy as jnp
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(obj, f.name):
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _to_jax_nested(v)
        elif isinstance(v, (tuple, list)):
            kw[f.name] = tuple(tuple(jnp.asarray(x.cpu().numpy()) for x in lvl)
                               for lvl in v)
        elif isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            if f.name == "key":
                a = a.astype(np.uint32)
            kw[f.name] = jnp.asarray(a)
        else:
            kw[f.name] = v
    return cls(**kw)


def _to_jax_nested(v):
    from esvio_tpu.events import sae as jsae
    from esvio_tpu.solver import window as jwin
    name = type(v).__name__
    cls = {"SAEState": jsae.SAEState, "WindowState": jwin.WindowState}[name]
    return to_jax(v, cls)


def np_render_for_jax(*a, **kw):
    """tests/synth.planar_vio_sequence_rot's sequence, rendered by
    synth_np.planar_vio_sequence_rot (the same arrays bit for bit, which
    test_torch_pipeline.py, test_torch_esvio.py and test_torch_no_jax.py
    hold it to) and handed to the JAX package's SequenceData: a stand-in for
    the JAX renderer with its arguments and returns (seq, gt_t, gt_P).  The
    two packages' EventStream, ImuStream and SequenceData hold the same
    numpy fields, so the sequence converts field by field."""
    import synth_np
    from esvio_tpu.io import datasets as jds

    def conv(v):
        if not dataclasses.is_dataclass(v):
            return v
        return getattr(jds, type(v).__name__)(
            **{f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)})

    seq, gt_t, gt_P = synth_np.planar_vio_sequence_rot(*a, **kw)
    return conv(seq), gt_t, gt_P


def camera_pair(fx, fy, cx, cy, width, height, dist=(0.0, 0.0, 0.0, 0.0),
                device="cpu"):
    """The same f32 pinhole camera in both implementations."""
    from esvio_tpu.core import camera as jcam
    from esvio_tpu_torch.core import camera as tcam
    import jax.numpy as jnp
    return (jcam.make_pinhole(fx, fy, cx, cy, dist, width, height,
                              dtype=jnp.float32),
            tcam.make_pinhole(fx, fy, cx, cy, dist, width, height,
                              device=device))


_CAMERA_FIELDS = ("fx", "fy", "cx", "cy", "dist", "xi", "poly", "inv_poly",
                  "affine")


def camera_to_torch(cam, device="cpu"):
    """JAX CameraModel (any kind) → the port's, float32."""
    from esvio_tpu_torch.core import camera as tcam
    return tcam.CameraModel(
        **{n: _t(np_f32(getattr(cam, n)), device) for n in _CAMERA_FIELDS},
        kind=cam.kind, width=cam.width, height=cam.height)


def camera_to_jax(cam):
    """The port's CameraModel (any kind) → JAX's, float32."""
    import jax.numpy as jnp
    from esvio_tpu.core import camera as jcam
    return jcam.CameraModel(
        **{n: jnp.asarray(np_f32(getattr(cam, n).cpu().numpy()))
           for n in _CAMERA_FIELDS},
        kind=cam.kind, width=cam.width, height=cam.height)


def chunk_pair(t, x, y, p, valid, device="cpu"):
    """The same f32 event chunk in both implementations."""
    import jax.numpy as jnp
    from esvio_tpu.events import sae as jsae
    from esvio_tpu_torch.events import sae as tsae
    arrs = (np_f32(t), np.asarray(x, np.int32), np.asarray(y, np.int32),
            np.asarray(p, np.int32), np.asarray(valid, bool))
    return (jsae.EventChunk(*(jnp.asarray(a) for a in arrs)),
            tsae.EventChunk(*(_t(a, device) for a in arrs)))


def window_args_to_torch(jargs, device="cpu"):
    """JAX (state, book_img, book_evt, preints, imu_valid, prior[, g]) →
    the port's, field by field; any leading batch axes (a vmapped or
    dp-sharded batch of windows) carry over as they are."""
    from esvio_tpu_torch.imu import preintegration as tpre
    from esvio_tpu_torch.solver import gauss_newton as tgn
    from esvio_tpu_torch.solver import window as twin
    classes = (twin.WindowState, twin.FeatureBook, twin.FeatureBook,
               tpre.Preintegrated, None, tgn.Prior, None)
    return tuple(_t(a, device) if cls is None else to_torch(a, cls, device)
                 for a, cls in zip(jargs, classes))


def window_args_to_jax(targs):
    """The port's (state, book_img, book_evt, preints, imu_valid, prior) →
    JAX's, with or without a leading batch axis."""
    import jax.numpy as jnp
    from esvio_tpu.imu import preintegration as jpre
    from esvio_tpu.solver import gauss_newton as jgn
    from esvio_tpu.solver import window as jwin
    classes = (jwin.WindowState, jwin.FeatureBook, jwin.FeatureBook,
               jpre.Preintegrated, None, jgn.Prior)
    return tuple(jnp.asarray(a.cpu().numpy()) if c is None else to_jax(a, c)
                 for a, c in zip(targs, classes))


def make_problem(L_img=8, L_evt=64):
    """Deterministic sliding-window problem (`__graft_entry__._make_problem`
    in f32) in both implementations: returns (jax_args, torch_args), each
    (state, book_img, book_evt, preints, imu_valid, prior, g)."""
    import jax.numpy as jnp
    from __graft_entry__ import _make_problem

    jargs = _make_problem(jnp.float32, L_img=L_img, L_evt=L_evt)
    return jargs, window_args_to_torch(jargs)


def estimator_to_torch(je, device="cpu"):
    """A port Estimator that starts from the JAX estimator `je`'s state
    and configuration (its `fused` choice included): window, both books
    (the image book with its live lanes), prior, IMU rings, host flags
    (whether an image packet was seen among them) and the online extrinsic
    calibration's state."""
    import copy
    from esvio_tpu_torch.solver import gauss_newton as tgn
    from esvio_tpu_torch.solver import window as twin
    from esvio_tpu_torch.vio import estimator as test_
    c = je.cfg
    te = test_.Estimator(
        test_.EstimatorConfig(
            mode=c.mode, evt_capacity=c.evt_capacity,
            img_capacity=c.img_capacity, imu_capacity=c.imu_capacity,
            min_parallax=c.min_parallax, g_norm=c.g_norm,
            solver_iters=c.solver_iters, cauchy_c=c.cauchy_c,
            min_track_for_kf=c.min_track_for_kf,
            estimate_extrinsic=c.estimate_extrinsic,
            ex_calib_require_stable=c.ex_calib_require_stable,
            estimate_td=c.estimate_td,
            use_stereo_correction=c.use_stereo_correction, fused=c.fused),
        np.asarray(je.ws.ex_p), np.asarray(je.ws.ex_q), device)
    te.ws = to_torch(je.ws, twin.WindowState, device)
    te.book_img = to_torch(je.book_img, twin.FeatureBook, device)
    te.book_evt = to_torch(je.book_evt, twin.FeatureBook, device)
    te.prior = to_torch(je.prior, tgn.Prior, device)
    for name in ("frame_count", "solver_flag", "timestamps", "imu_dt",
                 "imu_acc", "imu_gyr", "imu_n", "acc0", "gyr0", "first_imu",
                 "last_marg", "failures", "_prior_valid", "_seen_img", "n_solves",
                 "lanes_dropped", "_post", "_latest", "_imu_replay",
                 "_calib_pairs", "_ex_calib_done", "_ex_calib_stable",
                 "_ex_calib_last_q"):
        setattr(te, name, copy.deepcopy(getattr(je, name)))
    te._update_stereo_extrinsics()
    return te


def jax_general_estimator(ex_p, ex_q, cfg_kw):
    """A JAX Estimator on its general path (fused=False) with the
    EstimatorConfig keywords cfg_kw."""
    from esvio_tpu.vio import estimator as jest
    return jest.Estimator(jest.EstimatorConfig(fused=False, **cfg_kw), ex_p,
                          ex_q)


@contextlib.contextmanager
def jax_marginalization_f64():
    """The JAX package's marginalization with its two eigendecompositions
    taken in float64 and returned in the input dtype, as the port takes them
    (esvio_tpu_torch/solver/marginalization.py, `_eigh`); the JAX package
    itself is unchanged.  Inside the context, esvio_tpu.solver.
    marginalization's `jnp` is a namespace whose `linalg.eigh` casts to
    float64 and back, and its entry points are fresh copies of the jitted
    functions (jax caches traces per function object)."""
    import jax
    import jax.numpy as jnp
    from esvio_tpu.solver import marginalization as jmarg

    def eigh64(A):
        w, V = jnp.linalg.eigh(A.astype(jnp.float64))
        return w.astype(A.dtype), V.astype(A.dtype)

    jnp64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    jnp64.linalg = types.SimpleNamespace(eigh=eigh64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmarg, "jnp", jnp64)
        for name in ("marginalize_old", "marginalize_second_new"):
            f = getattr(jmarg, name).__wrapped__
            mp.setattr(jmarg, name, jax.jit(types.FunctionType(
                f.__code__, f.__globals__, name, f.__defaults__, f.__closure__)))
        yield


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
