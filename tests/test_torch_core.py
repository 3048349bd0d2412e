"""Parity: esvio_tpu_torch.core (lie, pinhole camera) against esvio_tpu.core
on the inputs of tests/test_lie.py and tests/test_camera.py, all in float32
on both sides.  Tolerance: float32 round-off (atol 1e-5 on unit-scale
values, 2e-3 px on pixels)."""
import numpy as np
import jax.numpy as jnp
import torch

from torch_parity import camera_pair, np_f32
from esvio_tpu.core import camera as jcam
from esvio_tpu.core import lie as jlie
from esvio_tpu_torch.core import camera as tcam
from esvio_tpu_torch.core import lie as tlie


def random_quat(rng, n):
    q = rng.normal(size=(n, 4))
    return np_f32(q / np.linalg.norm(q, axis=-1, keepdims=True))


def _both(fn_name, *arrays):
    j = np.asarray(getattr(jlie, fn_name)(*(jnp.asarray(a) for a in arrays)))
    t = getattr(tlie, fn_name)(*(torch.tensor(a) for a in arrays)).numpy()
    return j, t


def test_lie_quaternion_ops_match(rng):
    q = random_quat(rng, 32)
    p = random_quat(rng, 32)
    v = np_f32(rng.normal(size=(32, 3)))
    for name, args in (("quat_mul", (q, p)), ("quat_rotate", (q, v)),
                       ("quat_to_rot", (q,)), ("quat_inv", (q,)),
                       ("delta_q", (v,)), ("skew", (v,)), ("quat_exp", (v,))):
        j, t = _both(name, *args)
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=name)


def test_lie_rotation_maps_match(rng):
    q = random_quat(rng, 32)
    R = np.asarray(jlie.quat_to_rot(jnp.asarray(q)))
    w = np_f32(rng.normal(size=(32, 3)) * 0.5)
    for name, arg in (("rot_to_quat", R), ("so3_exp", w), ("so3_log", R),
                      ("rot_to_ypr", R)):
        j, t = _both(name, arg)
        atol = 2e-3 if name == "rot_to_ypr" else 1e-5   # degrees
        np.testing.assert_allclose(t, j, atol=atol, err_msg=name)
    ypr = np_f32(rng.uniform(-80, 80, size=(32, 3)))
    j, t = _both("ypr_to_rot", ypr)
    np.testing.assert_allclose(t, j, atol=1e-5)
    g = np_f32(rng.normal(size=3) + np.array([0, 0, 9.8]))
    j, t = _both("g2R", g)
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_pinhole_lift_and_project_match(rng):
    jc, tc = camera_pair(263.8, 263.7, 176.9, 122.9, 346, 260,
                         dist=(-0.387, 0.153, -4.5e-4, 7.9e-5))
    pts = rng.uniform(-0.4, 0.4, size=(64, 2))
    xyz = np_f32(np.concatenate([pts, np.ones((64, 1))], axis=1))
    uv_j = np.asarray(jcam.space_to_plane(jc, jnp.asarray(xyz)))
    uv_t = tcam.space_to_plane(tc, torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=2e-3)
    uv = np_f32(uv_j)
    ray_j = np.asarray(jcam.lift_projective(jc, jnp.asarray(uv)))
    ray_t = tcam.lift_projective(tc, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(ray_t, ray_j, atol=1e-5)
