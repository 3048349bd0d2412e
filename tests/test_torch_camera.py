"""Parity: the port's camera layer (`core/camera`: pinhole, Kannala-Brandt,
MEI and Scaramuzza, each with its lift and its projection) and its YAML
config layer (`io/config`: the OpenCV FileStorage loader, `load_camera_yaml`,
`load_config`) against the JAX package, float32 on both sides.

Lift and projection on 1,000 pixels and 1,000 points per model: rays within
1e-5 in normalized coordinates, pixels within 1e-3 px.  The loaders on
reference-style YAML files written as tests/test_run_cli.py writes them:
every SystemConfig field equal (extrinsics to float64 rounding), every
camera field equal.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import synth_np
from torch_parity import camera_to_jax, camera_to_torch, np_f32
from esvio_tpu.core import camera as jcam
from esvio_tpu.io import config as jcfg
from esvio_tpu_torch.core import camera as tcam
from esvio_tpu_torch.io import config as tcfg

W, H = 346, 260


CAMERAS = {k: synth_np.camera_model_params(
    k, *((640, 480) if k == "SCARAMUZZA" else (W, H)))
    for k in synth_np.CAMERA_KINDS}


def _camera_pair(kind, tmp_path):
    """The same camera through both loaders from one YAML file."""
    size = (640, 480) if kind == "SCARAMUZZA" else (W, H)
    path = tmp_path / f"{kind.lower()}.yaml"
    path.write_text(synth_np.camera_yaml_text(kind, *size, **CAMERAS[kind]))
    return jcfg.load_camera_yaml(str(path)), tcfg.load_camera_yaml(str(path))


def _pixels(cam, n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return np_f32(np.stack([rng.uniform(0, cam.width, n),
                            rng.uniform(0, cam.height, n)], -1))


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_camera_yaml_loads_the_same_camera(kind, tmp_path):
    jc, tc = _camera_pair(kind, tmp_path)
    assert tc.kind == jc.kind and tc.width == jc.width and tc.height == jc.height
    for name in ("fx", "fy", "cx", "cy", "dist", "xi", "poly", "inv_poly",
                 "affine"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_lift_projective_matches(kind, tmp_path):
    jc, tc = _camera_pair(kind, tmp_path)
    uv = _pixels(tc)
    jr = np.asarray(jcam.lift_projective(jc, jnp.asarray(uv)))
    tr = tcam.lift_projective(tc, torch.tensor(uv)).numpy()
    assert np.isfinite(tr).all() and (tr[:, 2] == 1.0).all()
    np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_space_to_plane_matches(kind, tmp_path):
    jc, tc = _camera_pair(kind, tmp_path)
    # points in front of the camera along the lifted rays, at 1-8 m
    rng = np.random.default_rng(1)
    rays = tcam.lift_projective(tc, torch.tensor(_pixels(tc, seed=2))).numpy()
    xyz = np_f32(rays * rng.uniform(1.0, 8.0, (len(rays), 1)))
    jp = np.asarray(jcam.space_to_plane(jc, jnp.asarray(xyz)))
    tp = tcam.space_to_plane(tc, torch.tensor(xyz)).numpy()
    assert np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
    # and the projection inverts the lift (within 0.1 px: the pinhole's
    # eight fixed-point steps leave ~0.05 px at the corners at k1 = -0.28);
    # not the Scaramuzza lift's, whose ray keeps the affine-distorted
    # (xc, yc) as the JAX function's does
    if kind != "SCARAMUZZA":
        np.testing.assert_allclose(tp, _pixels(tc, seed=2), atol=0.1, rtol=0)


def test_scaramuzza_degree14_float64_matches():
    """A wide-lens OCam calibration's shape: the forward polynomial of
    tests/test_camera.py and a degree-14 inverse polynomial over the whole
    640x480 image, both cameras built in float64 (in float32 such a
    polynomial loses whole pixels to rounding in either implementation, so
    only float64 tells a wrong coefficient order from conditioning).  Rays
    within 1e-9, pixels within 1e-6 px, and the projection inverts the lift
    within 0.5 px, the fit's own bound, inside the box of
    tests/test_camera.py (outside ~335 px from the center the lens sees
    past 90° and the z = 1 normalized ray loses its side)."""
    Wd, Hd = 640, 480
    poly = np.array([-216.9657476318, 0.0, 0.0017866911, -0.0000019866,
                     0.0000000077])
    rho = np.arange(0.0, np.hypot(Wd, Hd) / 2 * 1.05, 0.1)
    theta = np.arctan2(sum(poly[k] * rho ** k for k in range(5)), rho)
    inv_poly = np.polynomial.polynomial.polyfit(theta, rho, 14)
    assert len(inv_poly) == 15 and inv_poly[14] != 0.0
    kw = dict(cx=Wd / 2 + 3.5, cy=Hd / 2 - 2.25, affine=(1.0005, 0.0008, -0.0006),
              width=Wd, height=Hd)
    jc = jcam.make_scaramuzza(poly, inv_poly, dtype=jnp.float64, **kw)
    tc = tcam.make_scaramuzza(poly, inv_poly, dtype=torch.float64, **kw)
    rng = np.random.default_rng(3)
    uv = np.stack([rng.uniform(0, Wd, 1000), rng.uniform(0, Hd, 1000)], -1)
    jr = np.asarray(jcam.lift_projective(jc, jnp.asarray(uv)))
    tr = tcam.lift_projective(tc, torch.tensor(uv)).numpy()
    assert tr.dtype == np.float64 and np.isfinite(tr).all()
    np.testing.assert_allclose(tr, jr, atol=1e-9, rtol=0)
    xyz = tr * rng.uniform(1.0, 8.0, (len(tr), 1))
    jp = np.asarray(jcam.space_to_plane(jc, jnp.asarray(xyz)))
    tp = tcam.space_to_plane(tc, torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
    # the lift keeps the affine-distorted offsets, so invert on an
    # affine-free copy
    kw["affine"] = (1.0, 0.0, 0.0)
    tc0 = tcam.make_scaramuzza(poly, inv_poly, dtype=torch.float64, **kw)
    uv_in = uv[(uv[:, 0] > 80) & (uv[:, 0] < Wd - 80) & (uv[:, 1] > 60)
               & (uv[:, 1] < Hd - 60)]
    back = tcam.space_to_plane(tc0, tcam.lift_projective(tc0,
                                                         torch.tensor(uv_in)))
    assert len(uv_in) > 400 and np.abs(back.numpy() - uv_in).max() < 0.5


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_camera_converters_round_trip(kind, tmp_path):
    jc, tc = _camera_pair(kind, tmp_path)
    back = camera_to_torch(camera_to_jax(tc))
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(back, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    again = camera_to_jax(camera_to_torch(jc))
    assert again.kind == jc.kind
    np.testing.assert_array_equal(np.asarray(again.inv_poly),
                                  np.asarray(jc.inv_poly))


def _config_fields_equal(jc, tc):
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "cameras":
            assert set(a) == set(b)
            for k in a:
                assert b[k].kind == a[k].kind
                np.testing.assert_array_equal(b[k].fx.numpy(), np.asarray(a[k].fx))
                np.testing.assert_array_equal(b[k].dist.numpy(),
                                              np.asarray(a[k].dist))
        elif isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-15, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


@pytest.mark.parametrize("variant", ["body_T", "Rrl_inverted"])
def test_load_config_matches(variant, tmp_path):
    """load_config on a reference-style esvio.yaml with four camera YAMLs of
    all four kinds; "Rrl_inverted" gives the left extrinsics as R + T with
    T_camera_imu / T_event_imu set and the right ones by Rrl / Trl."""
    R = synth_np.so3_exp(np.array([0.1, -0.2, 0.05]))
    cfg = tcfg.SystemConfig(
        system_mode=1, event_width=W, event_height=H, image_width=W,
        image_height=H, R_body_cam0=R, t_body_cam0=np.array([0.01, 0.02, 0.0]),
        R_body_cam1=R, t_body_cam1=np.array([0.11, 0.02, 0.0]),
        R_body_event0=R.T, t_body_event0=np.zeros(3), R_body_event1=R.T,
        t_body_event1=np.array([0.1, 0.0, 0.0]), estimate_extrinsic=2,
        max_cnt=120, freq=20, ignore_polarity=True, do_motion_correction=True,
        gyr_w=4.0e-5, loop_closure=1, fast_relocalization=1,
        output_path="/tmp/out dir")
    text = synth_np.config_yaml_text(cfg, {})
    kinds = dict(cam0="PINHOLE", cam1="KANNALA_BRANDT", event0="MEI",
                 event1="SCARAMUZZA")
    for name, kind in kinds.items():
        size = (640, 480) if kind == "SCARAMUZZA" else (W, H)
        (tmp_path / f"{name}.yaml").write_text(
            synth_np.camera_yaml_text(kind, *size, **CAMERAS[kind]))
    calib = "".join(f'{k}: "{n}.yaml"\n' for k, n in (
        ("cam_left_calib", "cam0"), ("cam_right_calib", "cam1"),
        ("event_left_calib", "event0"), ("event_right_calib", "event1")))
    text = text.replace("---\n", "---\n" + calib, 1)
    if variant == "Rrl_inverted":
        text = text.split("body_T_cam0:")[0]    # drop the 4x4 blocks
        Rc, tc_ = R.T, -R.T @ np.array([0.01, 0.02, 0.0])
        Rrl = synth_np.so3_exp(np.array([0.0, 0.01, 0.0]))
        text += "T_camera_imu: 1\nT_event_imu: 1\n# left extrinsics as x_T_body\n"
        text += synth_np._matrix_yaml("extrinsicRotation", Rc)
        text += synth_np._matrix_yaml("extrinsicTranslation", tc_[:, None])
        text += synth_np._matrix_yaml("extrinsicRotation_event", R)
        text += synth_np._matrix_yaml("extrinsicTranslation_event",
                                      np.zeros((3, 1)))
        text += synth_np._matrix_yaml("Rrl", Rrl)
        text += synth_np._matrix_yaml("Trl", np.array([[-0.1, 0.0, 0.001]]))
        text += synth_np._matrix_yaml("Rrl_event", Rrl.T)
        text += synth_np._matrix_yaml("Trl_event", np.array([[-0.1], [0], [0]]))
    path = tmp_path / "esvio.yaml"
    path.write_text(text)
    jc = jcfg.load_config(str(path))
    tc = tcfg.load_config(str(path))
    _config_fields_equal(jc, tc)
    assert tc.estimate_extrinsic == 2 and len(tc.cameras) == 4
    ep_j, eq_j = jcfg.extrinsic_arrays(jc)
    ep_t, eq_t = tcfg.extrinsic_arrays(tc)
    np.testing.assert_allclose(ep_t, ep_j, atol=1e-12)
    np.testing.assert_allclose(eq_t, eq_j, atol=1e-12)


def test_vio_pipeline_config_round_trip(tmp_path):
    """The golden pipeline's configuration written as YAML files and read
    back (synth_np.vio_pipeline(config_dir=...)) is the in-code one."""
    make_a, *_ = synth_np.vio_pipeline("cpu", **synth_np.GOLDEN,
                                       mode="esvio", sequence=(None,) * 3)
    make_b, *_ = synth_np.vio_pipeline("cpu", **synth_np.GOLDEN, mode="esvio",
                                       sequence=(None,) * 3,
                                       config_dir=str(tmp_path))
    a, b = make_a(), make_b()
    for f in dataclasses.fields(a.sys_cfg):
        x, y = getattr(a.sys_cfg, f.name), getattr(b.sys_cfg, f.name)
        if f.name == "cameras" or f.name.endswith("_calib"):
            continue                   # the YAML route names its camera files
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, f.name)
        else:
            assert x == y, (f.name, x, y)
    assert set(a.cams) == set(b.cams)
    for k in a.cams:
        for name in ("fx", "fy", "cx", "cy", "dist", "xi", "poly", "inv_poly",
                     "affine"):
            assert torch.equal(getattr(a.cams[k], name),
                               getattr(b.cams[k], name)), (k, name)


@pytest.fixture(scope="module")
def short_loop_sequence():
    return synth_np.loop_pipeline("cpu", duration=0.3, motion_correction=True)


@pytest.mark.parametrize("kind", ["KANNALA_BRANDT", "MEI", "SCARAMUZZA"])
def test_pipeline_runs_with_camera_kind(kind, tmp_path, short_loop_sequence):
    """Pipeline with event cameras of each non-pinhole kind, loaded from
    their YAML files: the tracker's lift, motion correction (the third tick
    warps its events) and the loop closer's camera, three ticks on the
    CPU; and a loaded config with estimate_extrinsic: 2."""
    from esvio_tpu_torch.apps.pipeline import Pipeline
    make_pipeline, seq, _, _ = short_loop_sequence
    ref = make_pipeline()
    cam = tcfg.load_camera_yaml(synth_np.write_camera_yaml(
        str(tmp_path), kind, 160, 120))
    pipe = Pipeline(dataclasses.replace(ref.sys_cfg, estimate_extrinsic=2),
                    {"event0": cam, "event1": cam}, "cpu",
                    tracker_cfg=ref.tracker_cfg, est_cfg=None,
                    event_capacity=ref.event_capacity)
    assert pipe.est_cfg.estimate_extrinsic == 2
    assert not pipe.estimator._ex_calib_done
    assert pipe.loop_closer is not None and pipe.cams["event0"].kind == cam.kind
    res = pipe.run(seq, max_frames=3)
    assert res.metrics["ticks"] == 3 and pipe._last_v is not None
