"""Port parity of apps/calib.py and apps/chessboard.py against
esvio_tpu.apps.calib / chessboard on tests/test_calib.py's synthetic views
(tests/synth_np.calib_observations, the ground-truth cameras rendered by
the JAX camera model), float64, and the port's YAML writers: byte-equal
files for the same result, read back by its own load_camera_yaml."""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads)
import synth_np

MODELS = ("pinhole", "kb", "mei", "scara")
FN = dict(pinhole="calibrate_pinhole", kb="calibrate_kb",
          mei="calibrate_mei", scara="calibrate_scaramuzza")
WRITER = dict(pinhole="write_camera_yaml", kb="write_camera_yaml_kb",
              mei="write_camera_yaml_mei", scara="write_camera_yaml_scara")
INTRINSICS = dict(pinhole=("fx", "fy", "cx", "cy", "dist"),
                  kb=("mu", "mv", "u0", "v0", "ks"),
                  mei=("gamma1", "gamma2", "u0", "v0", "xi", "dist"),
                  scara=("poly", "inv_poly", "cx", "cy", "affine"))


def _jax_camera(model):
    import jax.numpy as jnp
    from esvio_tpu.apps import calib as jcal
    from esvio_tpu.core import camera as jcam
    gt = synth_np.CALIB_GT[model]
    kw = dict(width=640, height=480, dtype=jnp.float64)
    if model == "pinhole":
        return jcam.make_pinhole(gt["fx"], gt["fy"], gt["cx"], gt["cy"],
                                 dist=tuple(gt["dist"]), **kw)
    if model == "kb":
        return jcam.make_equidistant(gt["mu"], gt["mv"], gt["u0"], gt["v0"],
                                     ks=tuple(gt["ks"]), **kw)
    if model == "mei":
        return jcam.make_mei(gt["xi"], gt["gamma1"], gt["gamma2"], gt["u0"],
                             gt["v0"], dist=tuple(gt["dist"]), **kw)
    inv = jcal.fit_inv_poly(gt["poly"], max_radius=np.hypot(gt["cx"], gt["cy"]))
    return jcam.make_scaramuzza(gt["poly"], inv, cx=gt["cx"], cy=gt["cy"], **kw)


@pytest.fixture(scope="module")
def runs():
    """Every JAX-side run of this file: the four calibrations, and the
    chessboard detection of tests/test_calib.py's rendered board."""
    import jax.numpy as jnp
    from esvio_tpu.apps import calib as jcal
    from esvio_tpu.apps import chessboard as jcb
    from esvio_tpu.core import camera as jcam
    out = {}
    for model in MODELS:
        cam = _jax_camera(model)
        obj, img = synth_np.calib_observations(
            lambda pc: np.asarray(jcam.space_to_plane(cam, jnp.asarray(pc))))
        out[model] = (obj, img, getattr(jcal, FN[model])(obj, img))
    img, gt = synth_np.render_chessboard(5, 7, rng=np.random.default_rng(0))
    out["board"] = (img, gt, jcb.detect_saddles(img, max_corners=70),
                    jcb.find_chessboard(img, 5, 7))
    return out


def _rel(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("model", MODELS[:3])
def test_calibration_matches_jax(runs, model):
    """Pinhole, KB and MEI: every intrinsic, the rms and the per-view poses
    within 1e-6 relative of the JAX package's."""
    from esvio_tpu_torch.apps import calib as tcal
    obj, img, ref = runs[model]
    res = getattr(tcal, FN[model])(obj, img, device="cpu")
    for k in INTRINSICS[model] + ("rms",):
        assert _rel(res[k], ref[k]) < 1e-6, (k, res[k], ref[k])
    np.testing.assert_allclose(res["rvecs"], ref["rvecs"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(res["tvecs"], ref["tvecs"], rtol=1e-6,
                               atol=1e-9)


def test_scaramuzza_matches_jax_functionally(runs):
    """Scaramuzza: the forward-polynomial Gauss-Newton has not converged
    after its 40 iterations (the JAX package's own cx still moves 1e-3 px
    per 20 more) and each step solves a normal matrix whose columns span
    ~20 decades, so two LAPACKs part at ~1e-5 relative in cx and 1e-2 in
    the fitted inverse polynomial.  Held here to what that leaves fixed:
    the two fitted cameras project the test's rays within 0.05 px, the
    centre within 0.01 px, the affine part within 1e-6, the rms within
    0.005 px, and the port meets tests/test_calib.py's gates."""
    from esvio_tpu_torch.apps import calib as tcal
    from esvio_tpu_torch.core import camera as tcam
    obj, img, ref = runs["scara"]
    res = tcal.calibrate_scaramuzza(obj, img, width=640, height=480,
                                    device="cpu")
    assert abs(res["cx"] - ref["cx"]) < 0.01 and abs(res["cy"] - ref["cy"]) < 0.01
    assert _rel(res["affine"], ref["affine"]) < 1e-6
    assert abs(res["rms"] - ref["rms"]) < 0.005 and res["rms"] < 0.2

    def camera(r):
        return tcam.make_scaramuzza(r["poly"], r["inv_poly"], cx=r["cx"],
                                    cy=r["cy"], affine=tuple(r["affine"]),
                                    width=640, height=480,
                                    dtype=torch.float64)
    th = np.linspace(0.02, 0.6, 20)
    psi = np.linspace(0, 2 * np.pi, 13)[:-1]
    rays = torch.as_tensor(np.stack(
        [np.outer(np.sin(th), np.cos(psi)).ravel(),
         np.outer(np.sin(th), np.sin(psi)).ravel(),
         np.outer(np.cos(th), np.ones_like(psi)).ravel()], -1))
    uv = tcam.space_to_plane(camera(res), rays)
    uv_ref = tcam.space_to_plane(camera(ref), rays)
    assert (uv - uv_ref).abs().max() < 0.05
    gt = synth_np.CALIB_GT["scara"]
    assert abs(res["cx"] - gt["cx"]) < 1.5 and abs(res["cy"] - gt["cy"]) < 1.5


@pytest.mark.parametrize("model", MODELS)
def test_yaml_writers_match_and_load(runs, model, tmp_path):
    """Each writer of the port writes the JAX writer's bytes for the same
    result dict; the port's load_camera_yaml reads the intrinsics back
    (into a float32 camera)."""
    from esvio_tpu.apps import calib as jcal
    from esvio_tpu_torch.apps import calib as tcal
    from esvio_tpu_torch.io.config import load_camera_yaml
    _, _, res = runs[model]
    a, b = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    getattr(jcal, WRITER[model])(str(a), res, 640, 480)
    getattr(tcal, WRITER[model])(str(b), res, 640, 480)
    assert a.read_bytes() == b.read_bytes()
    cam = load_camera_yaml(str(b))
    first = INTRINSICS[model][0]
    got = np.atleast_1d({"fx": cam.fx, "mu": cam.fx, "gamma1": cam.fx,
                         "poly": cam.poly}[first].numpy())
    np.testing.assert_allclose(got, np.atleast_1d(res[first])[:got.size],
                               rtol=1e-6)


def test_chessboard_matches_jax(runs):
    """detect_saddles bit for bit (scores, sub-pixel corners, the top-k tie
    order of jax.lax.top_k) and find_chessboard's grid."""
    from esvio_tpu_torch.apps import chessboard as tcb
    img, gt, ref, (grid_ref, ok_ref) = runs["board"]
    xy, score, valid = tcb.detect_saddles(img, 70, device="cpu")
    for a, b in zip((xy, score, valid), ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    grid, ok = tcb.find_chessboard(img, 5, 7, device="cpu")
    assert ok and ok_ref
    np.testing.assert_array_equal(grid, grid_ref)
    assert np.linalg.norm(grid - gt, axis=1).max() < 1.0
