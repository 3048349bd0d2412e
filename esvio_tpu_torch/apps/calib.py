"""Intrinsic camera calibration from planar-target views (Zhang's method;
port of esvio_tpu/apps/calib.py).

The reference's standalone Calibration executable
(camera_model/src/intrinsic_calib.cc:247 + CameraCalibration.cc):
closed-form initialization from homographies (numpy), then a joint
Gauss-Newton refinement of intrinsics + distortion + per-view extrinsics in
float64 on `device` — one batched residual over all (view, corner) pairs,
its Jacobian by `torch.func.jacfwd`, instead of Ceres.  Four models:
pinhole radtan, Kannala-Brandt, MEI and Scaramuzza (OCam).

Corner detection is apps/chessboard.py; this module consumes
(object_pts, image_pts) correspondence arrays, and its CLI reads an .npz
and writes a camodocal-style YAML that io/config.load_camera_yaml reads:

    python -m esvio_tpu_torch.apps.calib views.npz --model kb --out cam.yaml \
        [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.core import camera as cam_mod
from esvio_tpu_torch.core import lie


# ------------------------------------------------------------- homography

def _normalize_2d(p):
    mean = p.mean(0)
    d = np.linalg.norm(p - mean, axis=1).mean()
    s = np.sqrt(2.0) / max(d, 1e-12)
    T = np.array([[s, 0, -s * mean[0]], [0, s, -s * mean[1]], [0, 0, 1.0]])
    ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ T.T
    return ph[:, :2], T


def homography_dlt(obj_xy, img_uv):
    """Normalized DLT homography board-plane → image (per view, host-side)."""
    a, Ta = _normalize_2d(np.asarray(obj_xy, float))
    b, Tb = _normalize_2d(np.asarray(img_uv, float))
    n = len(a)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = a
    A[0::2, 2] = 1
    A[0::2, 6:8] = -b[:, 0:1] * a
    A[0::2, 8] = -b[:, 0]
    A[1::2, 3:5] = a
    A[1::2, 5] = 1
    A[1::2, 6:8] = -b[:, 1:2] * a
    A[1::2, 8] = -b[:, 1]
    H = np.linalg.svd(A)[2][-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ H @ Ta
    return H / H[2, 2]


def _zhang_intrinsics(Hs):
    """Closed-form K from ≥3 homographies (Zhang 2000, eq. 7-9)."""

    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    b = np.linalg.svd(np.asarray(V))[2][-1]
    B11, B12, B22, B13, B23, B33 = b
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
    lam = B33 - (B13 ** 2 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = np.sqrt(abs(lam / B11))
    fy = np.sqrt(abs(lam * B11 / (B11 * B22 - B12 ** 2)))
    cx = -B13 * fx ** 2 / lam
    return fx, fy, cx, cy


def _extrinsics_from_h(H, K):
    """Per-view [R|t] from homography (board plane Z=0)."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / max(np.linalg.norm(Kinv @ h1), 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    t = lam * (Kinv @ h3)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], 1)
    U, _, Vt = np.linalg.svd(R)  # project to SO(3)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:                 # board must be in front
        R[:, :2] *= -1
        t = -t
    return R, t


# ------------------------------------------------------------- refinement

def _proj_pinhole(intr, pc):
    """[fx fy cx cy k1 k2 p1 p2]: pinhole + radtan
    (PinholeCamera::spaceToPlane)."""
    z = torch.where(torch.abs(pc[..., 2]) > 1e-9, pc[..., 2], 1e-9)
    x = pc[..., 0] / z
    y = pc[..., 1] / z
    fx, fy, cx, cy, k1, k2, p1, p2 = intr
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return torch.stack([fx * xd + cx, fy * yd + cy], -1)


def _proj_kb(intr, pc):
    """[mu mv u0 v0 k2 k3 k4 k5]: Kannala-Brandt equidistant, r(θ) = θ +
    k2θ³ + k3θ⁵ + k4θ⁷ + k5θ⁹ (EquidistantCamera::spaceToPlane)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    rho = torch.sqrt(x * x + y * y)
    theta = torch.atan2(rho, z)
    mu, mv, u0, v0, k2, k3, k4, k5 = intr
    th2 = theta * theta
    r_th = theta * (1.0 + th2 * (k2 + th2 * (k3 + th2 * (k4 + th2 * k5))))
    inv_rho = 1.0 / torch.clamp(rho, min=1e-12)
    return torch.stack([mu * r_th * x * inv_rho + u0,
                        mv * r_th * y * inv_rho + v0], -1)


def _proj_mei(intr, pc):
    """[gamma1 gamma2 u0 v0 xi k1 k2 p1 p2]: unified omnidirectional (MEI)
    — unit-sphere projection with mirror offset xi, then radtan + affine
    (CataCamera::spaceToPlane, CostFunctionFactory MEI residual)."""
    gamma1, gamma2, u0, v0, xi, k1, k2, p1, p2 = intr
    norm = torch.linalg.vector_norm(pc, dim=-1)
    s = pc / torch.clamp(norm, min=1e-12)[..., None]
    denom = torch.clamp(s[..., 2] + xi, min=1e-6)
    x = s[..., 0] / denom
    y = s[..., 1] / denom
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    return torch.stack([gamma1 * xd + u0, gamma2 * yd + v0], -1)


def _scara_residual(intr, pc, img):
    """Forward-polynomial OCam residual over [cx cy c d e a0 a2 a3 a4]
    (a1 ≡ 0 by the OCamCalib normalization): the ray elevation mismatch ×
    |a0| (≈ radial pixel error) and the azimuth mismatch × ρ (≈ tangential
    pixel error).  Only the forward polynomial is needed; the inverse one
    is fit afterwards (`fit_inv_poly`), the reference tool's two-stage
    flow."""
    cx, cy, c, d, e, a0, a2, a3, a4 = intr
    xc = img[..., 0] - cx
    yc = img[..., 1] - cy
    inv_scale = 1.0 / (c - d * e)
    xa = inv_scale * (xc - d * yc)
    ya = inv_scale * (-e * xc + c * yc)
    rho = torch.sqrt(xa * xa + ya * ya)
    z = a0 + rho * rho * (a2 + rho * (a3 + rho * a4))
    lam_o = torch.atan2(-z, rho)                        # observed elevation
    lam_p = torch.atan2(pc[..., 2], torch.hypot(pc[..., 0], pc[..., 1]))
    dang = torch.atan2(ya, xa) - torch.atan2(pc[..., 1], pc[..., 0])
    dang = torch.remainder(dang + np.pi, 2 * np.pi) - np.pi   # wrap azimuth
    return torch.stack([(lam_o - lam_p) * torch.abs(a0), dang * rho], -1)


def _pixel_residual(project):
    return lambda intr, pc, img: project(intr, pc) - img


def _make_refiner(residual_fn, n_intr, damping=1e-6, frozen=()):
    """Joint GN refiner over intrinsics + per-view (ω, t) for a residual
    `residual_fn(intr, pc, img) -> (..., 2)` — the shared machinery
    replacing Ceres in intrinsic_calib.cc (one batched residual, its
    Jacobian by forward mode, the damped normal equations).  `frozen`
    intrinsics keep their initial values."""

    def refine(obj, img, mask, intr0, w0, t0, iters: int = 20):
        V = obj.shape[0]
        dtype, dev = img.dtype, img.device

        def residual(intr, w, t):
            pc = torch.einsum("vij,vnj->vni", lie.so3_exp(w), obj) \
                + t[:, None, :]
            return residual_fn(intr, pc, img) * mask[..., None]

        def unpack(d):
            return (d[:n_intr], d[n_intr:n_intr + 3 * V].reshape(V, 3),
                    d[n_intr + 3 * V:].reshape(V, 3))

        zdim = n_intr + 6 * V
        eye = torch.eye(zdim, dtype=dtype, device=dev)
        keep = torch.ones(zdim, dtype=dtype, device=dev)
        keep[list(frozen)] = 0.0
        intr, w, t = intr0, w0, t0
        for _ in range(iters):
            def r_of(d, intr=intr, w=w, t=t):
                di, dw, dt = unpack(d)
                return residual(intr + di, w + dw, t + dt).reshape(-1)

            z = torch.zeros(zdim, dtype=dtype, device=dev)
            r = r_of(z)
            J = torch.func.jacfwd(r_of)(z)
            H = J.T @ J + damping * eye
            d = -torch.linalg.solve(H, J.T @ r) * keep
            di, dw, dt = unpack(d)
            intr, w, t = intr + di, w + dw, t + dt
        r = residual(intr, w, t)
        n = torch.clamp(torch.sum(mask), min=1.0)
        rms = torch.sqrt(torch.sum(r ** 2) / n)
        return intr, w, t, rms

    return refine


_refine = _make_refiner(_pixel_residual(_proj_pinhole), 8)
_refine_kb = _make_refiner(_pixel_residual(_proj_kb), 8)
_refine_mei = _make_refiner(_pixel_residual(_proj_mei), 9)
# the affine skew terms d/e are held at their init (0): near-degenerate with
# the per-view rotations on planar-board data (OCamCalib's default too)
_refine_scara = _make_refiner(_scara_residual, 9, damping=1e-8, frozen=(3, 4))


def _zhang_boot(object_pts, image_pts, mask):
    """Shared closed-form bootstrap: per-view DLT homographies → Zhang K →
    per-view extrinsics.  Returns (obj3, mask, (fx,fy,cx,cy), w0 (V,3),
    t0 (V,3))."""
    object_pts = np.asarray(object_pts, float)
    image_pts = np.asarray(image_pts, float)
    V, N = image_pts.shape[:2]
    if object_pts.shape[-1] == 2:
        object_pts = np.concatenate(
            [object_pts, np.zeros((V, N, 1))], axis=-1)
    if mask is None:
        mask = np.ones((V, N), bool)
    Hs = [homography_dlt(object_pts[v][mask[v], :2], image_pts[v][mask[v]])
          for v in range(V)]
    fx, fy, cx, cy = _zhang_intrinsics(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Rs, ts = zip(*(_extrinsics_from_h(H, K) for H in Hs))
    ws = lie.so3_log(torch.as_tensor(np.stack(Rs), dtype=torch.float64)).numpy()
    return object_pts, mask, (fx, fy, cx, cy), ws, np.stack(ts)


def _run(refine, object_pts, image_pts, mask, intr0, iters, device):
    """Zhang bootstrap, then `refine` in float64 on `device` from intr0(K)
    → (intr, w, t, rms, obj3, mask) as numpy."""
    obj3, mask, K, w0, t0 = _zhang_boot(object_pts, image_pts, mask)
    f64 = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64,
                                    device=device)
    intr, w, t, rms = refine(f64(obj3), f64(image_pts), f64(mask),
                             f64(intr0(*K)), f64(w0), f64(t0), iters=iters)
    return (intr.cpu().numpy(), w.cpu().numpy(), t.cpu().numpy(),
            float(rms), obj3, mask)


def calibrate_pinhole(object_pts, image_pts, mask=None, iters: int = 20,
                      device="cuda"):
    """Full pipeline: Zhang init + joint GN refinement.

    object_pts: (V, N, 2|3) planar board points (Z ignored/0);
    image_pts: (V, N, 2) detections; mask: (V, N) valid detections.
    Returns dict(fx, fy, cx, cy, dist(4,), rvecs (V,3), tvecs (V,3), rms)."""
    intr, w, t, rms, _, _ = _run(
        _refine, object_pts, image_pts, mask,
        lambda fx, fy, cx, cy: [fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0],
        iters, device)
    return dict(fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3],
                dist=intr[4:8], rvecs=w, tvecs=t, rms=rms)


def calibrate_kb(object_pts, image_pts, mask=None, iters: int = 30,
                 device="cuda"):
    """Kannala-Brandt (EQUIDISTANT) calibration: Zhang init (pinhole
    approximation of the central region) + joint KB GN refinement
    (reference EquidistantCamera.cc).

    Returns dict(mu, mv, u0, v0, ks(4,), rvecs, tvecs, rms)."""
    intr, w, t, rms, _, _ = _run(
        _refine_kb, object_pts, image_pts, mask,
        lambda fx, fy, cx, cy: [fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0],
        iters, device)
    return dict(mu=intr[0], mv=intr[1], u0=intr[2], v0=intr[3], ks=intr[4:8],
                rvecs=w, tvecs=t, rms=rms)


def calibrate_mei(object_pts, image_pts, mask=None, iters: int = 40,
                  device="cuda"):
    """Unified-omnidirectional (MEI / CataCamera) calibration: Zhang init
    with the xi = 1 bootstrap (projection through the unit sphere doubles
    the effective focal length near the axis, gamma ≈ 2f), then joint GN
    over [gamma1 gamma2 u0 v0 xi k1 k2 p1 p2] (intrinsic_calib.cc:247 with
    --camera-model mei).

    Returns dict(gamma1, gamma2, u0, v0, xi, dist(4,), rvecs, tvecs, rms)."""
    intr, w, t, rms, _, _ = _run(
        _refine_mei, object_pts, image_pts, mask,
        lambda fx, fy, cx, cy: [2 * fx, 2 * fy, cx, cy, 1.0,
                                0.0, 0.0, 0.0, 0.0], iters, device)
    return dict(gamma1=intr[0], gamma2=intr[1], u0=intr[2], v0=intr[3],
                xi=intr[4], dist=intr[5:9], rvecs=w, tvecs=t, rms=rms)


# ------------------------------------------------- Scaramuzza (OCam) model

def fit_inv_poly(poly, max_radius, n_inv=20, n_samples=512):
    """Fit the 20-coefficient inverse polynomial rho(theta) from the forward
    polynomial z(rho) (ScaramuzzaCamera's inv_poly; OCamCalib
    findinvpoly.m): sample radii, compute each ray's elevation angle
    theta = atan2(-z, rho), and least-squares the Vandermonde system."""
    rho = np.linspace(1e-3, max_radius, n_samples)
    z = np.polyval(poly[::-1], rho)            # a0 + a1ρ + ... (a1 may be 0)
    # OCam angle convention: spaceToPlane evaluates rho(θ) at
    # θ = atan2(-ray_z, ‖xy‖), and the lifted ray is (xc, yc, -z(ρ)) — so
    # the inverse-poly domain is θ = atan2(z, ρ) (negative for z < 0, i.e.
    # points in front of the camera), matching ScaramuzzaCamera.cc:632-653
    theta = np.arctan2(z, rho)
    Vm = np.vander(theta, n_inv, increasing=True)
    # scale columns for conditioning (theta spans ~[-pi/2, pi/2])
    col_s = np.maximum(np.abs(Vm).max(0), 1e-12)
    coef, *_ = np.linalg.lstsq(Vm / col_s, rho, rcond=None)
    return coef / col_s


def calibrate_scaramuzza(object_pts, image_pts, mask=None, iters: int = 40,
                         width: int = 640, height: int = 480, device="cuda"):
    """Scaramuzza/OCam omnidirectional calibration, two-stage like the
    reference tool (intrinsic_calib.cc --camera-model scaramuzza):

      1. joint GN on the FORWARD polynomial (`_scara_residual`) from a
         Zhang-style bootstrap (near the axis z(ρ) ≈ -f, so a0 = -f);
      2. fit the 20-coefficient inverse polynomial for projection.

    Returns dict(poly(5,), inv_poly(20,), cx, cy, affine(3,) = (c,d,e),
    rvecs, tvecs, rms) where rms is the PIXEL reprojection rms through the
    fitted inverse polynomial (core/camera's Scaramuzza projection)."""
    intr, w, t, _, obj3, mask = _run(
        _refine_scara, object_pts, image_pts, mask,
        lambda fx, fy, cx, cy: [cx, cy, 1.0, 0.0, 0.0, -0.5 * (fx + fy),
                                0.0, 0.0, 0.0], iters, device)
    cx, cy, c, d, e = intr[:5]
    poly = np.array([intr[5], 0.0, intr[6], intr[7], intr[8]])
    max_radius = float(np.hypot(max(cx, width - cx), max(cy, height - cy)))
    inv_poly = fit_inv_poly(poly, max_radius)

    cam = cam_mod.make_scaramuzza(poly, inv_poly, cx=cx, cy=cy,
                                  affine=(c, d, e), width=width,
                                  height=height, dtype=torch.float64,
                                  device=device)
    R = lie.so3_exp(torch.as_tensor(w, dtype=torch.float64, device=device))
    pc = torch.einsum("vij,vnj->vni", R,
                      torch.as_tensor(obj3, dtype=torch.float64, device=device)) \
        + torch.as_tensor(t, dtype=torch.float64, device=device)[:, None]
    uv = cam_mod.space_to_plane(cam, pc).cpu().numpy()
    err = ((uv - np.asarray(image_pts, float)) ** 2).sum(-1)
    rms = float(np.sqrt(err[mask].sum() / max(int(mask.sum()), 1)))
    return dict(poly=poly, inv_poly=inv_poly, cx=float(cx), cy=float(cy),
                affine=np.array([c, d, e]), rvecs=w, tvecs=t, rms=rms)


def write_camera_yaml_kb(path, result, width, height, name="camera"):
    """camodocal-style KANNALA_BRANDT YAML
    (EquidistantCamera::Parameters::writeToYamlFile) — readable back by
    io/config.load_camera_yaml."""
    k = result["ks"]
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write("model_type: KANNALA_BRANDT\n")
        f.write(f"camera_name: {name}\n")
        f.write(f"image_width: {width}\nimage_height: {height}\n")
        f.write("projection_parameters:\n")
        f.write(f"   k2: {k[0]:.10e}\n   k3: {k[1]:.10e}\n")
        f.write(f"   k4: {k[2]:.10e}\n   k5: {k[3]:.10e}\n")
        f.write(f"   mu: {result['mu']:.10e}\n   mv: {result['mv']:.10e}\n")
        f.write(f"   u0: {result['u0']:.10e}\n   v0: {result['v0']:.10e}\n")


def write_camera_yaml_mei(path, result, width, height, name="camera"):
    """camodocal-style MEI YAML (CataCamera::Parameters::writeToYamlFile) —
    readable back by io/config.load_camera_yaml."""
    d = result["dist"]
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write("model_type: MEI\n")
        f.write(f"camera_name: {name}\n")
        f.write(f"image_width: {width}\nimage_height: {height}\n")
        f.write("mirror_parameters:\n")
        f.write(f"   xi: {result['xi']:.10e}\n")
        f.write("distortion_parameters:\n")
        f.write(f"   k1: {d[0]:.10e}\n   k2: {d[1]:.10e}\n")
        f.write(f"   p1: {d[2]:.10e}\n   p2: {d[3]:.10e}\n")
        f.write("projection_parameters:\n")
        f.write(f"   gamma1: {result['gamma1']:.10e}\n")
        f.write(f"   gamma2: {result['gamma2']:.10e}\n")
        f.write(f"   u0: {result['u0']:.10e}\n   v0: {result['v0']:.10e}\n")


def write_camera_yaml_scara(path, result, width, height, name="camera"):
    """camodocal-style SCARAMUZZA YAML (OCAMCamera::Parameters layout,
    ScaramuzzaCamera.cc:89-103) — readable back by
    io/config.load_camera_yaml (center inside affine_parameters)."""
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write("model_type: SCARAMUZZA\n")
        f.write(f"camera_name: {name}\n")
        f.write(f"image_width: {width}\nimage_height: {height}\n")
        f.write("poly_parameters:\n")
        for i, p in enumerate(result["poly"]):
            f.write(f"   p{i}: {p:.10e}\n")
        f.write("inv_poly_parameters:\n")
        for i, p in enumerate(result["inv_poly"]):
            f.write(f"   p{i}: {p:.10e}\n")
        f.write("affine_parameters:\n")
        a = result["affine"]
        f.write(f"   ac: {a[0]:.10e}\n   ad: {a[1]:.10e}\n")
        f.write(f"   ae: {a[2]:.10e}\n")
        f.write(f"   cx: {result['cx']:.10e}\n   cy: {result['cy']:.10e}\n")


def write_camera_yaml(path, result, width, height, name="camera"):
    """camodocal-style pinhole YAML (PinholeCamera::Parameters::writeToYamlFile)."""
    d = result["dist"]
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write("model_type: PINHOLE\n")
        f.write(f"camera_name: {name}\n")
        f.write(f"image_width: {width}\nimage_height: {height}\n")
        f.write("distortion_parameters:\n")
        f.write(f"   k1: {d[0]:.10e}\n   k2: {d[1]:.10e}\n")
        f.write(f"   p1: {d[2]:.10e}\n   p2: {d[3]:.10e}\n")
        f.write("projection_parameters:\n")
        f.write(f"   fx: {result['fx']:.10e}\n   fy: {result['fy']:.10e}\n")
        f.write(f"   cx: {result['cx']:.10e}\n   cy: {result['cy']:.10e}\n")


def main(argv=None):
    """CLI: calibrate from an .npz with object_pts/image_pts[/mask]."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", help=".npz with object_pts (V,N,2|3), "
                    "image_pts (V,N,2), optional mask (V,N)")
    ap.add_argument("--out", default="camera_calib.yaml")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--model", choices=("pinhole", "kb", "mei", "scara"),
                    default="pinhole",
                    help="pinhole radtan, Kannala-Brandt fisheye, MEI "
                         "unified omni, or Scaramuzza/OCam polynomial — "
                         "the reference Calibration tool's four models "
                         "(intrinsic_calib.cc:247)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    d = np.load(args.npz)
    if args.model == "kb":
        res = calibrate_kb(d["object_pts"], d["image_pts"],
                           d.get("mask"), iters=max(args.iters, 30),
                           device=args.device)
        write_camera_yaml_kb(args.out, res, args.width, args.height)
        print(f"rms: {res['rms']:.4f} px  mu={res['mu']:.2f} "
              f"mv={res['mv']:.2f} u0={res['u0']:.2f} v0={res['v0']:.2f}\n"
              f"wrote {args.out}")
        return
    if args.model == "mei":
        res = calibrate_mei(d["object_pts"], d["image_pts"],
                            d.get("mask"), iters=max(args.iters, 40),
                            device=args.device)
        write_camera_yaml_mei(args.out, res, args.width, args.height)
        print(f"rms: {res['rms']:.4f} px  xi={res['xi']:.3f} "
              f"gamma1={res['gamma1']:.2f} gamma2={res['gamma2']:.2f} "
              f"u0={res['u0']:.2f} v0={res['v0']:.2f}\nwrote {args.out}")
        return
    if args.model == "scara":
        res = calibrate_scaramuzza(d["object_pts"], d["image_pts"],
                                   d.get("mask"), iters=max(args.iters, 40),
                                   width=args.width, height=args.height,
                                   device=args.device)
        write_camera_yaml_scara(args.out, res, args.width, args.height)
        print(f"rms: {res['rms']:.4f} px  cx={res['cx']:.2f} "
              f"cy={res['cy']:.2f} poly={res['poly']}\nwrote {args.out}")
        return
    res = calibrate_pinhole(d["object_pts"], d["image_pts"],
                            d.get("mask"), iters=args.iters,
                            device=args.device)
    write_camera_yaml(args.out, res, args.width, args.height)
    print(f"rms: {res['rms']:.4f} px  fx={res['fx']:.2f} fy={res['fy']:.2f} "
          f"cx={res['cx']:.2f} cy={res['cy']:.2f}\nwrote {args.out}")


if __name__ == "__main__":
    main()
