"""Camera models (port of esvio_tpu/core/camera.py, camodocal equivalents).

  * ``lift_projective(cam, uv) -> xyz``  — pixel → normalized projective ray
  * ``space_to_plane(cam, xyz) -> uv``   — 3-D point → pixel

Models:
  * ``PINHOLE``      — radial-tangential k1, k2, p1, p2 (PinholeCamera.cc);
                       the model of every shipped reference config.
  * ``EQUIDISTANT``  — Kannala-Brandt fisheye k2..k5 (EquidistantCamera.cc).
  * ``MEI``          — unified omni model, mirror xi + radtan (CataCamera.cc).
  * ``SCARAMUZZA``   — OCam polynomial model (ScaramuzzaCamera.cc).

Undistortion is the reference's fixed-point "recursive distortion" scheme
(PinholeCamera.cc:489-505, n = 8); the KB θ inversion is a fixed 12-step
fixed point, as in the JAX package.  All functions broadcast over leading
axes of the point argument.
"""
from __future__ import annotations

import dataclasses

import torch

PINHOLE = 0
EQUIDISTANT = 1
MEI = 2
SCARAMUZZA = 3

_TENSORS = ("fx", "fy", "cx", "cy", "dist", "xi", "poly", "inv_poly", "affine")


@dataclasses.dataclass
class CameraModel:
    """fx, fy, cx, cy, xi: () tensors; dist: (4,) radtan (k1, k2, p1, p2)
    for PINHOLE/MEI, KB (k2, k3, k4, k5) for EQUIDISTANT; poly (5,),
    inv_poly (20,) and affine (C, D, E): the Scaramuzza model's forward and
    inverse polynomials and affine part (zeros and (1, 0, 0) otherwise)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor
    xi: torch.Tensor
    poly: torch.Tensor
    inv_poly: torch.Tensor
    affine: torch.Tensor
    kind: int = PINHOLE
    width: int = 346
    height: int = 260

    def to(self, device):
        return dataclasses.replace(
            self, **{n: getattr(self, n).to(device) for n in _TENSORS})


def _make(kind, fx, fy, cx, cy, dist, xi, width, height, dtype, device,
          poly=(), inv_poly=(), affine=(1.0, 0.0, 0.0)) -> CameraModel:
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    poly_p = torch.zeros(5, dtype=dtype, device=device)
    inv_p = torch.zeros(20, dtype=dtype, device=device)
    poly, inv_poly = t(poly)[:5], t(inv_poly)[:20]
    poly_p[:poly.shape[0]] = poly
    inv_p[:inv_poly.shape[0]] = inv_poly
    return CameraModel(fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy), dist=t(dist),
                       xi=t(xi), poly=poly_p, inv_poly=inv_p, affine=t(affine),
                       kind=kind, width=width, height=height)


def make_pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), width=346,
                 height=260, dtype=torch.float32, device=None) -> CameraModel:
    return _make(PINHOLE, fx, fy, cx, cy, dist, 0.0, width, height, dtype,
                 device)


def make_equidistant(fx, fy, cx, cy, ks=(0.0, 0.0, 0.0, 0.0), width=346,
                     height=260, dtype=torch.float32, device=None) -> CameraModel:
    return _make(EQUIDISTANT, fx, fy, cx, cy, ks, 0.0, width, height, dtype,
                 device)


def make_mei(xi, fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), width=346,
             height=260, dtype=torch.float32, device=None) -> CameraModel:
    return _make(MEI, fx, fy, cx, cy, dist, xi, width, height, dtype, device)


def make_scaramuzza(poly, inv_poly, cx, cy, affine=(1.0, 0.0, 0.0),
                    width=640, height=480, dtype=torch.float32,
                    device=None) -> CameraModel:
    """OCam/Scaramuzza omnidirectional polynomial model
    (ScaramuzzaCamera.h:13-16: 5 forward + 20 inverse coefficients, center,
    affine C/D/E); the polynomials are zero-padded to 5 and 20."""
    return _make(SCARAMUZZA, 1.0, 1.0, cx, cy, (0.0, 0.0, 0.0, 0.0), 0.0,
                 width, height, dtype, device, poly, inv_poly, affine)


def _radtan_delta(cam: CameraModel, p):
    """Distortion displacement d_u for normalized point p (..., 2)."""
    k1, k2, p1, p2 = cam.dist[0], cam.dist[1], cam.dist[2], cam.dist[3]
    mx2 = p[..., 0] * p[..., 0]
    my2 = p[..., 1] * p[..., 1]
    mxy = p[..., 0] * p[..., 1]
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = p[..., 0] * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
    dy = p[..., 1] * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
    return torch.stack([dx, dy], dim=-1)


_LIFT_ITERS = 8  # PinholeCamera.cc:492
_KB_ITERS = 12


def _undistort(cam: CameraModel, uv):
    """Radtan-undistorted normalized point (..., 2) of pixel uv."""
    md = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    mu = md - _radtan_delta(cam, md)
    for _ in range(_LIFT_ITERS):
        mu = md - _radtan_delta(cam, mu)
    return mu


def _distort_to_pixel(cam: CameraModel, p):
    pd = p + _radtan_delta(cam, p)
    return torch.stack([cam.fx * pd[..., 0] + cam.cx,
                        cam.fy * pd[..., 1] + cam.cy], dim=-1)


def _kb_poly(cam: CameraModel, t2):
    k2, k3, k4, k5 = cam.dist[0], cam.dist[1], cam.dist[2], cam.dist[3]
    return 1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5)))


def _equi_lift(cam: CameraModel, uv):
    # θ_d = θ(1 + k2 θ² + ...) inverted by a fixed-point iteration
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    theta_d = torch.sqrt(mx * mx + my * my)
    phi = torch.atan2(my, mx)
    theta = theta_d
    for _ in range(_KB_ITERS):
        theta = theta_d / _kb_poly(cam, theta * theta)
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def _equi_project(cam: CameraModel, xyz):
    r = torch.linalg.vector_norm(xyz[..., :2], dim=-1)
    theta = torch.atan2(r, xyz[..., 2])
    theta_d = theta * _kb_poly(cam, theta * theta)
    scale = theta_d / torch.clamp(r, min=1e-12)
    return torch.stack([cam.fx * scale * xyz[..., 0] + cam.cx,
                        cam.fy * scale * xyz[..., 1] + cam.cy], dim=-1)


def _mei_lift(cam: CameraModel, uv):
    """CataCamera::liftProjective: radtan undistortion, then the unit-sphere
    unprojection, scaled to z = 1."""
    mu = _undistort(cam, uv)
    xi = cam.xi
    rho2 = torch.sum(mu * mu, dim=-1)
    lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
    z = lam - xi
    return torch.cat([lam[..., None] * mu, z[..., None]], dim=-1) / z[..., None]


def _mei_project(cam: CameraModel, xyz):
    s = xyz / torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    p = s[..., :2] / (s[..., 2] + cam.xi)[..., None]
    return _distort_to_pixel(cam, p)


def _scara_lift(cam: CameraModel, uv):
    """OCAMCamera::liftProjective (ScaramuzzaCamera.cc:599-622): the ray
    (xc, yc, -z(φ)), z from the forward polynomial on the affine-corrected
    radius; the camera looks along -z of the OCam frame."""
    C, D, E = cam.affine[0], cam.affine[1], cam.affine[2]
    xc = uv[..., 0] - cam.cx
    yc = uv[..., 1] - cam.cy
    inv_scale = 1.0 / (C - D * E)
    xa = inv_scale * (xc - D * yc)
    ya = inv_scale * (-E * xc + C * yc)
    phi = torch.sqrt(xa * xa + ya * ya)
    z = torch.zeros_like(phi)
    phi_i = torch.ones_like(phi)
    for i in range(5):
        z = z + phi_i * cam.poly[i]
        phi_i = phi_i * phi
    return torch.stack([xc, yc, -z], dim=-1)


def _scara_project(cam: CameraModel, xyz):
    """OCAMCamera::spaceToPlane (ScaramuzzaCamera.cc:632-653)."""
    C, D, E = cam.affine[0], cam.affine[1], cam.affine[2]
    norm = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)
    theta = torch.atan2(-xyz[..., 2], norm)
    rho = torch.zeros_like(theta)
    theta_i = torch.ones_like(theta)
    for i in range(20):
        rho = rho + theta_i * cam.inv_poly[i]
        theta_i = theta_i * theta
    inv_norm = 1.0 / torch.clamp(norm, min=1e-12)
    xn = xyz[..., 0] * inv_norm * rho
    yn = xyz[..., 1] * inv_norm * rho
    return torch.stack([xn * C + yn * D + cam.cx, xn * E + yn + cam.cy], dim=-1)


def lift_projective(cam: CameraModel, uv):
    """Pixel (..., 2) → normalized projective ray (..., 3) with z = 1."""
    if cam.kind == PINHOLE:
        mu = _undistort(cam, uv)
        return torch.cat([mu, torch.ones_like(mu[..., :1])], dim=-1)
    if cam.kind == EQUIDISTANT:
        ray = _equi_lift(cam, uv)
        return ray / ray[..., 2:3]
    if cam.kind == MEI:
        return _mei_lift(cam, uv)
    if cam.kind == SCARAMUZZA:
        ray = _scara_lift(cam, uv)
        return ray / ray[..., 2:3]
    raise ValueError(f"unknown camera kind {cam.kind}")


def space_to_plane(cam: CameraModel, xyz):
    """3-D point (..., 3) in the camera frame → pixel (..., 2)."""
    if cam.kind == PINHOLE:
        return _distort_to_pixel(cam, xyz[..., :2] / xyz[..., 2:3])
    if cam.kind == EQUIDISTANT:
        return _equi_project(cam, xyz)
    if cam.kind == MEI:
        return _mei_project(cam, xyz)
    if cam.kind == SCARAMUZZA:
        return _scara_project(cam, xyz)
    raise ValueError(f"unknown camera kind {cam.kind}")
