"""Pinhole radial-tangential camera model (port of esvio_tpu/core/camera.py,
PINHOLE only — the model of every shipped reference config).

  * ``lift_projective(cam, uv) -> xyz``  — pixel → normalized projective ray
  * ``space_to_plane(cam, xyz) -> uv``   — 3-D point → pixel

Undistortion is the reference's fixed-point "recursive distortion" scheme
(PinholeCamera.cc:489-505, n = 8).  The KB, MEI and Scaramuzza models of
the JAX package are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

PINHOLE = 0


@dataclasses.dataclass
class CameraModel:
    """fx, fy, cx, cy: () tensors; dist: (4,) radtan (k1, k2, p1, p2)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor
    kind: int = PINHOLE
    width: int = 346
    height: int = 260

    def to(self, device):
        return dataclasses.replace(
            self, fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device),
            dist=self.dist.to(device))


def make_pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), width=346,
                 height=260, dtype=torch.float32, device=None) -> CameraModel:
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return CameraModel(fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy), dist=t(dist),
                       kind=PINHOLE, width=width, height=height)


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


def lift_projective(cam: CameraModel, uv):
    """Pixel (..., 2) → normalized projective ray (..., 3) with z = 1."""
    if cam.kind != PINHOLE:
        raise ValueError(f"camera kind {cam.kind} is not ported")
    md = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    mu = md - _radtan_delta(cam, md)
    for _ in range(_LIFT_ITERS):
        mu = md - _radtan_delta(cam, mu)
    return torch.cat([mu, torch.ones_like(mu[..., :1])], dim=-1)


def space_to_plane(cam: CameraModel, xyz):
    """3-D point (..., 3) in camera frame → pixel (..., 2)."""
    if cam.kind != PINHOLE:
        raise ValueError(f"camera kind {cam.kind} is not ported")
    p = xyz[..., :2] / xyz[..., 2:3]
    pd = p + _radtan_delta(cam, p)
    return torch.stack([cam.fx * pd[..., 0] + cam.cx,
                        cam.fy * pd[..., 1] + cam.cy], dim=-1)
