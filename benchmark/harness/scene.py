"""The benchmark's sensor streams, rendered in plain torch on the device.

One period of a closed handheld circuit over a textured plane: a circle of
`radius_m` at `circle_hz` with a two-axis roll/pitch wobble, all scaled in
time by `speed`.  Every wobble frequency is a whole multiple of the circle's,
so the pose at the end of the period equals the pose at its start and the
period can be handed over again and again with its stamps shifted by whole
periods (harness/stream.py).

The model is the one of the repository's synthetic test sequences: the
camera looks up at the plane z = plane_z, a band-limited value-noise
texture (three octaves, bicubic, drawn from the traffic's texture seed),
an ESIM-style contrast event model per pixel with the threshold
`contrast`, IMU specific force and the gyro of the forward interval,
stereo cameras offset along the body x axis.  The run's seed draws the
events' sub-step stamps and the IMU noise; every seed gives the same
sizes, rates and scene.

The ground truth is not taken from here: harness/reference.py evaluates the
same closed-form trajectory in numpy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Circuit:
    radius_m: float
    circle_hz: float
    wobble_deg: float
    wobble_hz: tuple
    wobble_phase: tuple
    speed: float

    @property
    def period_s(self) -> float:
        return 1.0 / (self.circle_hz * self.speed)

    def validate(self):
        for f in self.wobble_hz:
            k = f / self.circle_hz
            if abs(k - round(k)) > 1e-9 or round(k) < 1:
                raise ValueError(f"wobble {f} Hz is not a whole multiple of the "
                                 f"circle's {self.circle_hz} Hz: the stream "
                                 "would jump at every period")


def circuit_from(traffic: dict) -> Circuit:
    c = traffic["circuit"]
    out = Circuit(float(c["radius_m"]), float(c["circle_hz"]),
                  float(c["wobble_deg"]), tuple(float(f) for f in c["wobble_hz"]),
                  tuple(float(p) for p in c["wobble_phase"]), float(c["speed"]))
    out.validate()
    return out


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], -1).reshape(v.shape[:-1] + (3, 3))


def so3_exp(w):
    th2 = (w * w).sum(-1)
    th = th2.clamp_min(1e-24).sqrt()
    W = _skew(w)
    small = th2 < 1e-12
    s = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    c = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2.clamp_min(1e-24))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + s[..., None, None] * W + c[..., None, None] * (W @ W)


def so3_log(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    th = torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    fac = torch.where(th < 1e-4, 0.5 + th * th / 12.0,
                      th / (2.0 * torch.sin(th)).clamp_min(1e-12))
    return fac[..., None] * vee


def pose(cc: Circuit, t, tau):
    """(R_wb (N, 3, 3), p_wb (N, 3), a_wb (N, 3)) at times t (N,) float64:
    the trajectory evaluated tau seconds into the period."""
    u = (t + tau) * cc.speed
    w = 2 * math.pi * cc.circle_hz
    th = w * u
    p = torch.stack([cc.radius_m * torch.sin(th),
                     cc.radius_m * (torch.cos(th) - 1.0), torch.zeros_like(th)], -1)
    a = torch.stack([-w * w * cc.radius_m * torch.sin(th),
                     -w * w * cc.radius_m * torch.cos(th), torch.zeros_like(th)], -1)
    a = a * cc.speed ** 2
    amp = math.radians(cc.wobble_deg)
    (f1, f2), (ph1, ph2) = cc.wobble_hz, cc.wobble_phase
    rv = torch.stack([amp * torch.sin(2 * math.pi * f1 * u + ph1),
                      amp * torch.sin(2 * math.pi * f2 * u + ph2),
                      torch.zeros_like(u)], -1)
    return so3_exp(rv), p, a


def value_noise_texture(gen, side, cell, octaves, device):
    """(side, side) float32 texture in [20, 220]: multi-octave value noise,
    each octave a bicubic upsampling of a normal grid."""
    img = torch.zeros((side, side), dtype=torch.float32, device=device)
    amp = 1.0
    for o in range(octaves):
        c = cell * 2 ** o
        n = side // c + 4
        g = torch.randn((1, 1, n, n), generator=gen, device=device)
        up = F.interpolate(g, scale_factor=c, mode="bicubic", align_corners=False)
        img += amp * up[0, 0, :side, :side]
        amp *= 0.6
    img -= img.min()
    img /= img.max().clamp_min(1e-9)
    return img * 200.0 + 20.0


class PlaneRenderer:
    """Renders the textured plane for one pinhole camera (offset `offset`
    in the body frame, axes of the body) at a batch of times."""

    def __init__(self, tex, tex_scale, plane_z, fx, fy, cx, cy, width, height,
                 offset, device):
        self.tex = tex[None, None]
        self.scale = tex_scale
        self.plane_z = plane_z
        self.offset = torch.tensor(offset, dtype=torch.float64, device=device)
        v, u = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=device),
                              torch.arange(width, dtype=torch.float64, device=device),
                              indexing="ij")
        self.rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
        self.H, self.W = height, width

    def render(self, R, p):
        """(S, H, W) float32 images for body poses R (S, 3, 3), p (S, 3)."""
        c = p + (R @ self.offset[:, None])[..., 0]
        rays_w = torch.einsum("hwj,sij->shwi", self.rays, R)
        lam = (self.plane_z - c[:, 2, None, None]) / rays_w[..., 2]
        X = c[:, 0, None, None] + lam * rays_w[..., 0]
        Y = c[:, 1, None, None] + lam * rays_w[..., 1]
        Ht, Wt = self.tex.shape[-2:]
        gx = (X * self.scale + Wt / 2) * (2.0 / (Wt - 1)) - 1.0
        gy = (Y * self.scale + Ht / 2) * (2.0 / (Ht - 1)) - 1.0
        grid = torch.stack([gx, gy], -1).to(torch.float32)
        S = grid.shape[0]
        out = F.grid_sample(self.tex, grid.reshape(1, S * self.H, self.W, 2),
                            mode="bilinear", padding_mode="border",
                            align_corners=True)
        return out.reshape(S, self.H, self.W)


@dataclasses.dataclass
class Period:
    """One period of the streams, on the host: events per camera as (t
    float64, x, y, p int32), IMU (t, acc, gyr), frames per camera as
    uint8 (N, H, W) with their stamps, and what the period was drawn with."""
    period_s: float
    tau: float
    events: tuple
    imu: tuple
    frames: tuple
    frame_t: np.ndarray
    n_events: tuple


def _texture_side(sc, cc, tex_scale):
    """Texels per side so that every ray of the circuit lands inside."""
    amp = math.radians(cc.wobble_deg) * math.sqrt(2.0)
    half_fov = max(math.atan(max(sc["cx"], sc["width"] - sc["cx"]) / sc["fx"]),
                   math.atan(max(sc["cy"], sc["height"] - sc["cy"]) / sc["fy"]))
    reach = sc["plane_z_m"] * math.tan(half_fov + amp) + 2 * cc.radius_m \
        + abs(sc["baseline_m"]) + 0.25
    return int(2 * reach * tex_scale) + 8


def render_period(scene: dict, traffic: dict, seed: int, device,
                  block: int = 32) -> Period:
    """Render one period of the cell's streams on `device` from `seed`."""
    cc = circuit_from(traffic)
    ev = traffic["events"]
    imu_cfg = traffic["imu"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    T = cc.period_s
    # where on the circuit the period starts is the traffic's: drawn from the
    # seed, it left the event-only estimator uninitialized on some seeds
    tau = float(traffic["circuit"]["start_s"])
    tex_scale = scene["fx"] / scene["plane_z_m"]
    side = _texture_side(scene, cc, tex_scale)
    # the scene's texture is the traffic's own (its "seed"): the run's seed
    # varies where the period starts and the IMU noise over one scene
    tex_gen = torch.Generator(device=device)
    tex_gen.manual_seed(int(traffic["texture"]["seed"]))
    tex = value_noise_texture(tex_gen, side, int(traffic["texture"]["cell_px"]),
                              int(traffic["texture"]["octaves"]), device)
    f64 = dict(dtype=torch.float64, device=device)
    cams = [(0.0, 0.0, 0.0), (scene["baseline_m"], 0.0, 0.0)]

    # events: the contrast model stepped at render_hz over a pre-roll that
    # ends at the period's start (the model's state there is as in the
    # continuing stream), then over the period; stamps in (0, T]
    hz = float(ev["render_hz"])
    n_steps = int(round(T * hz))
    n_pre = int(round(float(ev["preroll_s"]) * hz))
    C = float(ev["contrast"])
    events = []
    for off in cams:
        rnd = PlaneRenderer(tex, tex_scale, scene["plane_z_m"], scene["fx"],
                            scene["fy"], scene["cx"], scene["cy"], scene["width"],
                            scene["height"], off, device)
        ref = None
        parts = []
        for s0 in range(-n_pre, n_steps + 1, block):
            steps = torch.arange(s0, min(s0 + block, n_steps + 1), **f64)
            R, p, _ = pose(cc, steps / hz, tau)
            imgs = rnd.render(R, p)
            fired = torch.zeros(imgs.shape, dtype=torch.bool, device=device)
            pol = torch.zeros(imgs.shape, dtype=torch.bool, device=device)
            for k in range(imgs.shape[0]):
                if ref is None:
                    ref = imgs[k].clone()
                    continue
                d = imgs[k] - ref
                n = torch.floor(d.abs() / C)
                fired[k] = n >= 1
                pol[k] = d > 0
                ref += torch.sign(d) * n * C
            keep = steps > 0
            if not bool(keep.any()):
                continue
            fired, pol, st = fired[keep], pol[keep], steps[keep]
            s, y, x = torch.nonzero(fired, as_tuple=True)
            jitter = torch.rand(s.shape, generator=gen, **f64) * 1e-4
            parts.append((st[s] / hz - jitter, x, y, pol[s, y, x]))
        t = torch.cat([q[0] for q in parts])
        order = torch.sort(t, stable=True).indices
        events.append((t[order].cpu().numpy(),
                       *(torch.cat([q[i] for q in parts])[order].to(torch.int32)
                         .cpu().numpy() for i in (1, 2, 3))))

    # IMU: specific force and the forward interval's gyro, biases and
    # white noise; sample i at i / imu_hz, i < T * imu_hz
    ihz = float(imu_cfg["hz"])
    n_imu = int(round(T * ihz))
    ti = torch.arange(n_imu + 1, **f64) / ihz
    R, _, a = pose(cc, ti, tau)
    g = torch.tensor([0.0, 0.0, float(imu_cfg["g_norm"])], **f64)
    acc = torch.einsum("kji,kj->ki", R[:-1], a[:-1] + g)
    gyr = so3_log(R[:-1].transpose(1, 2) @ R[1:]) * ihz
    acc = acc + torch.tensor(imu_cfg["acc_bias"], **f64) \
        + torch.randn(acc.shape, generator=gen, **f64) * float(imu_cfg["acc_noise"])
    gyr = gyr + torch.tensor(imu_cfg["gyr_bias"], **f64) \
        + torch.randn(gyr.shape, generator=gen, **f64) * float(imu_cfg["gyr_noise"])
    imu = (ti[:-1].cpu().numpy(), acc.cpu().numpy(), gyr.cpu().numpy())

    # frames at mid-tick stamps (k + 0.5) / frame_hz, k < T * frame_hz
    frames, frame_t = (), np.zeros(0)
    fhz = float(scene.get("frame_hz", 0) or 0)
    if fhz:
        n_fr = int(round(T * fhz))
        tf = (torch.arange(n_fr, **f64) + 0.5) / fhz
        R, p, _ = pose(cc, tf, tau)
        out = []
        for off in cams:
            rnd = PlaneRenderer(tex, tex_scale, scene["plane_z_m"], scene["img_fx"],
                                scene["img_fy"], scene["img_cx"], scene["img_cy"],
                                scene["img_width"], scene["img_height"], off, device)
            imgs = torch.cat([rnd.render(R[i:i + block], p[i:i + block])
                              for i in range(0, n_fr, block)])
            out.append(imgs.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
        frames, frame_t = tuple(out), tf.cpu().numpy()
    return Period(T, tau, tuple(events), imu, frames, frame_t,
                  tuple(len(e[0]) for e in events))
