"""Kernel K3 (frontend/lk.launch_k3) against the plain LK pair at the
benchmark cells' shapes, on one device.  numpy and torch only: chip_smoke.py's
K3 phase and tests/test_torch_lk_card.py run it on the card.

Inputs (`CASES`): 346x260 time surfaces (HKU DAVIS346 events, both cells'
event front end at revisit's size), 346x260 frames (revisit's image front
end) and 640x480 time surfaces (DSEC, drive); 256 lanes
(`TrackerConfig.capacity`), 150 of them valid (revisit's `max_cnt`), points
on the texture's edges and a few near the borders; 4 + 2 levels and 30
iterations, the temporal pair of the cells' YAML.  The current image is the
previous one moved by (1.7, -1.2) px.

Tolerances, and why: the kernel sums the 441 window products with warp
shuffles, the plain version with torch's reductions, so the two round
differently and a lane whose min eigenvalue, border distance or |δ| lies
within float32 rounding of its threshold may go either way.  A lane is
*settled* when the plain version gives it the same forward and reverse
status in float64 on the CPU as in float32, and points within 1e-3 px.
On every settled lane the statuses must be equal, and where both paths say
ok the points must agree within 1e-3 px; the per-level iteration counts
(the most of any lane, the plain loop's count) must be equal.
"""
from __future__ import annotations

import numpy as np
import torch

from esvio_tpu_torch.events import sae as sae_mod
from esvio_tpu_torch.frontend import lk, pyramid

CASES = (("time_surface", 260, 346), ("frame", 260, 346), ("time_surface", 480, 640))
LANES = 256
VALID = 150
LEVELS = 4
ITERS = 30
SHIFT = (1.7, -1.2)
PX_TOL = 1e-3


def _blobs(H, W, rng):
    """Binary blobs: smoothed noise above its upper quartile."""
    noise = rng.normal(0, 1, (H, W))
    k = np.ones(7) / 7.0
    for ax in (0, 1):
        noise = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, noise)
    return noise > np.percentile(noise, 75)


def _shifted(img, dx, dy):
    """img resampled at (x - dx, y - dy), bilinear, edges replicated."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    x = np.clip(xx - dx, 0, W - 1)
    y = np.clip(yy - dy, 0, H - 1)
    x0 = np.minimum(np.floor(x).astype(int), W - 2)
    y0 = np.minimum(np.floor(y).astype(int), H - 2)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def _time_surface(tex, dx, dy, device):
    """The port's time surface (20 ms decay) of a texture's edge events while
    it moves by (dx, dy) px in 8 steps of 2.5 ms."""
    H, W = tex.shape
    sae = np.zeros((2, H, W), np.float32)
    prev = tex
    steps = 8
    for s in range(1, steps + 1):
        cur = _shifted(tex.astype(np.float64), dx * s / steps, dy * s / steps) > 0.5
        on, off = cur & ~prev, prev & ~cur
        sae[1][on] = 1.0 + 0.0025 * s
        sae[0][off] = 1.0 + 0.0025 * s
        prev = cur
    st = sae_mod.SAEState(sae=torch.tensor(sae, device=device),
                          sae_latest=torch.tensor(sae, device=device))
    return sae_mod.time_surface(st, 1.0 + 0.0025 * steps, 20.0)


def inputs(kind, H, W, seed, device):
    """(pyr_prev, pyr_cur, pts, valid) of one case on `device`, float32."""
    rng = np.random.default_rng(seed)
    pad = 16
    if kind == "frame":
        yy, xx = np.mgrid[0:H + pad, 0:W + pad].astype(np.float64)
        base = np.zeros_like(xx)
        for _ in range(6):
            fx, fy, ph = rng.uniform(0.05, 0.2), rng.uniform(0.05, 0.2), rng.uniform(0, 6)
            base += np.sin(fx * xx + ph) * np.cos(fy * yy - ph)
        base = 127.5 + 20.0 * base + 40.0 * _blobs(H + pad, W + pad, rng)
        prev = base[:H, :W]
        cur = _shifted(base, *SHIFT)[:H, :W]
        to = lambda a: torch.tensor(np.round(a).astype(np.float32), device=device)
        prev, cur = to(prev), to(cur)
        edge = np.abs(np.gradient(base[:H, :W])[0]) + np.abs(np.gradient(base[:H, :W])[1])
        cand = np.argwhere(edge > np.percentile(edge, 80))
    else:
        tex = _blobs(H + pad, W + pad, rng)
        prev = _time_surface(tex, -SHIFT[0], -SHIFT[1], device)[:H, :W]
        cur = _time_surface(_shifted(tex.astype(np.float64), *SHIFT) > 0.5,
                            -SHIFT[0], -SHIFT[1], device)[:H, :W]
        prev, cur = prev.contiguous(), cur.contiguous()
        cand = np.argwhere(prev.cpu().numpy() != 128.0)
    pick = cand[rng.choice(len(cand), LANES - 16, replace=False)]
    pts = np.concatenate([
        np.stack([pick[:, 1], pick[:, 0]], -1) + rng.uniform(0, 1, (LANES - 16, 2)),
        # near the borders: the status terms decide these
        np.stack([np.where(rng.random(16) < 0.5, rng.uniform(-2, 14, 16),
                           rng.uniform(W - 14, W + 2, 16)),
                  rng.uniform(0, H, 16)], -1)]).astype(np.float32)
    valid = np.zeros(LANES, bool)
    valid[rng.choice(LANES, VALID, replace=False)] = True
    return (pyramid.build_lk_pyramid(prev, LEVELS), pyramid.build_lk_pyramid(cur, LEVELS),
            torch.tensor(pts, device=device), torch.tensor(valid, device=device))


def plain_pair(pyr_prev, pyr_cur, pts, valid):
    """The plain version's pair and its level loops' iteration counts."""
    counts = []
    count = lk.count
    lk.count = lambda name, n=1: counts.append(n) if name == "lk_iters" else None
    try:
        out = lk.lk_track(pyr_prev, pyr_cur, pts, valid, iters=ITERS)
        back = lk.lk_track(pyr_cur[:lk.FB_LEVELS], pyr_prev[:lk.FB_LEVELS], out[0], out[1],
                           pts_init=pts, iters=ITERS)
    finally:
        lk.count = count
    return (*out, *back), counts


def compare(kind, H, W, seed, device, run_k3=lk.launch_k3):
    """Run K3 (`run_k3`, as `lk.launch_k3`) and the plain pair on `device`
    and the plain pair in float64 on the CPU; raise AssertionError beyond
    the tolerances.  Returns a summary dict."""
    pyr_p, pyr_c, pts, valid = inputs(kind, H, W, seed, device)
    pts_out, st_out, lane_iters = run_k3(pyr_p, pyr_c, pts, valid, iters=ITERS)
    got = (pts_out[0], st_out[0], pts_out[1], st_out[1])
    want, counts = plain_pair(pyr_p, pyr_c, pts, valid)
    f64 = lambda pyr: [(lvl[0].cpu().double(),) for lvl in pyr]
    ref, _ = plain_pair(f64(pyr_p), f64(pyr_c), pts.cpu().double(), valid.cpu())
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    settled = ((want[1] == ref[1]) & (want[3] == ref[3])
               & ((want[0].double() - ref[0]).abs().amax(-1) <= PX_TOL)
               & ((want[2].double() - ref[2]).abs().amax(-1) <= PX_TOL))
    k3_counts = lane_iters.amax(0).tolist()
    out = dict(kind=kind, H=H, W=W, lanes=LANES, valid=int(valid.sum()),
               ok_fwd=int(want[1].sum()), ok_back=int(want[3].sum()),
               unsettled=int((~settled).sum()), counts=counts, k3_iters=k3_counts)
    bad = []
    for i, name in ((1, "forward"), (3, "reverse")):
        n = int(((got[i] != want[i]) & settled).sum())
        if n:
            bad.append(f"{name} status differs on {n} settled lanes")
    for i, s, name in ((0, 1, "forward"), (2, 3, "reverse")):
        both = got[s] & want[s] & settled
        err = float((got[i] - want[i])[both].abs().max()) if both.any() else 0.0
        out[f"max_px_{name}"] = err
        if not err <= PX_TOL:
            bad.append(f"{name} points {err:.3g} px apart")
    if k3_counts != counts:
        bad.append(f"iterations: K3 {k3_counts}, plain {counts}")
    if not int(want[1].sum()) > VALID // 3:
        bad.append(f"only {int(want[1].sum())} lanes tracked: a weak case")
    if bad:
        raise AssertionError(f"K3 {kind} {H}x{W}: " + "; ".join(bad) + f" ({out})")
    return out
