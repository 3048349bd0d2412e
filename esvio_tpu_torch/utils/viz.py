"""Debug visualization dumps — the rviz-publisher analog (port of
esvio_tpu/utils/viz.py).

The reference publishes tracking overlays and time-surface images as ROS
image topics (feature_tracker/src/utility/visualization.cpp:15-28,
pubTrackImage stereo_event_tracker_node.cpp:64-100); here the same views are
written as PNGs when the pipeline is given `dump_viz_dir`.  The images are
drawn on the host: `dump_tick` copies the tick's time surface and packet
from the device once.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def tracking_overlay(image, pts, valid, track_cnt=None) -> np.ndarray:
    """(H, W) grayscale + feature points → (H, W, 3) uint8 overlay.

    Colour encodes track length as the reference overlay does (red = new →
    blue = long-tracked, pubTrackImage's cv::circle colouring)."""
    img = np.clip(_host(image).astype(np.float32), 0, 255).astype(np.uint8)
    out = np.stack([img, img, img], -1)
    pts = _host(pts)
    valid = _host(valid)
    cnt = _host(track_cnt) if track_cnt is not None else np.zeros(len(pts))
    H, W = img.shape
    for k in np.nonzero(valid)[0]:
        x, y = int(round(float(pts[k, 0]))), int(round(float(pts[k, 1])))
        w = min(float(cnt[k]) / 20.0, 1.0)
        color = np.array([255 * (1 - w), 0, 255 * w], np.uint8)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                if dx * dx + dy * dy <= 4:
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < H and 0 <= xx < W:
                        out[yy, xx] = color
    return out


def save_png(path, array):
    """uint8 (H, W) or (H, W, 3) → PNG (PIL; without PIL, `path + ".npy"`
    as the JAX package writes it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        from PIL import Image
        Image.fromarray(np.asarray(array, np.uint8)).save(path)
    except ImportError:
        np.save(path + ".npy", np.asarray(array))


def dump_tick(dump_dir, tick, ts_left, packet):
    """Write the per-tick debug views: time surface + tracking overlay.  The
    time surface and the packet's points, mask and track counts come to the
    host in one copy (all exact in float32)."""
    parts = (ts_left, packet.uv, packet.valid, packet.track_cnt)
    flat = _host(torch.cat([torch.as_tensor(a).reshape(-1).float()
                            for a in parts]))
    H, W = ts_left.shape
    F = packet.valid.shape[0]
    ts, uv, valid, cnt = np.split(flat, np.cumsum([H * W, 2 * F, F]))
    ts, uv, valid = ts.reshape(H, W), uv.reshape(F, 2), valid > 0
    save_png(os.path.join(dump_dir, f"ts_{tick:06d}.png"),
             np.clip(ts, 0, 255).astype(np.uint8))
    save_png(os.path.join(dump_dir, f"track_{tick:06d}.png"),
             tracking_overlay(ts, uv, valid, cnt))
