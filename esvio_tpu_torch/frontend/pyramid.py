"""Image pyramids for pyramidal LK (port of esvio_tpu/frontend/pyramid.py).

Same role as OpenCV buildOpticalFlowPyramid in the reference
(feature_tracker.cpp:185): 5-tap Gaussian pyrDown with replicated borders,
written as unrolled shifted adds (the taps are exact binary fractions, and
the same add order as the JAX version).  Every function takes images of
shape (..., H, W).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _pad_edge(img, py, px):
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    flat = img.reshape((-1, 1, H, W))
    out = torch.nn.functional.pad(flat, (px, px, py, py), mode="replicate")
    return out.reshape(lead + (H + 2 * py, W + 2 * px))


def _sep_conv2d(img, ky, kx):
    """Separable 2-D convolution with edge replication, (..., H, W)."""
    H, W = img.shape[-2:]
    ky = np.asarray(ky, np.float64)
    kx = np.asarray(kx, np.float64)
    py = len(ky) // 2
    px = len(kx) // 2
    pad = _pad_edge(img, py, px)
    out = torch.zeros(img.shape[:-2] + (H, W + 2 * px), dtype=img.dtype,
                      device=img.device)
    for k in range(len(ky)):
        if ky[k] != 0.0:
            out = out + float(ky[k]) * pad[..., k:k + H, :]
    out2 = torch.zeros_like(img)
    for k in range(len(kx)):
        if kx[k] != 0.0:
            out2 = out2 + float(kx[k]) * out[..., :, k:k + W]
    return out2


def pyr_down(img):
    """Gaussian blur + 2× decimation (cv::pyrDown semantics)."""
    return _sep_conv2d(img, _GAUSS5, _GAUSS5)[..., ::2, ::2].contiguous()


def build_pyramid(img, levels: int) -> List[torch.Tensor]:
    """[level0 (full res), level1, ...] — `levels` entries."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def build_lk_pyramid(img, levels: int):
    """Pyramid of (image,) levels for LK tracking (gradients are taken
    inside lk's patches)."""
    return [(lvl,) for lvl in build_pyramid(img, levels)]
