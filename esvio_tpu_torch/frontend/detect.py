"""Shi-Tomasi (min-eigenvalue) corner detection, the goodFeaturesToTrack
analog of the image path (port of esvio_tpu/frontend/detect.py).

Structure tensor from Sobel gradients box-filtered over 3×3, min-eig
response, quality-level gate, 3×3 non-maximum suppression and top-K.  The
top-K breaks ties by the lower flat index, as `jax.lax.top_k` does: the
candidate order sets the spacing priority and the new feature ids.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from esvio_tpu_torch.frontend.pyramid import _sep_conv2d

_SOBEL_D = np.array([-1.0, 0.0, 1.0]) / 2.0
_SOBEL_S = np.array([1.0, 2.0, 1.0]) / 4.0
_BOX3 = np.ones((3,)) / 3.0


def shi_tomasi(img, max_corners: int = 512, quality_level: float = 0.01):
    """Top-K min-eig corners of an (H, W) image with quality gate and 3×3
    NMS.  Returns (xy (K, 2), response (K,), valid (K,))."""
    dtype = img.dtype
    # the taps are cast to the image dtype by each scalar multiply, as the
    # JAX version casts them before the convolution
    ix = _sep_conv2d(img, _SOBEL_S, _SOBEL_D)
    iy = _sep_conv2d(img, _SOBEL_D, _SOBEL_S)
    gxx = _sep_conv2d(ix * ix, _BOX3, _BOX3)
    gxy = _sep_conv2d(ix * iy, _BOX3, _BOX3)
    gyy = _sep_conv2d(iy * iy, _BOX3, _BOX3)
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4.0 * gxy ** 2))

    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    min_eig = torch.where(inside, min_eig, torch.zeros_like(min_eig))

    # 3×3 max with -inf "SAME" padding (max_pool2d pads with -inf)
    neigh = F.max_pool2d(min_eig[None, None], 3, stride=1, padding=1)[0, 0]
    is_max = (min_eig >= neigh) & (min_eig > 0)
    resp = torch.where(is_max, min_eig, torch.zeros_like(min_eig))
    gate = quality_level * torch.max(resp)
    flat = torch.where(resp >= gate, resp, torch.zeros_like(resp)).reshape(-1)
    # stable descending sort: equal responses keep flat-index order
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    xy = torch.stack([(idx % W).to(dtype), (idx // W).to(dtype)], dim=-1)
    return xy, vals, vals > 0
