"""CLAHE — contrast-limited adaptive histogram equalization (port of
esvio_tpu/frontend/clahe.py).

The cv::createCLAHE() path the reference enables with `equalize: 1`
(feature_tracker.cpp:375-387; OpenCV defaults clipLimit=40, tiles 8×8):
per-tile 256-bin histograms by one `bincount` over tile-offset bins, clip +
redistribute, CDF → LUTs, bilinear blend of the four neighbouring tiles'
LUTs.  Images are (..., H, W); each leading index is equalized alone.
"""
from __future__ import annotations

import torch

BINS = 256


def clahe(img, tiles: int = 8, clip_limit: float = 40.0):
    """img: (..., H, W) float in [0, 255]; the part of the image the tiles
    do not cover (H % tiles rows, W % tiles columns) keeps its input."""
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    dev = img.device
    th, tw = H // tiles, W // tiles
    x = img.reshape((-1, H, W))
    N = x.shape[0]
    T = tiles * tiles
    q = torch.round(torch.clamp(x[:, :th * tiles, :tw * tiles], 0.0, 255.0)
                    ).to(torch.int64)
    tiled = q.reshape(N, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4) \
        .reshape(N, T, th * tw)

    # one bincount over (image, tile, bin)
    base = torch.arange(N * T, device=dev).reshape(N, T, 1) * BINS
    hist = torch.bincount((base + tiled).reshape(-1), minlength=N * T * BINS) \
        .reshape(N, T, BINS).to(torch.float32)

    # clip + redistribute (OpenCV semantics: clipLimit scaled by tile size)
    limit = max(clip_limit * (th * tw) / BINS, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=2, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / BINS
    luts = torch.cumsum(hist, dim=2) * ((BINS - 1.0) / (th * tw))
    luts = luts.reshape(N, T * BINS)

    # bilinear interpolation between the 4 neighboring tile LUTs
    ty = torch.clamp((torch.arange(th * tiles, dtype=img.dtype, device=dev)
                      - th / 2) / th, 0.0, tiles - 1.0)
    tx = torch.clamp((torch.arange(tw * tiles, dtype=img.dtype, device=dev)
                      - tw / 2) / tw, 0.0, tiles - 1.0)
    y0 = torch.floor(ty).to(torch.int64)
    x0 = torch.floor(tx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=tiles - 1)
    x1 = torch.clamp(x0 + 1, max=tiles - 1)
    fy = (ty - y0)[:, None]
    fx = (tx - x0)[None, :]

    def lut(yi, xi):
        flat = ((yi[:, None] * tiles + xi[None, :]) * BINS)[None] + q
        return torch.gather(luts, 1, flat.reshape(N, -1)).reshape(q.shape)

    out = (lut(y0, x0) * (1 - fy) * (1 - fx) + lut(y0, x1) * (1 - fy) * fx
           + lut(y1, x0) * fy * (1 - fx) + lut(y1, x1) * fy * fx)
    full = x.clone()
    full[:, :th * tiles, :tw * tiles] = out.to(img.dtype)
    return full.reshape(lead + (H, W))
