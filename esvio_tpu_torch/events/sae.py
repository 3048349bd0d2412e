"""Surface of Active Events (SAE) + exponential-decay time surfaces
(port of esvio_tpu/events/sae.py).

The refractory filter of an event depends only on the times of the
immediately preceding events at its pixel (event_detector.cc:149-166), so a
whole chunk is processed in parallel: one stable sort by pixel, a segmented
exclusive max-scan for the "previous time" of each event, then the tables
are updated with scatter-max (`scatter_reduce(..., "amax")`).

Acceptance rule (event_detector.cc:157): an event (t, x, y, pol) refreshes
``sae[pol]`` iff  t > t_prev_same + filter_threshold  OR
t_prev_inv > t_prev_same.  ``sae_latest[pol]`` always takes the newest time.

Every function takes an optional leading batch axis (the tracker runs the
left and right cameras as one batch of 2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_NEG = -1e30  # "no event yet" sentinel for max-scans; tables start at 0.0


@dataclasses.dataclass
class EventChunk:
    """Fixed-capacity chunk of events, time-sorted, mask-padded.

    t (E,) float32 seconds, x/y (E,) int32 column/row, p (E,) int32
    polarity in {0, 1}, valid (E,) bool.  `n_host` is the host-side event
    count, `n_offered` the events the stream had in the tick, of which the
    chunk keeps the latest `n_host` (metrics only)."""

    t: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    p: torch.Tensor
    valid: torch.Tensor
    n_host: Optional[int] = None
    n_offered: Optional[int] = None


@dataclasses.dataclass
class SAEState:
    """Per-camera SAE pair: filtered surface + raw latest surface, (2, H, W)."""

    sae: torch.Tensor
    sae_latest: torch.Tensor


def init_sae(height: int, width: int, device,
             dtype=torch.float32) -> SAEState:
    return SAEState(
        sae=torch.zeros((2, height, width), dtype=dtype, device=device),
        sae_latest=torch.zeros((2, height, width), dtype=dtype, device=device))


def _segmented_exclusive_max(vals, seg_first):
    """Exclusive max-scan of the columns of `vals` (N, C) that resets at
    segment starts; seg_first (N,) is the index of each row's segment
    start.  Hillis-Steele doubling: exact (max is order-free)."""
    N = vals.shape[0]
    idx = torch.arange(N, device=vals.device)
    neg = torch.full_like(vals[:1], _NEG)
    # exclusive: row i starts from row i-1 when it is in the same segment
    exc = torch.cat([neg, vals[:-1]], dim=0)
    exc = torch.where((idx > seg_first)[:, None], exc, torch.full_like(exc, _NEG))
    # first valid predecessor of exc[i] is i-1; scan over the segment prefix
    d = 1
    while d < N:
        prev = torch.cat([neg.expand(d, -1), exc[:-d]], dim=0)
        same = (idx - d > seg_first)[:, None]
        exc = torch.where(same, torch.maximum(exc, prev), exc)
        d *= 2
    return exc


def update_sae(state: SAEState, chunk: EventChunk, filter_threshold: float,
               return_accepted: bool = False) -> Tuple[SAEState, torch.Tensor]:
    """Apply one event chunk to the SAE.  Returns (new_state, accepted).

    Shapes: sae (2, H, W) with chunk fields (E,), or a batch sae (B, 2, H, W)
    with chunk fields (B, E).  `accepted` is in chunk order when
    `return_accepted`, else in the pixel-sorted order (callers ignore it).
    """
    batched = state.sae.dim() == 4
    sae = state.sae if batched else state.sae[None]
    lat = state.sae_latest if batched else state.sae_latest[None]
    t = chunk.t if batched else chunk.t[None]
    x = chunk.x if batched else chunk.x[None]
    y = chunk.y if batched else chunk.y[None]
    p = chunk.p if batched else chunk.p[None]
    valid = chunk.valid if batched else chunk.valid[None]
    B, _, H, W = sae.shape
    HW = H * W
    E = t.shape[1]
    dev = t.device

    # one global pixel index over the batch; padding sorts to the end
    cam = torch.arange(B, device=dev)[:, None]
    pix = torch.where(valid, cam * HW + y.long() * W + x.long(),
                      torch.full_like(cam * HW + y.long(), B * HW)).reshape(-1)
    pix_s, order = torch.sort(pix, stable=True)
    t_s = t.reshape(-1)[order]
    p_s = p.reshape(-1)[order]
    valid_s = pix_s < B * HW
    safe = torch.clamp(pix_s, max=B * HW - 1)
    b_s = safe // HW
    q_s = safe - b_s * HW

    N = pix_s.shape[0]
    idx = torch.arange(N, device=dev)
    seg_start = torch.ones(N, dtype=torch.bool, device=dev)
    seg_start[1:] = pix_s[1:] != pix_s[:-1]
    seg_first = torch.cummax(torch.where(seg_start, idx, torch.zeros_like(idx)),
                             dim=0).values

    neg = torch.full_like(t_s, _NEG)
    val_pos = torch.where(p_s == 1, t_s, neg)
    val_neg = torch.where(p_s == 0, t_s, neg)
    prev = _segmented_exclusive_max(torch.stack([val_neg, val_pos], 1),
                                    seg_first)

    lat_flat = lat.reshape(B, 2, HW)
    carried_neg = lat_flat[b_s, 0, q_s]
    carried_pos = lat_flat[b_s, 1, q_s]
    prev_neg = torch.maximum(prev[:, 0], carried_neg)
    prev_pos = torch.maximum(prev[:, 1], carried_pos)
    prev_same = torch.where(p_s == 1, prev_pos, prev_neg)
    prev_inv = torch.where(p_s == 1, prev_neg, prev_pos)
    accepted_s = ((t_s > prev_same + filter_threshold)
                  | (prev_inv > prev_same)) & valid_s

    # tables ← max(table, event times): every valid event into sae_latest,
    # accepted events into sae (in-place scatter-max on fresh copies)
    slot = (b_s * 2 + p_s.long()) * HW + q_s
    latest = lat.reshape(-1).clone()
    latest.scatter_reduce_(0, slot, torch.where(valid_s, t_s, neg), "amax")
    filtered = sae.reshape(-1).clone()
    filtered.scatter_reduce_(0, slot, torch.where(accepted_s, t_s, neg), "amax")

    shape = (B, 2, H, W) if batched else (2, H, W)
    if return_accepted:
        accepted = torch.zeros(B * E, dtype=torch.bool, device=dev)
        accepted[order] = accepted_s
        accepted = accepted.reshape(B, E) if batched else accepted.reshape(E)
    else:
        accepted = accepted_s
    return SAEState(sae=filtered.reshape(shape),
                    sae_latest=latest.reshape(shape)), accepted


def harvest_filter(state: SAEState, chunk: EventChunk) -> torch.Tensor:
    """Corner-harvest admission test against the post-chunk SAE
    (isCorner's opening rejection, event_detector.cc:315-317)."""
    H, W = state.sae.shape[1:]
    xs = torch.clamp(chunk.x.long(), 0, W - 1)
    ys = torch.clamp(chunk.y.long(), 0, H - 1)
    p = chunk.p.long()
    lat_same = state.sae_latest[p, ys, xs]
    lat_inv = state.sae_latest[1 - p, ys, xs]
    return ~(lat_inv > lat_same) & chunk.valid


def median_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """(2k+1)×(2k+1) median filter with replicated borders (cv::medianBlur
    analog, event_detector.cc:263-265).  img: (..., H, W)."""
    if ksize <= 0:
        return img
    k = ksize
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape((-1, 1, H, W))
    pad = torch.nn.functional.pad(flat, (k, k, k, k), mode="replicate")[:, 0]
    win = torch.stack([pad[:, dy:dy + H, dx:dx + W]
                       for dy in range(2 * k + 1) for dx in range(2 * k + 1)])
    med = torch.sort(win, dim=0).values[win.shape[0] // 2]
    return med.reshape(lead + (H, W))


def time_surface(state: SAEState, t_now, decay_ms: float,
                 ignore_polarity: bool = False, quantize: bool = True,
                 median_blur_ksize: int = 0) -> torch.Tensor:
    """Exponential-decay time surface (event_detector.cc:230-267):
    (..., H, W) in [0, 255], rounded to integers when `quantize`."""
    decay = decay_ms / 1000.0
    newest = torch.maximum(state.sae[..., 0, :, :], state.sae[..., 1, :, :])
    has_event = newest > 0.0
    val = torch.exp(-(t_now - newest) / decay)
    zero = torch.zeros_like(val)
    if ignore_polarity:
        out = torch.where(has_event, val, zero) * 255.0
    else:
        sign = torch.where(state.sae[..., 1, :, :] > state.sae[..., 0, :, :],
                           torch.ones_like(val), -torch.ones_like(val))
        out = 255.0 * (torch.where(has_event, val * sign, zero) + 1.0) * 0.5
    out = torch.clamp(out, 0.0, 255.0)
    if quantize:
        out = torch.round(out)
    if median_blur_ksize > 0:
        out = median_blur(out, median_blur_ksize)
    return out


def chunk_from_arrays(t, x, y, p, capacity: int, dtype=torch.float32,
                      device=None) -> EventChunk:
    """Host helper: pack numpy-ish arrays into a padded EventChunk."""
    import numpy as np

    n = min(len(t), capacity)
    T = np.zeros(capacity, np.float32)
    X = np.zeros(capacity, np.int32)
    Y = np.zeros(capacity, np.int32)
    P = np.zeros(capacity, np.int32)
    V = np.zeros(capacity, bool)
    T[:n] = np.asarray(t[:n], np.float32)
    X[:n] = np.asarray(x[:n], np.int32)
    Y[:n] = np.asarray(y[:n], np.int32)
    P[:n] = np.asarray(p[:n], np.int32)
    V[:n] = True
    as_t = lambda a: torch.from_numpy(a).to(device)
    return EventChunk(t=as_t(T).to(dtype), x=as_t(X), y=as_t(Y), p=as_t(P),
                      valid=as_t(V), n_host=n)
