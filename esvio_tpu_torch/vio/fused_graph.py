"""Segment A of the steady estimator tick as CUDA graphs: the port's form of
the one `jax.jit` dispatch of esvio_tpu's `_fused_tick`.

One graph per static key (the keyword arguments of `_fused_segment_a`
and the per-tick input shapes), captured at the key's first tick and
replayed on every later one:

  * the IMU preintegration runs before it in two small graphs of a fixed
    chunk of steps, `head` from the start and `more` from where the last
    left off (the step index lives on the device), the latter replayed as
    often as the tick's longest interval asks: the step count, which
    grows with every tick that is not a keyframe, is no part of the key,
    so no tick past the first captures anew;
  * the state (window, both books, prior) lives in static device buffers;
    the graph writes the solved window and books back into them by `copy_`,
    and the estimator hands segment B's results to `adopt`, which does the
    same;
  * the per-tick inputs go in from pinned host staging buffers by
    `copy_(..., non_blocking=True)` before `replay()`;
  * `post` comes out packed in one static byte buffer: the tick's one
    device→host fetch (`fetch_post`);
  * the kernels' launch counters advance in Python, so during a capture
    they count launches that do not happen: those are taken back and added
    again on every replay.

A capture or replay that fails raises; nothing falls back to eager.
`pack_post` and `fetch_post` serve the eager path on the CPU as well.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from esvio_tpu_torch import _kernels
from esvio_tpu_torch.utils.metrics import count

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_, torch.uint8: np.uint8}


def pack_post(post):
    """A dict of tensors as one flat byte tensor, and its host layout
    ((name, numpy dtype, shape, byte offset), ...)."""
    parts, layout, off = [], [], 0
    for name, t in post.items():
        b = t.detach().reshape(-1).view(torch.uint8)
        layout.append((name, _NP_DTYPE[t.dtype], tuple(t.shape), off))
        parts.append(b)
        off += b.numel()
    return torch.cat(parts), tuple(layout)


def fetch_post(packed, layout):
    """One device→host copy of a packed dict (a counted host fetch),
    unpacked into numpy arrays that own their memory."""
    count("host_fetches")
    host = torch.empty(packed.shape, dtype=torch.uint8,
                       pin_memory=packed.is_cuda)
    host.copy_(packed)
    buf = host.numpy()
    return {name: np.frombuffer(buf, dt, int(np.prod(shape, dtype=np.int64)),
                                off).reshape(shape).copy()
            for name, dt, shape, off in layout}


def _tensors(states):
    """The tensors of a sequence of (nested) dataclasses, in field order."""
    out = []
    for obj in states:
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out.extend(_tensors([v]) if dataclasses.is_dataclass(v) else [v])
    return out


def clone_state(obj):
    """A deep copy of a (nested) dataclass of tensors."""
    return dataclasses.replace(obj, **{
        f.name: clone_state(v) if dataclasses.is_dataclass(v) else v.clone()
        for f in dataclasses.fields(obj)
        for v in [getattr(obj, f.name)]})


def _copy_into(dst_states, src_states):
    """copy_ every tensor of src_states into its counterpart of dst_states.
    A source that shares memory with any static tensor (the tensor itself
    or a view of it) is cloned first, so no copy reads a buffer that an
    earlier copy of the same call overwrote."""
    dsts, srcs = _tensors(dst_states), _tensors(src_states)
    static = {t.untyped_storage().data_ptr() for t in dsts}
    srcs = [s.clone() if s is not d
            and s.untyped_storage().data_ptr() in static else s
            for d, s in zip(dsts, srcs)]
    for d, s in zip(dsts, srcs):
        if d is not s:
            d.copy_(s)


def _graph(fn):
    """(graph, fn's output, the kernel launches it holds): fn captured
    with garbage collection off; the launch counters are set back."""
    before = {k: k.launches for k in _kernels.KERNELS}
    graph = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture: a dead pipeline's graph,
    # destroyed mid-capture by a collection in any thread, invalidates it
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        if gc_on:
            gc.enable()
    launches = {k: k.launches - before[k] for k in _kernels.KERNELS}
    for k in _kernels.KERNELS:
        k.launches = before[k]
    return graph, out, launches


class _Capture:
    """One captured segment A: its static inputs, graphs, outputs and the
    kernel launches they hold.  Two graphs of the chunk run before segment
    A's: `head`, from no carry, and `more`, from the carry, which it
    updates in place."""

    def __init__(self, device, inputs, dtypes):
        self.x = [torch.empty(tuple(np.shape(v)), dtype=d, device=device)
                  for v, d in zip(inputs, dtypes)]
        self.host = {}
        self.graphs = {}
        self.replays = 0

    def stage(self, inputs):
        for i, (dst, v) in enumerate(zip(self.x, inputs)):
            if not torch.is_tensor(v):
                h = self.host.get(i)
                if h is None:
                    h = self.host[i] = torch.empty(dst.shape, dtype=dst.dtype,
                                                   pin_memory=True)
                h.numpy()[...] = v
                v = h
            dst.copy_(v, non_blocking=True)

    def capture(self, segment, state, chunk):
        dev = self.x[0].device
        # one eager run on a side stream first: lazy initialisation (library
        # handles, workspaces, kernel attributes) must not fall in the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            segment(state, self.x,
                    chunk(state, self.x, chunk(state, self.x, None)))
        torch.cuda.current_stream(dev).wait_stream(side)
        g, self.carry, n = _graph(lambda: chunk(state, self.x, None))
        self.graphs["head"] = (g, n)
        g, _, n = _graph(lambda: _copy_into(
            [self.carry], [chunk(state, self.x, self.carry)]))
        self.graphs["more"] = (g, n)

        def seg():
            ws, bi, be, preints, post = segment(state, self.x, self.carry)
            self.packed, self.layout = pack_post(post)
            # preints holds views of the static window (its linearization
            # biases are ws.Ba/Bg[:W]): copied out before the write-back
            self.preints = clone_state(preints)
            _copy_into(state[:3], (ws, bi, be))
        g, _, n = _graph(seg)
        self.graphs["main"] = (g, n)

    def replay(self, n_chunks):
        """head, more n_chunks - 1 times, then main."""
        for name in ["head"] + ["more"] * (n_chunks - 1) + ["main"]:
            graph, launches = self.graphs[name]
            graph.replay()
            for k, n in launches.items():
                k.launches += n
        self.replays += 1


class TickGraphs:
    """The static state of one estimator and its captured segment A graphs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.state = None
        self._caps = {}
        self.n_captures = 0
        self.n_replays = 0

    def adopt(self, state):
        """Copy `state` (ws, book_img, book_evt, prior) into the static
        buffers, allocated at the first call; returns the static state."""
        state = tuple(state)
        if self.state is None:
            self.state = tuple(clone_state(s) for s in state)
        elif any(a is not b for a, b in zip(self.state, state)):
            _copy_into(self.state, state)
        return self.state

    def replays_by_key(self):
        """[(static keyword arguments as a dict, replays)] per capture."""
        return [(dict(k[0]), cap.replays) for k, cap in self._caps.items()]

    def run(self, key, segment, state, inputs, dtypes, chunk, n_chunks):
        """Segment A by graph replay: `segment(state, x, carry)` computes it
        from the static state, the static inputs x, which `inputs` (numpy
        arrays or tensors, in order) are staged into, and the carry of
        `chunk(state, x, carry)` run n_chunks times from carry None.
        Returns (x, (ws, book_img, book_evt), preints, packed, layout), all
        static."""
        state = self.adopt(state)
        key = (key, tuple(tuple(np.shape(v)) for v in inputs))
        cap = self._caps.get(key)
        if cap is None:
            cap = _Capture(self.device, inputs, dtypes)
            cap.stage(inputs)
            cap.capture(segment, state, chunk)
            self._caps[key] = cap
            self.n_captures += 1
        else:
            cap.stage(inputs)
        cap.replay(n_chunks)
        self.n_replays += 1
        return cap.x, state[:3], cap.preints, cap.packed, cap.layout
