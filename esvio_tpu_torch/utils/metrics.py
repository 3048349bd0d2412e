"""Stage timers, metrics and profiling helpers (port of
esvio_tpu/utils/metrics.py).

  * StageTimer     — accumulating per-stage wall timers
  * Metrics        — counters / gauges / series, JSON-lines emission
  * trace          — a named range in the profiler's trace
                     (torch.profiler.record_function)
  * device_profile — a CPU + CUDA torch.profiler trace, exported as a
                     Chrome trace into a directory

Each StageTimer stage is also a `trace` range, so a device profile shows
the pipeline's stages.  StageTimer synchronizes the CUDA device before it
reads the clock at both ends of a stage when it is given a CUDA device:
PyTorch returns before the card finishes, so an unsynchronized host clock
would time the enqueue.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch


class StageTimer:
    """Accumulating wall-clock stage timers, each stage a `trace` range.

    >>> tim = StageTimer(device)
    >>> with tim("frontend"):  out = frontend(...)
    >>> tim.report()  # {'frontend': {'total_s':..., 'n':..., 'mean_ms':...}}
    """

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def _sync(self):
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            with trace(stage):
                yield self
        finally:
            self._sync()
            self.total[stage] += time.perf_counter() - t0
            self.count[stage] += 1

    def report(self):
        return {
            k: dict(total_s=round(self.total[k], 6), n=self.count[k],
                    mean_ms=round(self.total[k] / max(self.count[k], 1) * 1e3, 3))
            for k in self.total
        }


class Metrics:
    """Counters + gauges + simple series; `emit` writes one JSON line to the
    sink file (appended) when one is given."""

    def __init__(self, sink: Optional[str] = None):
        self.counters = defaultdict(float)
        self.gauges = {}
        self.series = defaultdict(list)
        self._sink = open(sink, "a") if sink else None

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float):
        self.series[name].append(float(value))

    def emit(self, **extra):
        """One JSON line with the current counters and gauges (+ extras)."""
        rec = dict(ts=time.time(), **{f"c.{k}": v for k, v in self.counters.items()},
                   **{f"g.{k}": v for k, v in self.gauges.items()}, **extra)
        line = json.dumps(rec)
        if self._sink:
            self._sink.write(line + "\n")
            self._sink.flush()
        return line

    def summary(self):
        out = dict(self.gauges)
        out.update(self.counters)
        for k, vs in self.series.items():
            if vs:
                s = sorted(vs)
                out[f"{k}.mean"] = sum(vs) / len(vs)
                out[f"{k}.p50"] = s[len(s) // 2]
                out[f"{k}.p95"] = s[min(len(s) - 1, int(len(s) * 0.95))]
                out[f"{k}.max"] = s[-1]
        return out

    def close(self):
        if self._sink:
            self._sink.close()
            self._sink = None


@contextlib.contextmanager
def trace(name: str):
    """A named range in the profiler's trace (record_function); a failure
    of the profiler raises."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_profile(log_dir: str):
    """Profile the block on the CPU and, when a card is visible, on CUDA;
    the trace is written into log_dir as a Chrome trace
    (trace_<pid>.json).  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def graph_ms(launch, reps: int) -> float:
    """Device ms per launch of `launch()`: `reps` launches captured in one
    CUDA graph and replayed three times between CUDA events, so the host's
    launch cost leaves no gaps between them."""
    launch()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            launch()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)

