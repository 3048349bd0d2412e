"""Stage timers, metrics and profiling helpers (port of
esvio_tpu/utils/metrics.py).

  * StageTimer     — accumulating per-stage wall timers
  * Metrics        — counters / gauges / series, JSON-lines emission, and,
                     with `record=True`, the per-tick record: one line per
                     tick with its spans and counts
  * span / count / count_later / to_host — the record's hooks for the
                     modules a tick calls: a sub-span, a count, a count read
                     from the device when its stage has closed, a counted
                     device→host read
  * trace          — a named range in the profiler's trace
                     (torch.profiler.record_function)
  * device_profile — a CPU + CUDA torch.profiler trace, exported as a
                     Chrome trace into a directory

Each StageTimer stage is also a `trace` range, so a device profile shows
the pipeline's stages.  StageTimer synchronizes the CUDA device before it
reads the clock at both ends of a stage when it is given a CUDA device:
PyTorch returns before the card finishes, so an unsynchronized host clock
would time the enqueue.

The per-tick record.  Each span holds its name, its parent span's name,
the tick it belongs to and its host start and end, stamped by
`time.perf_counter_ns()` and put on the Unix clock in ns (the clock of
torch.profiler's events) by the offset `time.time_ns() - perf_counter_ns()`
noted once when the record starts.  A StageTimer given the record makes
each stage a span of the stage's tick, from after the opening
synchronisation to after the closing one, as it times the stage; a span
opened inside it is a `record_function` range too, so the profiler shows
it.  Counts are kept per tick and per stage (the outermost open span).
Everything stays in memory (`Metrics.ticks`).  Off (no record is active),
`span` returns a shared null context and `count` returns at once: nothing
is stamped, entered or allocated.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch

_NULL = contextlib.nullcontext()
# the Metrics whose per-tick record is on (`Metrics.recording`), or None
_active = None


def span(name: str):
    """A span of the active record inside its innermost open span (of that
    span's tick), also a `record_function` range; the shared null context
    when no record is active."""
    m = _active
    return _NULL if m is None else m.span(name)


def count(name: str, n: int = 1):
    """Add n to the active record's count `name` for the current tick and
    stage; nothing when no record is active."""
    m = _active
    if m is not None:
        m.count_tick(name, n)


def count_later(name: str, read):
    """Add read() to the active record's count `name` for the current tick
    and stage, calling it when the outermost open span closes (a stage:
    after its closing synchronisation, so the read waits for nothing) or
    the tick ends; nothing when no record is active.  For counts that live
    on the device, such as K3's iteration counts."""
    m = _active
    if m is not None:
        m.count_tick_later(name, read)


def to_host(x):
    """A blocking device→host read of tensor x, counted as one
    `host_fetches` of the current tick: a Python number for a 0-d tensor
    (`item`, which makes no host tensor), else a numpy array."""
    count("host_fetches")
    return x.item() if x.dim() == 0 else x.detach().cpu().numpy()


class StageTimer:
    """Accumulating wall-clock stage timers, each stage a `trace` range.

    >>> tim = StageTimer(device)
    >>> with tim("frontend"):  out = frontend(...)
    >>> tim.report()  # {'frontend': {'total_s':..., 'n':..., 'mean_ms':...}}
    """

    def __init__(self, device=None, record: Optional["Metrics"] = None):
        dev = torch.device(device) if device is not None else None
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.record = record   # a Metrics with record=True: stages are spans

    def _sync(self):
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    @contextlib.contextmanager
    def __call__(self, stage: str, tick=None):
        """Time `stage`; with a record, also its span in tick `tick` (the
        key `Metrics.begin_tick` returned)."""
        self._sync()
        t0 = time.perf_counter()
        rec = self.record
        with _NULL if rec is None else rec.span(stage, tick, ranged=False):
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


class _Span:
    """An open span of a tick record."""

    __slots__ = ("rec", "name", "tick", "ranged", "parent", "stage", "base",
                 "rf", "start")

    def __init__(self, rec, name, tick, ranged):
        self.rec, self.name, self.tick, self.ranged = rec, name, tick, ranged

    def __enter__(self):
        self.rec._open_span(self)
        return self

    def __exit__(self, *exc):
        self.rec._close_span(self)


class Metrics:
    """Counters + gauges + simple series; `emit` writes one JSON line to the
    sink file (appended) when one is given.

    With `record=True`, also the per-tick record (module docstring): the
    pipeline calls `begin_tick` at a tick's hand-over, times its stages
    with a StageTimer given this Metrics, and `end_tick` closes the tick's
    line into `ticks`: dict(tick = the sensor stamp, handover_ns, pose_ns,
    pose_latency_ns, end_ns, spans = [[name, parent, start_ns, end_ns]],
    counts = {name: {stage: n}}, and the fields the pipeline sets)."""

    def __init__(self, sink: Optional[str] = None, record: bool = False):
        self.counters = defaultdict(float)
        self.gauges = {}
        self.series = defaultdict(list)
        self._sink = open(sink, "a") if sink else None
        self.ticks = [] if record else None   # the finished tick lines
        if record:
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
            self._open = {}      # key -> line of a tick not yet ended
            self._stack = []     # open spans, innermost last
            self._orphans = []   # spans closed before their tick began
            self._watch = {}     # name -> cumulative count, read at stages
            self._later = []     # (key, stage, name, read) of count_later
            self._latest = None  # key of the latest tick begun
            self._n = 0

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

    # ------------------------------------------------- the per-tick record
    @contextlib.contextmanager
    def recording(self):
        """Make this record the active one (`span`, `count`, `to_host`)
        for the block; without a record, nothing."""
        global _active
        if self.ticks is None:
            yield self
            return
        prev, _active = _active, self
        try:
            yield self
        finally:
            _active = prev

    def watch(self, **sources):
        """Cumulative counts (name=callable) read when a stage opens and
        closes: each stage adds its delta to the tick's count `name`."""
        self._watch.update(sources)

    def _now(self):
        return time.perf_counter_ns() + self.offset_ns

    def begin_tick(self, tick: float):
        """A tick handed over now, with sensor stamp `tick`; returns its key
        (None without a record).  Spans closed since the last tick began
        (the pull that handed this one over) join it."""
        if self.ticks is None:
            return None
        key = self._n
        self._n += 1
        self._open[key] = dict(tick=float(tick), handover_ns=self._now(),
                               spans=self._orphans, counts={})
        self._orphans = []
        self._latest = key
        return key

    def tick_fields(self, key, **fields):
        if key is not None:
            self._open[key].update(fields)

    def mark(self, key, name: str):
        """Stamp the instant `name` (`<name>_ns`) in tick `key`."""
        if key is not None:
            self._open[key][name + "_ns"] = self._now()

    def end_tick(self, key, **fields):
        """Close tick `key`: its `tick` span runs from the hand-over to now."""
        if key is None:
            return
        self._read_later()
        line = self._open.pop(key)
        line.update(fields)
        line["end_ns"] = end = self._now()
        line["spans"].append(["tick", None, line["handover_ns"], end])
        if "pose_ns" in line:
            line["pose_latency_ns"] = line["pose_ns"] - line["handover_ns"]
        self.ticks.append(line)

    def span(self, name: str, tick=None, ranged: bool = True):
        """A span named `name` in tick `tick` (the key of `begin_tick`;
        default the innermost open span's).  ranged: also a
        `record_function` range."""
        return _Span(self, name, tick, ranged)

    def _open_span(self, sp):
        par = self._stack[-1] if self._stack else None
        if par is not None:
            if sp.tick is None:
                sp.tick = par.tick
            sp.parent, sp.stage, sp.base = par.name, par.stage, None
        else:
            sp.parent = None if sp.tick is None else "tick"
            sp.stage = sp.name
            sp.base = {k: f() for k, f in self._watch.items()} \
                if sp.tick is not None else None
        sp.rf = None
        if sp.ranged:
            sp.rf = torch.profiler.record_function(sp.name)
            sp.rf.__enter__()
        self._stack.append(sp)
        sp.start = time.perf_counter_ns()

    def _close_span(self, sp):
        end = time.perf_counter_ns()
        if sp.rf is not None:
            sp.rf.__exit__(None, None, None)
        self._stack.pop()
        if not self._stack:
            self._read_later()
        rec = [sp.name, sp.parent, sp.start + self.offset_ns,
               end + self.offset_ns]
        if sp.tick is None:
            self._orphans.append(rec)
            return
        line = self._open[sp.tick]
        line["spans"].append(rec)
        if sp.base:
            for k, f in self._watch.items():
                d = f() - sp.base[k]
                if d:
                    self._add(line, k, sp.stage, d)

    def _where(self):
        """(tick key, stage) of a count made now: the innermost open span's
        (outside every span: the latest tick begun, stage "pipeline")."""
        if self._stack:
            sp = self._stack[-1]
            return sp.tick, sp.stage
        return self._latest, "pipeline"

    def count_tick(self, name: str, n: int = 1):
        """Add n to count `name` of the current tick and stage (`_where`)."""
        key, stage = self._where()
        line = self._open.get(key)
        if line is not None:
            self._add(line, name, stage, n)

    def count_tick_later(self, name: str, read):
        """count_tick(name, read()), with read() called later (count_later)."""
        self._later.append((*self._where(), name, read))

    def _read_later(self):
        later, self._later = self._later, []
        for key, stage, name, read in later:
            line = self._open.get(key)
            if line is not None:
                self._add(line, name, stage, read())

    @staticmethod
    def _add(line, name, stage, n):
        c = line["counts"].setdefault(name, {})
        c[stage] = c.get(stage, 0) + n


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

