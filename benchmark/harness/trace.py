"""The traced slice: a torch.profiler over a few steady window ticks,
reduced in memory to what the per-layer metrics read.

Nothing is exported.  From the profiler's events it keeps the device
intervals (kernels, copies, sets) and the host events of the thread that
drives the pipeline, and works out:

  * stage walls: each StageTimer range (`frontend_event`, `frontend_image`,
    `estimator`, `loop_closure`) from its start to the end of the card
    synchronisation that closes it (StageTimer synchronises after the
    range), summed per stage;
  * device busy seconds: the union of the device intervals;
  * kernel device seconds by name;
  * the breakdown: device operations by total time, and idle gaps of the
    device by what the host was doing (the stage range and the innermost
    host operation around the gap's middle).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

STAGES = ("frontend_event", "frontend_image", "estimator", "loop_closure")
_SYNC = "cudaDeviceSynchronize"


class Slice:
    """What the per-layer readers see of a traced run."""

    def __init__(self, cell, ticks, window_s, device_iv, host_ev, ingest_s,
                 peaks):
        self.cell = cell
        self.ticks = ticks              # window ticks inside the slice
        self.window_s = window_s        # host seconds the profiler ran
        self.ingest_s = ingest_s        # every window tick's chunker pull
        self.peaks = peaks
        self.device_iv = sorted(device_iv, key=lambda e: e[1])  # (name, s, e)
        self.host_ev = host_ev          # (name, start, end, parent index)
        self._busy = None

    # ---------------------------------------------------------- device
    def merged_busy(self):
        """Union of the device intervals, as sorted disjoint (start, end)."""
        if self._busy is None:
            out = []
            for _, s, e in self.device_iv:
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._busy = out
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged_busy()) * 1e-6

    def kernel_times_s(self, kernel: str):
        """Device seconds of each launch of the kernels whose name holds
        `kernel`."""
        return [(e - s) * 1e-6 for n, s, e in self.device_iv if kernel in n]

    def device_ops(self, top=10):
        tot = defaultdict(float)
        for n, s, e in self.device_iv:
            tot[n] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in tot.items()), key=lambda r: -r[1])[:top]

    # ---------------------------------------------------------- host
    def stage_walls_s(self):
        """{stage: [wall seconds of each occurrence]} in the slice."""
        syncs = sorted(s for n, s, e, _ in self.host_ev if n == _SYNC)
        sync_end = {s: e for n, s, e, _ in self.host_ev if n == _SYNC}
        out = defaultdict(list)
        for n, s, e, _ in self.host_ev:
            if n not in STAGES:
                continue
            i = bisect.bisect_left(syncs, e)
            end = max(e, sync_end[syncs[i]]) if i < len(syncs) else e
            out[n].append((end - s) * 1e-6)
        return out

    def stage_ms_per_tick(self, stage: str):
        walls = self.stage_walls_s().get(stage)
        if not walls or not self.ticks:
            return None
        return sum(walls) / self.ticks * 1e3

    def idle_gaps(self, top=10):
        """Idle device seconds by what the host was doing, largest first."""
        busy = self.merged_busy()
        ev = sorted(self.host_ev, key=lambda h: h[1])
        starts = [h[1] for h in ev]
        stage_iv = sorted((s, e, n) for n, s, e, _ in ev if n in STAGES)
        stage_starts = [s for s, _, _ in stage_iv]
        tot = defaultdict(float)
        for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
            mid = 0.5 * (e0 + s1)
            i = bisect.bisect_right(starts, mid) - 1
            op = "host outside any operation"
            for k in range(i, max(i - 400, -1), -1):
                if ev[k][2] >= mid and ev[k][0] not in STAGES:
                    op = ev[k][0]
                    break
            j = bisect.bisect_right(stage_starts, mid) - 1
            stage = stage_iv[j][2] if j >= 0 and stage_iv[j][1] >= mid \
                else "between stages"
            tot[f"{stage}: {op}"] += (s1 - e0) * 1e-6
        return sorted(([n, v] for n, v in tot.items()), key=lambda r: -r[1])[:top]


def collect(prof):
    """(device intervals, host events of the busiest host thread and every
    card synchronisation) from a stopped torch.profiler.profile, times in
    microseconds.  Reads the profiler's raw events: building its
    FunctionEvent objects takes some fifty times as long."""
    from torch.autograd import DeviceType
    device_iv, host = [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == DeviceType.CUDA:
            # a range of the host drawn on the device's timeline is no work
            if e.is_user_annotation() or name in STAGES:
                continue
            device_iv.append((name, s, t))
        elif e.device_type() == DeviceType.CPU and not e.is_async():
            host[e.start_thread_id()].append((name, s, t, None))
    main = max(host, key=lambda k: len(host[k])) if host else None
    # the runtime's synchronisations may be recorded under another thread
    # id than the operations of the thread that called them
    syncs = [h for k, evs in host.items() if k != main for h in evs
             if h[0] == _SYNC]
    return device_iv, host.get(main, []) + syncs
