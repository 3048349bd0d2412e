"""Device time inside one StageTimer stage of a traced slice.

A stage's ranges are bounded as `trace.Slice.stage_walls_s` bounds them,
from the range's start to the end of the card synchronisation that closes
it; the device intervals clipped to them are merged as
`trace.Slice.merged_busy` merges a slice's."""
from harness.trace import Slice


def ranges(s, stage):
    """[(start, end)] in us of each range of `stage` in the slice."""
    starts = [b for n, b, _, _ in s.host_ev if n == stage]
    walls = s.stage_walls_s().get(stage, [])
    return [(b, b + w * 1e6) for b, w in zip(starts, walls)]


def busy_ms_per_tick(s, stage, match=None):
    """The union of the device intervals inside the ranges of `stage`, of
    those whose name holds `match` (every one when None), in ms per tick of
    the slice; None without such a range, a tick or a device interval."""
    rs = ranges(s, stage)
    if not rs or not s.ticks or not s.device_iv:
        return None
    inside = [(n, max(b, r0), min(e, r1)) for n, b, e in s.device_iv
              if match is None or match in n
              for r0, r1 in rs if min(e, r1) > max(b, r0)]
    return Slice(None, s.ticks, s.window_s, inside, [], [], None).busy_s() \
        * 1e3 / s.ticks
