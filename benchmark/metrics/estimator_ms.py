"""back end: the StageTimer range `estimator`, from its start to the card
synchronisation that closes it, summed over the traced slice and divided
by its ticks (ms per tick)."""

LAYER = "back end"
UNIT = "ms"


def read(s):
    return s.stage_ms_per_tick("estimator")
