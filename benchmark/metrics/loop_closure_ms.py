"""loop closure: the StageTimer range `loop_closure`, from its start to the card
synchronisation that closes it, summed over the traced slice and divided
by its ticks (ms per tick)."""

LAYER = "loop closure"
UNIT = "ms"


def read(s):
    return s.stage_ms_per_tick("loop_closure")
