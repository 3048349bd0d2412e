"""image front end: device time of the host-to-card copies (`Memcpy HtoD`)
inside the StageTimer ranges `frontend_image`, each to the synchronisation
that closes it (harness/stage_busy.py), summed over the traced slice and
divided by its ticks (ms per tick): the frame hand-over, with the stage's
few small copies beside it."""
from harness import stage_busy

LAYER = "image front end"
UNIT = "ms"


def read(s):
    return stage_busy.busy_ms_per_tick(s, "frontend_image", "Memcpy HtoD")
