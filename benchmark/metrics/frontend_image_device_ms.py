"""image front end: the device's busy time inside the StageTimer range
`frontend_image`, each range to the end of the card synchronisation that
closes it (harness/stage_busy.py), summed over the traced slice and
divided by its ticks (ms per tick).  Beside `frontend_image_ms`, the
stage's wall, it says how much of the image front end the card works."""
from harness import stage_busy

LAYER = "image front end"
UNIT = "ms"


def read(s):
    return stage_busy.busy_ms_per_tick(s, "frontend_image")
