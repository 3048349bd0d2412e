"""device: the share of the traced slice's wall time in which no kernel,
copy or set ran on the card (100 - union of the device intervals over the
slice's wall), in %."""

LAYER = "device"
UNIT = "%"


def read(s):
    if s.window_s <= 0 or not s.device_iv:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s)
