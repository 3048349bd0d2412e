"""kernel K1 (csrc/corner_mask.cu): the kernel's bound at the cell's event
geometry (2, H, W) (harness/roofline.k1_bound_s) over its mean device time
per launch in the traced slice, in %.  Nothing to read without a launch."""
from harness import roofline

LAYER = "kernel K1"
UNIT = "%"


def read(s):
    times = s.kernel_times_s(roofline.K1_KERNEL)
    if not times or s.peaks is None:
        return None
    bound = roofline.k1_bound_s(2, s.cell["height"], s.cell["width"], s.peaks)
    return 100.0 * bound / (sum(times) / len(times))
