"""kernel K2 (csrc/chol_solve.cu): the kernel's bound for one system of
n = 190 (the estimator solves one window per launch, B = 1;
harness/roofline.k2_bound_s) over its mean device time per launch in the
traced slice, in %.  Nothing to read without a launch."""
from harness import roofline

LAYER = "kernel K2"
UNIT = "%"


def read(s):
    times = s.kernel_times_s(roofline.K2_KERNEL)
    if not times or s.peaks is None:
        return None
    return 100.0 * roofline.k2_bound_s(1, s.peaks) / (sum(times) / len(times))
