"""The kernels' work counts and the card's peaks against chip_smoke.py's,
whose bare times and bounds fill PERF.md's kernel table."""
import math

import chip_smoke
from harness import roofline

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_counts_and_peaks_are_chip_smokes():
    assert roofline.K1_OPS_PER_PX == chip_smoke.K1_OPS_PER_PX == 163
    assert H100["f32_flops"] == chip_smoke.PEAK_F32
    assert H100["bytes"] == chip_smoke.PEAK_BYTES
    # 64 compares a clock per SM, 132 SMs at the 1,980 MHz boost clock
    assert H100["compares"] == chip_smoke.CMP_PER_CLOCK_PER_SM * 132 * 1980e6


def test_bounds_at_the_main_shapes():
    # chip_smoke's _bound at (2, 240, 320) for K1 and B = 1 for K2, as the
    # kernel table prints them: 1.497 us and 0.069 us
    k1 = roofline.k1_bound_s(2, 240, 320, H100)
    want1 = chip_smoke._bound(2 * 240 * 320 * 5, 2 * 240 * 320 * 163,
                              H100["compares"])[0] * 1e-3
    assert math.isclose(k1, want1, rel_tol=1e-12)
    assert round(k1 * 1e6, 3) == 1.497
    n = 190
    k2 = roofline.k2_bound_s(1, H100)
    want2 = chip_smoke._bound(4 * (n * n + 2 * n + 1), 2 * n ** 3 / 3 + 2 * n ** 2,
                              chip_smoke.PEAK_F32)[0] * 1e-3
    assert math.isclose(k2, want2, rel_tol=1e-12)
    assert round(k2 * 1e6, 3) == 0.069


def test_bounds_scale_with_the_work():
    assert math.isclose(roofline.k1_bound_s(2, 480, 640, H100),
                        4 * roofline.k1_bound_s(2, 240, 320, H100), rel_tol=1e-12)
    assert math.isclose(roofline.k2_bound_s(8, H100),
                        8 * roofline.k2_bound_s(1, H100), rel_tol=1e-12)
