"""tick_p95_ms is the 95th percentile over every tick of the window."""
import numpy as np
import pytest

import run


@pytest.mark.parametrize("n", [1, 2, 7, 20, 76, 143, 1000])
def test_percentile_over_all_ticks_is_numpys(n):
    v = list(np.random.default_rng(n).gamma(4.0, 0.15, n))
    for q in (5, 50, 95, 100):
        assert run.percentile(v, q) == pytest.approx(np.percentile(v, q), rel=1e-12)


def test_percentile_reads_the_tail_of_every_tick():
    ticks = [0.5] * 95 + [2.0] * 5
    assert run.percentile(ticks, 95) == pytest.approx(0.5 + 0.05 * 1.5)
    assert run.percentile(ticks[::-1], 95) == run.percentile(ticks, 95)
