"""`Pipeline.run`'s overlap and freq options on the golden sequence, on the
CPU (chunk_pairs and the watchdog: test_torch_watchdog.py).

Tolerances: none — trajectories equal; the tick's stamp within 1e-5 s (the
tracker keeps it in float32).
"""
import numpy as np
import pytest

import torch_parity  # noqa: F401 (its torch thread cap)
from synth_np import GOLDEN, vio_pipeline


@pytest.fixture(scope="module")
def golden():
    """(make_pipeline, the golden sequence) of the golden configuration."""
    make, seq, _, _ = vio_pipeline("cpu", **GOLDEN)
    return make, seq


def test_overlap_off_equals_overlap_on(golden):
    """Motion correction off: running each tick's estimator stage right
    after its front end changes only the order, not the trajectory."""
    make, seq = golden
    a = make().run(seq, max_frames=12)
    b = make().run(seq, max_frames=12, overlap=False)
    assert len(a.stamps) >= 2 and a.stamps == b.stamps
    np.testing.assert_array_equal(np.asarray(a.P), np.asarray(b.P))
    np.testing.assert_array_equal(np.asarray(a.V), np.asarray(b.V))


def test_freq_sets_the_tick_rate(golden):
    """run(freq=30) chunks the events at 30 Hz: the third tick ends 3/30 s
    after the first event (at the configuration's 15 Hz, 3/15 s)."""
    make, seq = golden
    t0 = seq.events_left.t[0]
    for freq, cfg_freq in ((30.0, False), (None, True)):
        pipe = make()
        pipe.run(seq, freq=freq, max_frames=3)
        hz = pipe.sys_cfg.freq if cfg_freq else freq
        assert abs(float(pipe.tracker_state.prev_time) - (t0 + 3 / hz)) < 1e-5
