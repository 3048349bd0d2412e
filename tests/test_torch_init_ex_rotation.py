"""The online camera-IMU rotation calibration drive (tests/test_estimator.
py's extrinsic drive, the identity guess ~16° off) on the JAX and the
port's estimator in lock step up to the init tick, without
ex_calib_require_stable here and with it in
test_torch_init_ex_rotation_stable.py (split from test_torch_init.py).

Decisions exact: the acceptance tick, the stability counts, init True on
the same tick.  The calibration pairs' essential-matrix rotations within
1e-3 (one 50 ms interval in float32), their IMU rotations within 1e-5, the
calibrated rotation within 1e-3 and the hand-eye solve on equal pairs
within 1e-4.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import synth_np
from torch_parity import jax_general_estimator, np_f32
from esvio_tpu.init import ex_rotation as jex
from esvio_tpu_torch.init import ex_rotation as tex
from esvio_tpu_torch.vio import estimator as test_


@pytest.mark.parametrize("require_stable", [False])
def test_ex_rotation_drive_matches_jax(require_stable):
    """Without the stability window (with it:
    test_torch_init_ex_rotation_stable.py)."""
    ex_rotation_drive_matches_jax(require_stable)


def ex_rotation_drive_matches_jax(require_stable):
    """The extrinsic drive (identity guess ~16° off) on both estimators in
    lock step up to the init tick: the same calibration pairs, the same
    acceptance tick, the same calibrated rotation, and both initialize on
    that tick (stopped there, before the window solve).  With
    ex_calib_require_stable the scale-invariant gate waits for 3
    consecutive solves within 1°: the same stability counts and candidates
    on every tick."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("ex_rotation")
    cfg_kw["ex_calib_require_stable"] = require_stable
    je = jax_general_estimator(ex_p, ex_q, cfg_kw)
    te = test_.Estimator(test_.EstimatorConfig(fused=False, **cfg_kw), ex_p,
                         ex_q, "cpu")
    stop = lambda: (_ for _ in ()).throw(StopIteration)
    je._triangulate = te._triangulate = stop
    done = {"j": None, "t": None}
    stable_seen = []
    for f, pkt in enumerate(packets):
        flags = {}
        for k, e in (("j", je), ("t", te)):
            if f > 0:
                synth_np.feed_imu(e, traj, f)
            try:
                e.process_packets(traj["t"][f], pkt)
            except StopIteration:
                pass
            flags[k] = e.solver_flag
            if e._ex_calib_done and done[k] is None:
                done[k] = f
        assert len(je._calib_pairs) == len(te._calib_pairs), f
        for (jc, ji), (tc, ti) in zip(je._calib_pairs, te._calib_pairs):
            # one 50 ms interval's essential-matrix rotation, in float32
            s = np.sign(float(np.dot(jc, tc)))
            np.testing.assert_allclose(s * tc, jc, atol=1e-3)
            np.testing.assert_allclose(ti, ji, atol=1e-5)
        assert flags["j"] == flags["t"], f
        assert je._ex_calib_stable == te._ex_calib_stable, f
        assert (je._ex_calib_last_q is None) == (te._ex_calib_last_q is None)
        if je._ex_calib_last_q is not None:
            stable_seen.append(je._ex_calib_stable)
            jl, tl = je._ex_calib_last_q, te._ex_calib_last_q
            np.testing.assert_allclose(np.sign(float(jl @ tl)) * tl, jl,
                                       atol=1e-3)
        if flags["j"] == "NON_LINEAR" or (require_stable
                                          and done["j"] is not None):
            break
    # the acceptance tick; without the stability window both initialize on
    # it (with it, the drive stops there)
    assert done["j"] is not None and done["j"] == done["t"] == f
    # the stability window ran (and only with the option on)
    assert bool(stable_seen) == require_stable, stable_seen
    # the drive's calibrated rotations: their pairs differ by the float32
    # essential matrices above, so within 1e-3; the hand-eye solve itself
    # on the JAX side's pairs within 1e-4
    jq, tq = np.asarray(je.ws.ex_q[1]), te.ws.ex_q[1].numpy()
    np.testing.assert_allclose(np.sign(float(jq @ tq)) * tq, jq, atol=1e-3)
    qc, qi = (np_f32(np.stack([p[i] for p in je._calib_pairs]))
              for i in (0, 1))
    args = (qc, qi, np_f32([1, 0, 0, 0]))
    jq2 = jex.calibrate_ex_rotation(*(jnp.asarray(a) for a in args))[0]
    tq2 = tex.calibrate_ex_rotation(*(torch.tensor(a) for a in args))[0]
    np.testing.assert_allclose(tq2.numpy(), np.asarray(jq2), atol=1e-4)
    if not require_stable:   # else the Huber weights came from a candidate
        np.testing.assert_allclose(np.asarray(jq2), jq, atol=1e-6)
