"""The port's whole mono and extrinsic drives (tests/synth_np.
estimator_drive) on its fused default, under tests/test_estimator.py's
own gates (split from test_torch_init.py): NON_LINEAR through the mono
fallback with the last frame within 0.4 m; the extrinsic calibrated within
6 deg, NON_LINEAR only after it, the fused ticks reading it within 1 deg.
"""
import numpy as np

import synth_np
import torch_parity  # noqa: F401 (its torch thread cap)
from esvio_tpu_torch.vio import estimator as test_


def _angle_deg(q, q_ref):
    from esvio_tpu_torch.core import lie_np
    d = lie_np.quat_mul(np.array([q[0], -q[1], -q[2], -q[3]]), q_ref)
    return 2 * np.degrees(np.arctan2(np.linalg.norm(d[1:]), abs(d[0])))


def test_port_mono_drive():
    """tests/test_estimator.py::test_mono_init_fallback on the port's fused
    default: NON_LINEAR through the mono fallback, the last frame within the
    test's 0.4 m."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("mono")
    est = test_.Estimator(test_.EstimatorConfig(**cfg_kw), ex_p, ex_q, "cpu")
    calls = []
    real = est._try_initialize_mono
    est._try_initialize_mono = lambda: calls.append(real()) or calls[-1]
    outs = []
    for f, pkt in enumerate(packets):
        if f > 0:
            synth_np.feed_imu(est, traj, f)
        outs.append(est.process_packets(traj["t"][f], pkt))
    assert True in calls and outs[-1].solver_flag == "NON_LINEAR"
    assert np.linalg.norm(outs[-1].P - traj["P"][-1]) < 0.4


def test_port_ex_rotation_drive():
    """tests/test_estimator.py::test_online_ex_rotation_calibration on the
    port's fused default: calibrated within 6° of the truth, NON_LINEAR only
    after the calibration, and the steady ticks on the fused path read the
    calibrated extrinsic."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("ex_rotation")
    est = test_.Estimator(test_.EstimatorConfig(**cfg_kw), ex_p, ex_q, "cpu")
    assert not est._ex_calib_done
    fused = []
    real = est._process_packets_fused
    est._process_packets_fused = lambda *a: fused.append(
        est.ws.ex_q[1].numpy().copy()) or real(*a)
    done_at, first_nl = None, None
    for f, pkt in enumerate(packets):
        if f > 0:
            synth_np.feed_imu(est, traj, f)
        out = est.process_packets(traj["t"][f], pkt)
        if est._ex_calib_done and done_at is None:
            done_at = f
            q_acc = est.ws.ex_q[1].numpy().copy()
        if out.solver_flag == "NON_LINEAR" and first_nl is None:
            first_nl = f
    assert done_at is not None and first_nl is not None and first_nl >= done_at
    assert _angle_deg(est.ws.ex_q[1].numpy().astype(float),
                      synth_np.EX_CALIB_Q_BC) < 6.0
    assert fused and _angle_deg(fused[0].astype(float), q_acc.astype(float)) < 1.0
