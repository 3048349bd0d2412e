"""The slice as a whole: the port's ESIO pipeline (esvio_tpu_torch.apps.
pipeline) against the JAX pipeline and against the committed golden trace
tests/golden/esio_planar_rot.npz, on the CPU.

Gates and tolerances:
  * tests/synth_np.py reproduces tests/synth.py's golden sequence exactly
    (x64 is on in this suite, the setting the golden was made with);
  * tick by tick, the port's back end (general path) on the JAX tracker's
    packets against the JAX pipeline's general path (its marginalization
    in float64, as the port's): the same NON_LINEAR and IMU-rate stamps,
    and the positions of NON_LINEAR and the STEADY_TICKS after it within
    BACKEND_TOL_M.  Later positions drift apart through the float32 LM
    solves (3.6e-3 m at the sixth stamp, 1.7e-2 m at the last), less than
    the JAX package's own fused and general paths do on the same packets
    (5.7e-2 m).  All 14 stay inside the golden test's own gates
    (tests/test_golden_trace.py:78-86): the stamps within 1e-6 s, max
    deviation < 0.05 m, ATE <= 1.5 x golden + 0.01 m;

The port's own full run and the JAX back end on its packets are in
test_torch_pipeline_port.py.
"""
import dataclasses
import os

import numpy as np
import pytest

from torch_parity import jax_marginalization_f64, np_render_for_jax, to_torch
from synth_np import GOLDEN, golden_gates, vio_pipeline

GOLDEN_NPZ = os.path.join(os.path.dirname(__file__), "golden",
                          "esio_planar_rot.npz")
MAX_DEV_M = 0.05          # tests/test_golden_trace.py:83
BACKEND_TOL_M = 2e-3      # tests/test_fused_tick.py:66-67
STEADY_TICKS = 4


def test_synth_np_reproduces_the_golden_sequence():
    from synth import planar_vio_sequence_rot as jax_synth
    from synth_np import planar_vio_sequence_rot as np_synth
    kw = dict(H=120, W=160, focal=200.0, plane_z=4.0, baseline=0.10,
              duration=0.5)
    js, jt, jP = jax_synth(np.random.default_rng(0), **kw)
    ts, tt, tP = np_synth(np.random.default_rng(0), **kw)
    for side in ("events_left", "events_right"):
        for f in ("t", "x", "y", "p"):
            assert np.array_equal(getattr(getattr(js, side), f),
                                  getattr(getattr(ts, side), f)), (side, f)
    for f in ("t", "acc", "gyr"):
        assert np.array_equal(getattr(js.imu, f), getattr(ts.imu, f)), f
    assert np.array_equal(jt, tt) and np.array_equal(jP, tP)


@pytest.fixture(scope="module")
def jax_golden():
    """The JAX pipeline's general path (fused=False) over the golden run,
    its marginalization in float64, on the golden sequence as synth_np
    renders it: (result, the tracker packet of each tick)."""
    import jax
    import synth
    import esvio_tpu.apps.pipeline as jpipe
    from test_golden_trace import run_golden_pipeline

    track = jpipe.trk.track_event_stereo
    packets = []

    def recording(*a, **k):
        state, pkt = track(*a, **k)
        packets.append(jax.device_get(pkt))
        return state, pkt

    class Pipeline(jpipe.Pipeline):
        def __init__(self, *a, est_cfg=None, **k):
            super().__init__(*a, est_cfg=dataclasses.replace(
                est_cfg, fused=False), **k)

    with pytest.MonkeyPatch.context() as mp, jax_marginalization_f64():
        mp.setattr(jpipe, "Pipeline", Pipeline)
        mp.setattr(jpipe.trk, "track_event_stereo", recording)
        mp.setattr(synth, "planar_vio_sequence_rot", np_render_for_jax)
        jres, _, _ = run_golden_pipeline("esio")
    return jres, packets


@pytest.fixture(scope="module")
def port_on_jax_packets(jax_golden):
    """The port's pipeline over the golden run with its tracker's packets
    replaced by the JAX tracker's, on its general path as the JAX run:
    (result, gt_t, gt_P)."""
    import esvio_tpu_torch.apps.pipeline as tpipe
    from esvio_tpu_torch.frontend import tracker as ttrk
    packets = iter([to_torch(p, ttrk.FeaturePacket) for p in jax_golden[1]])
    make_pipeline, seq, gt_t, gt_P = vio_pipeline("cpu", fused=False, **GOLDEN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe.trk, "track_event_stereo",
                   lambda cfg, cam_l, cam_r, state, ch_l, ch_r, t:
                   (state, next(packets)))
        res = make_pipeline().run(seq)
    return res, gt_t, gt_P


def test_port_backend_on_jax_packets_meets_golden_gates(port_on_jax_packets):
    res, gt_t, gt_P = port_on_jax_packets
    g = golden_gates(res, gt_t, gt_P, GOLDEN_NPZ)
    print("port back end on JAX packets vs golden:", g)
    assert g["stamps_ok"], g
    assert g["ate_ok"], g
    assert g["max_dev"] < MAX_DEV_M, g


def test_pipeline_tick_by_tick_against_jax(jax_golden, port_on_jax_packets):
    """Every tick of the golden run, the port's back end on the JAX
    tracker's packets against the JAX general path on the same packets;
    positions held through NON_LINEAR and STEADY_TICKS steady ticks."""
    jres = jax_golden[0]
    tres = port_on_jax_packets[0]
    assert jres.metrics["ticks"] == tres.metrics["ticks"] == 24
    assert len(jres.stamps) == len(tres.stamps) == 14
    np.testing.assert_allclose(tres.stamps, jres.stamps, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tres.stamps_hf, jres.stamps_hf, rtol=0,
                               atol=1e-9)
    dev = np.linalg.norm(np.asarray(tres.P) - np.asarray(jres.P), axis=1)
    print("per-tick |P_port - P_jax| (m):", np.array2string(dev, precision=6))
    assert dev[:1 + STEADY_TICKS].max() < BACKEND_TOL_M, dev
