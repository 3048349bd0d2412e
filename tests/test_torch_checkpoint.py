"""Checkpoint / resume of the port's estimator (esvio_tpu_torch.vio.checkpoint)
on tests/test_checkpoint.py's drive (synth_np.estimator_drive("checkpoint"):
22 frames, saved after 16), and its files across the two packages.

Tolerances: none — the continuation after a load, from the port's file
and from the JAX package's, is held to the straight run bit for bit, and
every state array that crosses a package boundary is held equal.
"""
import numpy as np
import pytest

import torch_parity  # noqa: F401 (its torch thread cap)
from synth_np import estimator_drive, feed_imu
from esvio_tpu_torch.vio import checkpoint as tckpt
from esvio_tpu_torch.vio import estimator as est_mod

SPLIT = 16


def _feed(est, traj, packets, frames):
    outs = []
    for f in frames:
        if f > 0:
            feed_imu(est, traj, f)
        outs.append(est.process_packets(traj["t"][f], packets[f]))
    return outs


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """(straight run's outputs, continuation's outputs, checkpoint path,
    drive): the drive straight through, and saved at SPLIT, loaded into a
    fresh estimator and continued."""
    traj, ex_p, ex_q, packets, kw = estimator_drive("checkpoint")
    cfg = est_mod.EstimatorConfig(**kw)
    n = len(packets)
    est_a = est_mod.Estimator(cfg, ex_p, ex_q, "cpu")
    outs_a = _feed(est_a, traj, packets, range(n))
    est_b = est_mod.Estimator(cfg, ex_p, ex_q, "cpu")
    _feed(est_b, traj, packets, range(SPLIT))
    path = str(tmp_path_factory.mktemp("ckpt") / "est.npz")
    tckpt.save_estimator(est_b, path)
    est_c = tckpt.load_estimator(est_mod.Estimator(cfg, ex_p, ex_q, "cpu"), path)
    outs_c = _feed(est_c, traj, packets, range(SPLIT, n))
    return outs_a, outs_c, path, (traj, ex_p, ex_q, packets, kw)


def test_resume_continues_bit_for_bit(drive):
    outs_a, outs_c, _, _ = drive
    assert outs_a[SPLIT - 1].solver_flag == "NON_LINEAR"
    assert outs_c[-1].solver_flag == "NON_LINEAR"
    for k, f in enumerate(range(SPLIT, len(outs_a))):
        for name in ("P", "Q", "V"):
            np.testing.assert_array_equal(getattr(outs_c[k], name),
                                          getattr(outs_a[f], name))
        assert outs_c[k].marg_flag == outs_a[f].marg_flag


def test_checkpoint_crosses_packages_both_ways(drive, tmp_path):
    """The port's file through the JAX load_estimator and save_estimator,
    then into a fresh port estimator: every state array of the file equal;
    the port-only state (its `torch.` keys, which the JAX package drops)
    back at a fresh estimator's values; and that estimator, continued over
    frames SPLIT.. as the straight run was, is the straight run bit for
    bit: the state the JAX file lacks (the last fetch, the IMU-rate state)
    is rebuilt by the first tick after the load."""
    from esvio_tpu.vio import checkpoint as jckpt
    from esvio_tpu.vio import estimator as jest_mod
    outs_a, _, path, (traj, ex_p, ex_q, packets, kw) = drive
    jest = jest_mod.Estimator(jest_mod.EstimatorConfig(**kw), ex_p, ex_q)
    jckpt.load_estimator(jest, path)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_estimator(jest, jpath)
    z_port = dict(np.load(path).items())
    z_jax = dict(np.load(jpath).items())
    shared = sorted(k for k in z_port if not k.startswith("torch."))
    assert sorted(z_jax) == shared
    for k in shared:
        assert z_jax[k].dtype == z_port[k].dtype, k
        np.testing.assert_array_equal(z_jax[k], z_port[k], err_msg=k)

    est = tckpt.load_estimator(
        est_mod.Estimator(est_mod.EstimatorConfig(**kw), ex_p, ex_q, "cpu"),
        jpath)
    back = str(tmp_path / "back.npz")
    tckpt.save_estimator(est, back)
    z_back = dict(np.load(back).items())
    for k in shared:
        np.testing.assert_array_equal(z_back[k], z_port[k], err_msg=k)
    assert est._prior_valid == bool(z_port["prior.valid"])
    assert est.solver_flag == "NON_LINEAR" and est.frame_count == 10
    assert est._post is None and est._latest is None and est.failures == 0

    outs = _feed(est, traj, packets, range(SPLIT, len(packets)))
    for k, f in enumerate(range(SPLIT, len(packets))):
        assert outs[k].solver_flag == "NON_LINEAR"
        for name in ("P", "Q", "V"):
            np.testing.assert_array_equal(getattr(outs[k], name),
                                          getattr(outs_a[f], name), err_msg=name)
        assert outs[k].marg_flag == outs_a[f].marg_flag
