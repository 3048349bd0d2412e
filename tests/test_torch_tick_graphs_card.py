"""The estimator's tick graphs on the card against its eager fused tick, over
steady ticks whose longest IMU interval needs 3 and then 4 preintegration
chunks (frames dropped lengthen it): one capture serves every tick, the
graph replays give the eager tick's flags and poses, and both launch kernel
K4 once per assembly of the LM solve (1 + iters) and once more on a
MARGIN_OLD tick (marginalize_old); no steady tick takes a forward-mode
Jacobian of a CUDA tensor, in the capture or eagerly.  Skips without a
card.  It imports no JAX; on the card run it without the suite's
conftest.py, which does:

    python -m pytest --noconftest tests/test_torch_tick_graphs_card.py

Tolerance: P, Q and V within 1e-5 (chip_smoke's graph-against-eager gate
is 1e-6 over three ticks; these are nine, and both sides run the same
kernels in the same order, so any larger gap is a fault of the replay).
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the suite's torch thread cap)
import synth_np

DROPPED = (14, 15, 17)      # frames whose packets never come


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tick graphs are CUDA graphs")
    import esvio_tpu_torch
    esvio_tpu_torch.disable_tf32()
    return torch.device("cuda")


def _drive(card, on_steady):
    """The synthetic drive through an estimator with tick graphs and an
    eager one, packet for packet; on_steady(graphs, run) on every steady
    tick, where run() processes the tick on both and returns the graph
    side's output and the K4 launches of each side.  Returns (graphs,
    steady ticks, chunk counts seen)."""
    from esvio_tpu_torch import _kernels
    from esvio_tpu_torch.solver import window as win
    from esvio_tpu_torch.vio import estimator as em
    rng = np.random.default_rng(0)
    traj = synth_np.simulate_trajectory(rng, n_frames=24, imu_per_frame=20,
                                        frame_dt=0.05)
    lms = synth_np.make_world(rng, traj)
    B = synth_np.EST_BASELINE
    ex_p = np.array([[0, 0, 0], [0, 0, 0], [B, 0, 0], [B, 0, 0]], float)
    ex_q = np.tile(np.array([1.0, 0, 0, 0]), (4, 1))
    cfg = em.EstimatorConfig(mode="esio", evt_capacity=128, img_capacity=8,
                             min_track_for_kf=15)
    graphs = em.Estimator(cfg, ex_p, ex_q, card)
    eager = em.Estimator(cfg, ex_p, ex_q, card)
    eager._graphs = None
    k4 = _kernels.NORMAL_ASSEMBLY
    seen, chunks, steady = set(), set(), 0
    for f in range(len(traj["t"])):
        pkt, seen = synth_np.packet_for_frame(traj, f, lms, seen, 0.3 / 460.0,
                                              rng)
        if f > 0:
            synth_np.feed_imu(graphs, traj, f)
            synth_np.feed_imu(eager, traj, f)
        if f in DROPPED:
            continue

        def run():
            k0 = k4.launches
            a = graphs.process_packets(traj["t"][f], pkt)
            k1 = k4.launches
            b = eager.process_packets(traj["t"][f], pkt)
            assert (a.solver_flag, a.marg_flag) == (b.solver_flag, b.marg_flag), f
            for name in ("P", "Q", "V"):
                np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                           atol=1e-5, err_msg=f"{name} frame {f}")
            return a, (k1 - k0, k4.launches - k1)
        if graphs.solver_flag == "NON_LINEAR" \
                and graphs.frame_count == win.WINDOW:
            steady += 1
            chunks.add(em._preint_chunks(int(graphs.imu_n[1:].max())))
            on_steady(graphs, run)
        else:
            run()
    return graphs, steady, chunks


@pytest.mark.card
def test_one_capture_serves_every_step_count(card):
    from esvio_tpu_torch.vio import estimator as em

    def on_steady(graphs, run):
        captures = graphs._graphs.n_captures
        a, launches = run()
        want = graphs.cfg.solver_iters + 1 + (a.marg_flag == em.MARGIN_OLD)
        # a capture runs segment A once eagerly before it (lazy set-up)
        warm = (graphs._graphs.n_captures - captures) * (graphs.cfg.solver_iters + 1)
        assert launches == (want + warm, want)

    graphs, steady, chunks = _drive(card, on_steady)
    assert steady >= 8 and chunks == {3, 4}
    assert graphs._graphs.n_captures == 1
    assert graphs._graphs.n_replays == steady


@pytest.mark.card
def test_steady_ticks_take_no_forward_mode_jacobian(card, monkeypatch):
    """No forward-mode Jacobian runs on a CUDA tensor in a steady tick, in
    the graph's capture or in the eager tick: K4 takes every factor's
    Jacobian in closed form."""
    from esvio_tpu_torch.solver import factors
    devices = []
    fwd = factors.jacobian_fwd

    def spy(f, consts, lead, n, dtype, device):
        devices.append(torch.device(device).type)
        return fwd(f, consts, lead, n, dtype, device)
    monkeypatch.setattr(factors, "jacobian_fwd", spy)

    def on_steady(graphs, run):
        before = len(devices)
        run()
        assert "cuda" not in devices[before:]

    _, steady, _ = _drive(card, on_steady)
    assert steady >= 8
