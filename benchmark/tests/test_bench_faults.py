"""A whole run of the harness on the CPU at a small size (the `tiny.esio`
cell under tests/tiny: 160x120 ESIO), sound and with the timed path broken
underneath: `correct` has to come out false for each fault a cell of this
benchmark can have: the state left unchanged, half of each tick's features
left out (this system's half of the batch), an answer altered where it is
made.  (One chip: no exchange between chips to leave out.)"""
import dataclasses
import json

import pytest

import run
from conftest import TINY

ARGS = ["--workload", "tiny.esio", "--seed", "4294967311", "--seconds", "12",
        "--trace", "0"]
# the golden 160x120 geometry's tracker: fewer lanes for the CPU, and the
# 15 LK iterations it needs to initialize (the run CLI's 30 never do here)
TINY_TRACKER = dict(capacity=128, cand_capacity=512, lk_iters=15)


@pytest.fixture(autouse=True)
def tiny_tracker(monkeypatch):
    inner = run.build_pipeline

    def build(c, device, control=None):
        cfg, pipe = inner(c, device, control)
        pipe.tracker_cfg = dataclasses.replace(pipe.tracker_cfg, **TINY_TRACKER)
        pipe.img_tracker_cfg = dataclasses.replace(pipe.img_tracker_cfg,
                                                   **TINY_TRACKER)
        pipe._reset(new_sequence=False)
        return cfg, pipe

    monkeypatch.setattr(run, "build_pipeline", build)


def _result(capsys, control=None):
    assert run.main(ARGS, device="cpu", root=TINY, bench_dir=TINY,
                    control=control) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    r = _result(capsys)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"realtime_x", "tick_p95_ms", "setup_s"}


def test_state_left_unchanged_is_caught(capsys, monkeypatch):
    """The estimator's step returns the state it had: every pose after the
    first steady one stays where it was."""
    from esvio_tpu_torch.vio import estimator as est_mod
    inner = est_mod.Estimator.process_packets
    frozen = {}

    def stuck(self, t, pkt_evt, pkt_img=None):
        out = inner(self, t, pkt_evt, pkt_img)
        if out.solver_flag != "NON_LINEAR":
            return out
        keep = frozen.setdefault("out", out)
        return dataclasses.replace(out, P=keep.P, Q=keep.Q, V=keep.V)

    monkeypatch.setattr(est_mod.Estimator, "process_packets", stuck)
    r = _result(capsys)
    assert r["correct"] is False
    assert r["checks"]["ate_m"]["value"] > r["checks"]["ate_m"]["limit"]


def test_answer_altered_where_produced_is_caught(capsys, monkeypatch):
    """The event tracker's packets come out with every left feature 3 px to
    the right of where it tracked it."""
    from esvio_tpu_torch.apps import pipeline
    inner = pipeline.trk.track_event_stereo

    def shifted(cfg, cam_l, cam_r, state, ch_l, ch_r, t):
        state, pkt = inner(cfg, cam_l, cam_r, state, ch_l, ch_r, t)
        un = pkt.un.clone()
        un[:, 0] += 3.0 / float(cam_l.fx)
        return state, dataclasses.replace(pkt, un=un)

    monkeypatch.setattr(pipeline.trk, "track_event_stereo", shifted)
    r = _result(capsys)
    assert r["correct"] is False
    assert r["checks"]["evt_stereo_px"]["value"] > r["checks"]["evt_stereo_px"]["limit"]
    c = r["checks"]["evt_stereo_over1px"]
    assert c["value"] > c["limit"]


def test_half_the_features_left_out_is_caught(capsys):
    """The front end keeps half of the configuration's max_cnt features a
    tick (benchmark/control.py half)."""
    r = _result(capsys, control="half")
    assert r["correct"] is False
    c = r["checks"]["evt_features_short"]
    assert c["value"] >= 0.5 > c["limit"]
