"""Parity: the port's Metrics (JSON-lines sink), trace and device_profile
(esvio_tpu_torch.utils.metrics) and the visualization dumps
(esvio_tpu_torch.utils.viz, Pipeline(dump_viz_dir=...)) against
esvio_tpu.utils.

Tolerances: none — summaries, emitted records (their wall-clock `ts`
aside), overlays and written images equal.
"""
import json
import os

import numpy as np
import torch

import torch_parity  # noqa: F401 (its torch thread cap)
from esvio_tpu.utils import metrics as jmet
from esvio_tpu.utils import viz as jviz
from esvio_tpu_torch.utils import metrics as tmet
from esvio_tpu_torch.utils import viz as tviz


def _drive(m):
    lines = []
    for k in range(7):
        m.count("ticks")
        m.count("events", 100.0 * k)
        m.gauge("solver_flag_nonlinear", float(k > 3))
        m.observe("tracked_features", float((k * 37) % 11))
        lines.append(m.emit(tick=k))
    return lines


def test_metrics_summary_and_emitted_lines_match(tmp_path):
    jm = jmet.Metrics(sink=str(tmp_path / "jax.jsonl"))
    tm = tmet.Metrics(sink=str(tmp_path / "torch.jsonl"))
    jl, tl = _drive(jm), _drive(tm)
    jm.close()
    tm.close()
    assert tm.summary() == jm.summary()
    strip = lambda line: {k: v for k, v in json.loads(line).items() if k != "ts"}
    assert [strip(x) for x in tl] == [strip(x) for x in jl]
    with open(tmp_path / "torch.jsonl") as f:
        written = f.read().splitlines()
    assert written == tl                      # one line per emit, as returned


def test_tracking_overlay_and_dump_tick_match(rng, tmp_path):
    H, W, F = 40, 60, 32
    img = np.float32(rng.uniform(-20, 300, (H, W)))
    pts = np.float32(rng.uniform(-3, W + 3, (F, 2)))
    pts[:, 1] = rng.uniform(-3, H + 3, F)
    valid = rng.random(F) < 0.7
    cnt = rng.integers(0, 30, F).astype(np.int32)
    a = jviz.tracking_overlay(img, pts, valid, cnt)
    b = tviz.tracking_overlay(torch.tensor(img), torch.tensor(pts),
                              torch.tensor(valid), torch.tensor(cnt))
    assert b.dtype == np.uint8 and b.shape == (H, W, 3)
    np.testing.assert_array_equal(a, b)

    class Packet:
        def __init__(self, conv):
            self.uv, self.valid, self.track_cnt = conv(pts), conv(valid), conv(cnt)
    jviz.dump_tick(str(tmp_path / "jax"), 20, img, Packet(np.asarray))
    tviz.dump_tick(str(tmp_path / "torch"), 20, torch.tensor(img),
                   Packet(torch.tensor))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["track_000020.png", "ts_000020.png"]
    assert sorted(os.listdir(tmp_path / "torch")) == names
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "torch" / n).read_bytes()


def test_trace_and_device_profile_write_a_trace(tmp_path):
    x = torch.arange(1000.0)
    with tmet.device_profile(str(tmp_path)) as prof:
        with tmet.trace("esvio_test_span"):
            y = (x * 2).sum()
    assert float(y) == 999000.0 and prof is not None
    (trace_file,) = os.listdir(tmp_path)
    with open(tmp_path / trace_file) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "esvio_test_span" in names


def test_pipeline_dumps_viz_every_nth_tick(tmp_path):
    """Pipeline(dump_viz_dir=..., dump_viz_every=2) over 4 ticks of the
    golden sequence writes the time surface and the overlay of ticks 2
    and 4."""
    from synth_np import vio_pipeline
    from esvio_tpu_torch.apps.pipeline import Pipeline
    make, seq, _, _ = vio_pipeline("cpu", H=120, W=160, focal=200.0,
                                   duration=0.35)
    ref = make()
    pipe = Pipeline(ref.sys_cfg, ref.cams, "cpu", tracker_cfg=ref.tracker_cfg,
                    est_cfg=ref.est_cfg, event_capacity=1 << 15,
                    dump_viz_dir=str(tmp_path), dump_viz_every=2)
    res = pipe.run(seq, max_frames=4)
    assert res.metrics["ticks"] == 4
    assert sorted(os.listdir(tmp_path)) == [
        "track_000002.png", "track_000004.png", "ts_000002.png",
        "ts_000004.png"]
