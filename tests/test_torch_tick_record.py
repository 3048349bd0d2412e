"""The pipeline's per-tick record (utils/metrics.py, Pipeline(trace=True))
on a tiny ESVIO sequence with loop closure on the CPU: the same run with
the record off and on, the on run under torch.profiler for a few ticks.

  * the record changes nothing: trajectory, IMU-rate poses, loop-corrected
    path, `res.metrics` and the stage counts are equal bit for bit;
  * off, nothing of it runs: no sub-span range is entered and `span` hands
    out the shared null context;
  * on, one line per tick, every span inside its parent and its tick, the
    hand-over before every stage and the pose after the estimator stage's
    start, the counts consistent with the run;
  * the frame hand-over is its own span, `frontend_image.upload`, with
    the frames offered and taken and their bytes;
  * the stage spans bracket the profiler's ranges of the same name within
    1 ms on the profiler's clock;
  * the run CLI's --trace-out writes one JSON line per tick;
  * a count read from the device (count_later) waits for its stage to close.

Tolerances: none but the 1 ms of the clocks' agreement.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its torch thread cap)
from synth_np import loop_pipeline, vio_pipeline
from esvio_tpu_torch.utils import metrics as tmet
from esvio_tpu_torch.vio import estimator as est_mod

STAGES = ("frontend_event", "frontend_image", "estimator", "loop_closure")
DURATION = 0.8            # 12 ticks at 15 Hz: NON_LINEAR from tick 11
PROFILED = range(8, 11)   # ticks run under torch.profiler
LK_ITERS = 15             # the sequence's tracker (synth_np.loop_pipeline)


def _profiled(pairs, box):
    """The chunk pairs, with torch.profiler on while ticks PROFILED run."""
    for k, pair in enumerate(pairs):
        if k == PROFILED.start:
            box["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            box["prof"].start()
        elif k == PROFILED.stop:
            box["prof"].stop()
        yield pair


def _outputs(pipe):
    """The estimator's Output of each tick, recorded as the pipeline takes
    them."""
    outs = []
    inner = pipe.estimator.process_packets

    def process_packets(*a, **k):
        outs.append(inner(*a, **k))
        return outs[-1]
    pipe.estimator.process_packets = process_packets
    return outs


@pytest.fixture(scope="module")
def runs():
    import esvio_tpu_torch.apps.pipeline as tpipe
    from esvio_tpu_torch.io import datasets as tds
    make, seq, _, _ = loop_pipeline("cpu", duration=DURATION, mode="esvio")
    pairs = lambda: tpipe._sync_pairs(
        tds.iterate_chunks_fast(seq.events_left, 15, 1 << 15, "cpu"),
        tds.iterate_chunks_fast(seq.events_right, 15, 1 << 15, "cpu"), 0.5 / 15)

    # off, with every record_function range entered counted by name
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    off_pipe = make()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", counting)
        null_span = tmet.span("frontend_event.sae")
        off = off_pipe.run(seq, chunk_pairs=pairs())

    on_pipe = make()
    on_pipe.trace = True
    outs = _outputs(on_pipe)
    box = {}
    on = on_pipe.run(seq, chunk_pairs=_profiled(pairs(), box))
    return dict(off=off, on=on, entered=entered, null_span=null_span,
                outs=outs, prof=box["prof"], seq=seq)


def test_record_leaves_the_run_unchanged(runs):
    off, on = runs["off"], runs["on"]
    assert on.stamps == off.stamps and len(on.stamps) >= 2
    for name in ("P", "Q", "V", "P_loop", "Q_loop", "P_hf", "Q_hf", "V_hf"):
        a, b = getattr(off, name), getattr(on, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert len(a) == len(b) and all(
                np.array_equal(x, y) for x, y in zip(a, b)), name
    assert on.metrics == off.metrics
    assert {k: v["n"] for k, v in on.stage_times.items()} == \
        {k: v["n"] for k, v in off.stage_times.items()}
    assert on.n_loops == off.n_loops and on.n_restarts == off.n_restarts


def test_record_off_enters_no_range_of_its_own(runs):
    assert runs["off"].ticks is None
    assert runs["null_span"] is tmet._NULL and tmet._active is None
    assert runs["entered"] and set(runs["entered"]) <= set(STAGES)


def test_one_line_per_tick_and_every_span_nests(runs):
    on = runs["on"]
    lines = on.ticks
    assert len(lines) == on.metrics["ticks"] == len(runs["outs"])
    for line in lines:
        spans = line["spans"]
        (tick,) = [s for s in spans if s[0] == "tick"]
        assert tick[2] == line["handover_ns"] and tick[3] == line["end_ns"]
        (ingest,) = [s for s in spans if s[0] == "ingest"]
        assert ingest[1] is None and ingest[3] <= line["handover_ns"]
        inner = [s for s in spans if s[0] not in ("tick", "ingest")]
        names = {s[0] for s in inner}
        assert {"frontend_event", "estimator", "frontend_event.sae",
                "frontend_event.temporal", "frontend_event.corners",
                "frontend_event.refill_stereo"} <= names
        assert names & {"estimator.general", "estimator.segment_a"}
        for name, parent, s, e in inner:
            assert tick[2] <= s <= e <= tick[3], name
            if parent == "tick":
                assert name in STAGES
            else:
                assert name.startswith(parent + ".")
                assert any(p[0] == parent and p[2] <= s and e <= p[3]
                           for p in inner), name
        est = [s for s in inner if s[0] == "estimator"]
        assert len(est) == 1
        # hand-over ≤ every stage's start; the pose after the estimator's
        # start and before the tick's end
        assert all(line["handover_ns"] <= s[2] for s in inner)
        assert est[0][2] <= line["pose_ns"] <= line["end_ns"]
        assert line["pose_latency_ns"] == line["pose_ns"] - line["handover_ns"]
    # ticks close in order; the fused path's parts once NON_LINEAR
    assert [l["tick"] for l in lines] == sorted(l["tick"] for l in lines)
    fused = [l for l in lines if any(s[0] == "estimator.segment_a"
                                     for s in l["spans"])]
    assert fused and all(
        {"estimator.fetch", "estimator.segment_b"} <= {s[0] for s in l["spans"]}
        for l in fused)


def test_counts_agree_with_the_run(runs):
    on, lines, outs = runs["on"], runs["on"].ticks, runs["outs"]
    total = lambda line, name: sum(line["counts"].get(name, {}).values())
    for line, out in zip(lines, outs):
        assert line["tick"] == out.t and line["solver_flag"] == out.solver_flag
        # the keyframe lines are the MARGIN_OLD ticks
        assert line["keyframe"] == (out.marg_flag == est_mod.MARGIN_OLD)
        assert line["marg"] in ("MARGIN_OLD", "MARGIN_SECOND_NEW")
        assert line["tracked"] == out.n_tracked
        kept, offered = line["events_kept"], line["events_offered"]
        assert len(kept) == len(offered) == 2
        assert all(0 < k <= o for k, o in zip(kept, offered))
        lk = line["counts"]["lk_iters"]
        calls = line["counts"]["lk_calls"]
        assert "frontend_event" in calls
        assert set(calls) <= {"frontend_event", "frontend_image"}
        for fe, n in calls.items():
            assert lk.get(fe, 0) <= LK_ITERS * n
        # every LK iteration and every spacing sweep but the first made a
        # convergence check, one host fetch each
        fetches = line["counts"]["host_fetches"]
        for fe in calls:
            assert fetches[fe] >= lk.get(fe, 0) + \
                line["counts"]["spacing_sweeps"][fe] - 1
    assert sum(sum(l["events_kept"]) for l in lines) == on.metrics["events"]
    assert sum(total(l, "loops_closed") for l in lines) == on.n_loops
    assert sum(total(l, "lk_iters") for l in lines) >= \
        sum(total(l, "lk_calls") for l in lines)
    assert any(l["keyframe"] for l in lines)
    # the fused tick: its one fetch of post
    for l in lines:
        if any(s[0] == "estimator.fetch" for s in l["spans"]):
            assert l["counts"]["host_fetches"]["estimator"] >= 1


def test_stage_spans_bracket_the_profiler_ranges(runs):
    prof, lines = runs["prof"], runs["on"].ticks
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in STAGES or e.name().startswith("frontend_event.")]
    stage_ranges = [r for r in ranges if r[0] in STAGES]
    assert {r[0] for r in stage_ranges} >= {"frontend_event", "estimator"}
    assert {r[0] for r in ranges} >= {"frontend_event.temporal",
                                      "frontend_event.refill_stereo"}
    spans = [s for l in lines for s in l["spans"] if s[0] in STAGES]
    ms = 1_000_000
    for name, start, end in stage_ranges:
        s = min((s for s in spans if s[0] == name),
                key=lambda s: abs(s[2] - start))
        assert abs(s[2] - start) < ms and abs(s[3] - end) < ms, \
            (name, s[2] - start, s[3] - end)


def test_frame_upload_is_its_own_span(runs):
    """The pipeline's frame hand-over is the span `frontend_image.upload`
    inside `frontend_image`, before and apart from the tracker's
    `frontend_image.prep`, and a profiler range; a tick that takes a frame
    counts the two frames' bytes in its image stage."""
    lines, seq = runs["on"].ticks, runs["seq"]
    nbytes = seq.images_left[1][0].nbytes + seq.images_right[1][0].nbytes
    assert any(l["frames_taken"] for l in lines)
    for line in lines:
        spans = {s[0]: s for s in line["spans"]}
        assert line["frames_taken"] in (0, 1)
        assert line["frames_offered"] >= line["frames_taken"]
        if not line["frames_taken"]:
            assert "frontend_image" not in spans
            continue
        stage, up, prep = (spans[n] for n in (
            "frontend_image", "frontend_image.upload", "frontend_image.prep"))
        assert up[1] == "frontend_image"
        assert stage[2] <= up[2] <= up[3] <= prep[2] <= prep[3] <= stage[3]
        assert line["counts"]["frame_bytes"]["frontend_image"] == nbytes
    names = {e.name() for e in runs["prof"].profiler.kineto_results.events()}
    assert "frontend_image.upload" in names


def test_count_later_reads_when_the_stage_closes():
    """A count that lives on the device (K3's iterations) is read only when
    its stage, the outermost open span, has closed, and lands in that
    stage; with no record active nothing is kept or read."""
    reads = []

    def read(n):
        reads.append(n)
        return n
    tmet.count_later("lk_iters", lambda: read(5))     # no record: dropped
    met = tmet.Metrics(record=True)
    with met.recording():
        key = met.begin_tick(1.0)
        with met.span("frontend_event", key):
            with tmet.span("frontend_event.temporal"):
                tmet.count_later("lk_iters", lambda: read(7))
            assert reads == []                        # stage still open
            tmet.count_later("lk_iters", lambda: read(3))
        assert reads == [7, 3]
        tmet.count_later("lk_iters", lambda: read(2))  # outside every span
        met.end_tick(key)
    assert reads == [7, 3, 2]
    assert met.ticks[0]["counts"]["lk_iters"] == {"frontend_event": 10,
                                                  "pipeline": 2}


def test_run_cli_trace_out_writes_one_line_per_tick(tmp_path):
    from esvio_tpu_torch.apps import run as trun
    from esvio_tpu_torch.io import datasets as tds
    _, seq, _, _ = vio_pipeline("cpu", H=120, W=160, focal=200.0, duration=0.3,
                                config_dir=str(tmp_path))
    npz = str(tmp_path / "seq.npz")
    tds.save_npz(seq, npz)
    path = tmp_path / "ticks.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = trun.main(["--config", str(tmp_path / "esvio.yaml"), "--seq", npz,
                        "--out", str(tmp_path / "out"), "--max-frames", "3",
                        "--event-capacity", str(1 << 15), "--device", "cpu",
                        "--trace-out", str(path)])
    assert rc == 0
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 3
    for line in lines:
        assert {s[0] for s in line["spans"]} >= {"tick", "ingest",
                                                 "frontend_event", "estimator"}
        assert line["counts"]["lk_calls"]["frontend_event"] > 0
        assert sum(line["events_kept"]) > 0
