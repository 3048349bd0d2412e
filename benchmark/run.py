"""The benchmark of esvio_tpu_torch: one cell, one run, one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's deployment as the run CLI does (the YAML through
`io/config.load_config`, then `apps/pipeline.Pipeline(cfg, cfg.cameras,
"cuda", event_capacity=...)`), renders one period of the cell's sensor
streams on the card from the seed, and drives `Pipeline.run` over the
period-shifted stream, chunked by the port's `io/datasets.iterate_chunks_fast`.
Warm-up runs until the estimator is NON_LINEAR with its tick graphs captured
(and, with loop closure, until loops can close); then the window opens and
runs for `--seconds`.  The loop is closed: the next tick is handed over when
the pipeline asks for it, as when a recording is replayed.

End-to-end metrics (`--trace 0`): realtime_x (sensor seconds over wall
seconds of the window), tick_p95_ms (over every window tick), setup_s.
Per-layer metrics (`--trace 1`): the readers in metrics/, over a
torch.profiler slice of a few window ticks.  After the window the plain
reference (harness/reference.py) judges the window's packets, trajectory
and loop-corrected path; the numbers compared and their limits are the last
lines on standard error and the last key of the result line.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # load from one process with few threads: the host libraries' thread
    # pools (set before numpy and torch are imported) keep one thread each
    for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_v] = "1"

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(1, os.path.dirname(_HERE))

from harness import cell as cell_mod  # noqa: E402
from harness import nojax, reference, roofline, scene, stream  # noqa: E402
from harness import trace as trace_mod  # noqa: E402

# the traced run profiles window ticks TRACE_FIRST_TICK onwards, TRACE_TICKS
# of them: steady ticks, few enough that the trace is read in seconds
TRACE_FIRST_TICK = 2
TRACE_TICKS = 4


def percentile(values, q):
    """The q-th percentile of all values, linearly interpolated between
    the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Recorder:
    """Keeps the packets the estimator takes (references only: the
    tracker makes new tensors every tick)."""

    def __init__(self, est):
        self.calls = []
        inner = est.process_packets

        def process_packets(t, pkt_evt, pkt_img=None):
            self.calls.append((t, pkt_evt, pkt_img))
            return inner(t, pkt_evt, pkt_img)

        est.process_packets = process_packets

    def packets(self, t_from, which):
        out = []
        for t, pe, pi in self.calls:
            pk = pe if which == "evt" else pi
            if t < t_from - 1e-9 or pk is None:
                continue
            out.append(dict(
                t=float(pk.t), ids=pk.ids.cpu().numpy(),
                valid=pk.valid.cpu().numpy(), un=pk.un.double().cpu().numpy(),
                right_valid=pk.right_valid.cpu().numpy(),
                un_right=pk.un_right.double().cpu().numpy()))
        return out


def warm_test(pipe, warm_cfg, on_cuda, ticks_per_period):
    """The warm-up test: NON_LINEAR for `nonlinear_ticks` ticks, no new
    tick graph for `quiet_ticks` (on the card), with loop closure a loop
    closed and solved with more keyframes in the database than it skips as
    recent, and with `align_to_period` the next tick a period's first."""
    st = dict(nl=0, caps=-1, quiet=0, n=0)

    def warm():
        est = pipe.estimator
        lc = pipe.loop_closer
        st["n"] += 1
        caps = est._graphs.n_captures if est._graphs is not None else 0
        st["quiet"] = st["quiet"] + 1 if caps == st["caps"] else 0
        st["caps"] = caps
        st["nl"] = st["nl"] + 1 if est.solver_flag == "NON_LINEAR" else 0
        if st["n"] % 25 == 0:
            log(f"warm-up tick {st['n']}: {est.solver_flag} for {st['nl']} "
                f"ticks, {caps} graphs captured, none new for {st['quiet']}, "
                f"keyframes {lc.db.count if lc is not None else 0}, 4-DoF "
                f"solves {lc.n_optimize if lc is not None else 0}")
        if st["nl"] < warm_cfg["nonlinear_ticks"]:
            return False
        if on_cuda and (caps == 0 or st["quiet"] < warm_cfg["quiet_ticks"]):
            return False
        # a window that opens at a period's first tick starts at the same
        # point of the circuit in every run
        if warm_cfg.get("align_to_period") and (st["n"] - 1) % ticks_per_period:
            return False
        # with loop closure: loops can close (more keyframes than the
        # database skips as recent) and one has closed and been solved, so
        # that no path of the loop closer runs for the first time in the
        # window
        return lc is None or (lc.db.count > lc.cfg.skip_recent
                              and lc.n_optimize >= 1)

    return warm


def build_pipeline(c, device, control=None):
    """The cell's Pipeline as the run CLI builds it from the YAML.  With
    control "focal2" the cameras' focal lengths are taken 2 % long (the
    correctness control: it breaks the calibration the deployment states);
    with "half" the front ends keep half of `max_cnt` and `max_cnt_img`
    (the fault: half of each tick's features left out)."""
    import dataclasses
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.io.config import load_config
    cfg = load_config(c.yaml_path)
    if control == "focal2":
        cfg.cameras = {k: dataclasses.replace(v, fx=v.fx * 1.02, fy=v.fy * 1.02)
                       for k, v in cfg.cameras.items()}
    if control == "half":
        cfg.max_cnt //= 2
        cfg.max_cnt_img //= 2
    pipe = Pipeline(cfg, cfg.cameras, device,
                    event_capacity=int(c.deployment["event_capacity"]))
    return cfg, pipe


def judge(limits, values):
    """{name: (value, limit)} of the numbers compared, and whether all hold."""
    checks = {k: (values.get(k, math.inf), float(v)) for k, v in limits.items()}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return checks, ok


def main(argv=None, device=None, control=None, root=None, bench_dir=None,
         window_ticks=None):
    """One run; returns the exit code.  device (tests only): run there
    without looking for a card.  control: a correctness control or fault
    (benchmark/control.py).  root / bench_dir: where BENCHMARK.json and the
    cell's files are.  window_ticks (readings only): the window also closes
    after that many ticks."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch
    c = cell_mod.load(a.workload, root or cell_mod.ROOT,
                      bench_dir or cell_mod.BENCH_DIR)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
            log(f"needs {c.chips} CUDA device(s): cuda available "
                f"{torch.cuda.is_available()}, count "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda"
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    # on the card the host runs one Python loop that launches work: one
    # thread; on the CPU (the tests' tiny cell) the pipeline's math is the
    # host's, with up to four
    torch.set_num_threads(1 if on_cuda else min(4, torch.get_num_threads()))

    # ---- set-up: streams, pipeline, warm-up ---------------------------
    t = time.perf_counter()
    sc = dict(c.scene)
    period = scene.render_period(sc, c.traffic, a.seed, dev)
    if on_cuda:
        torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    log(f"render: one period of {period.period_s:g} s, events per camera "
        f"{period.n_events}, {len(period.frame_t)} frames per camera, "
        f"{render_s:.3f} s")
    if on_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cfg, pipe = build_pipeline(c, dev, control)
    if control == "tf32":
        # the control: float32 products in TF32, the precision below the
        # full float32 the pipeline states (esvio_tpu_torch.disable_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    rec = Recorder(pipe.estimator)
    ps = stream.PeriodicStream(period, cfg.freq, c.deployment["event_capacity"],
                               dev)
    log(f"pipeline: built in {time.perf_counter() - t:.3f} s, "
        f"{ps.ticks_per_period} ticks per period")
    import numpy as np
    cap = c.deployment["event_capacity"]
    for k, ev in enumerate(period.events):
        per_tick = np.histogram(ev[0], bins=ps.ticks_per_period,
                                range=(0.0, period.period_s))[0]
        log(f"events camera {k}: per tick min {per_tick.min()} median "
            f"{int(np.median(per_tick))} max {per_tick.max()}, ticks at the "
            f"capacity {np.mean(per_tick >= cap):.3f}")

    warm_cfg = c.traffic["warmup"]
    prof_box = {}

    def on_tick(i):
        if not a.trace:
            return
        if i == TRACE_FIRST_TICK:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
            prof_box["prof"] = profile(activities=acts)
            prof_box["prof"].start()
            prof_box["t0"] = time.perf_counter()
            prof_box["i0"] = i
        elif i == TRACE_FIRST_TICK + TRACE_TICKS and "prof" in prof_box \
                and "t1" not in prof_box:
            if on_cuda:
                torch.cuda.synchronize()
            prof_box["t1"] = time.perf_counter()
            prof_box["prof"].stop()
            prof_box["i1"] = i

    win = stream.Window(ps.pairs(), a.seconds,
                        warm_test(pipe, warm_cfg, on_cuda, ps.ticks_per_period),
                        warm_cfg["max_ticks"], on_tick, max_ticks=window_ticks)
    res = pipe.run(ps.seq, chunk_pairs=win)
    if "prof" in prof_box and "t1" not in prof_box:
        prof_box["t1"] = time.perf_counter()
        prof_box["prof"].stop()
        prof_box["i1"] = len(win.handover)
    setup_s = win.opened - _T0
    ticks = win.tick_seconds()
    window_s = win.closed - win.opened
    mem_peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0

    # ---- after the window: no JAX, then the reference -----------------
    bad = nojax.forbidden_loaded(list(sys.modules))
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    t_from = win.first_stamp
    stamps = [s for s in res.stamps if s >= t_from - 1e-9]
    k0 = len(res.stamps) - len(stamps)
    evt = rec.packets(t_from, "evt")
    img = rec.packets(t_from, "img") if cfg.system_mode == 1 else None
    P = res.P[k0:]
    P_loop = res.P_loop[k0:] if (cfg.loop_closure and res.P_loop) else None
    lc = pipe.loop_closer
    n_loops, n_kf = res.n_loops, (lc.db.count if lc is not None else 0)
    del pipe, rec
    t = time.perf_counter()
    truth = reference.Truth(c.traffic, period.tau)
    pub = c.deployment["published"]
    values, counts = reference.readings(truth, sc, evt, img, stamps, P, P_loop,
                                        pub["max_cnt"], pub.get("max_cnt_img"))
    log(f"reference: {time.perf_counter() - t:.3f} s, counts {counts}")
    checks, ok = judge(c.limits["limits"], values)
    checks["restarts"] = (float(res.n_restarts), 0.0)
    ok = ok and res.n_restarts == 0
    attempted = len(ticks)
    failed = max(attempted - len(stamps), 0)

    # ---- metrics --------------------------------------------------------
    freq = float(cfg.freq)
    log(f"window: {attempted} ticks in {window_s:.3f} s, warm-up "
        f"{win.warm_ticks} ticks, restarts {res.n_restarts}, loops closed "
        f"{n_loops}, keyframes {n_kf}, memory peak {mem_peak} bytes")
    out = {"correct": bool(ok), "attempted": attempted, "failed": failed}
    dev_out = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
               "count": c.chips, "memory_peak_bytes": int(mem_peak)}
    if not a.trace:
        out["metrics"] = {
            "realtime_x": {"value": attempted / freq / window_s, "unit": "x"},
            "tick_p95_ms": {"value": percentile(ticks, 95) * 1e3, "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        log(f"tick_p95_ms over {len(ticks)} ticks; tick median "
            f"{percentile(ticks, 50) * 1e3:.3f} ms")
    else:
        t = time.perf_counter()
        dev_iv, host_ev = trace_mod.collect(prof_box["prof"])
        pk = roofline.peaks(kind) if on_cuda else None
        sl_obj = trace_mod.Slice(
            dict(width=cfg.event_width, height=cfg.event_height),
            prof_box["i1"] - prof_box["i0"], prof_box["t1"] - prof_box["t0"],
            dev_iv, host_ev, win.ingest_s, pk)
        metrics = {}
        for m in c.per_layer:
            v = cell_mod.reader(m["name"]).read(sl_obj)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        dev_out["busy_s"] = sl_obj.busy_s()
        dev_out["window_s"] = sl_obj.window_s
        out["breakdown"] = {"device_ops": sl_obj.device_ops(),
                            "idle_gaps": sl_obj.idle_gaps()}
        log(f"trace: {sl_obj.ticks} ticks, {len(dev_iv)} device and "
            f"{len(host_ev)} host events, read in {time.perf_counter() - t:.3f} s")
    out["device"] = dev_out
    log("readings: " + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
    # a reading with nothing to judge is infinite: null in the JSON line
    out["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v:.6g} limit {lim:.6g} "
            f"{'ok' if math.isfinite(v) and v <= lim else 'FAIL'}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
