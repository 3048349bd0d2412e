"""Per-dataset run CLI — the script/run.sh + roslaunch analog (port of
esvio_tpu/apps/run.py).

    python -m esvio_tpu_torch.apps.run --config <esvio.yaml> --seq <sequence> \
        [--gt gt.txt|.npz] [--out outdir] [--max-frames N] [--freq HZ] \
        [--device cuda|cpu] [--trace-out ticks.jsonl]

`--config` reads the reference's YAML configs unchanged (io/config.py);
`--seq` accepts:
  * packed .npz (io/datasets.load_npz — output of the converters below)
  * MVSEC .hdf5 (+ `--gt *_gt.hdf5`)
  * a rosbag (.bag), converted in-process with the reference topic names
  * a DSEC directory holding left/events.h5 + right/events.h5

The pipeline runs on `--device` (default: the card; without one that
raises).  Outputs the reference trajectory files (esvio_result_no_loop.csv,
esvio_result_loop.txt — visualization.cpp:185-200, pose_graph.cpp:635-652)
plus a one-line JSON summary with ATE when ground truth is available.
`--trace-out` turns on the pipeline's per-tick record and writes its lines
(one JSON line per tick: spans on the Unix ns clock, host fetches, LK
iterations, events offered and kept, keyframes, loops) when the run ends.

Convert-only mode (events_repacking_helper analog):
    python -m esvio_tpu_torch.apps.run --convert seq.bag --config c.yaml --out d.npz
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from esvio_tpu_torch.io import datasets as ds


def load_sequence(path, cfg, gt_path=None):
    if os.path.isdir(path):
        seq = ds.load_dsec_h5(os.path.join(path, "left", "events.h5"),
                              os.path.join(path, "right", "events.h5"))
    elif path.endswith(".npz"):
        seq = ds.load_npz(path)
    elif path.endswith((".h5", ".hdf5")):
        seq = ds.load_mvsec_h5(
            path, gt_path if gt_path and gt_path.endswith((".h5", ".hdf5"))
            else None)
    elif path.endswith(".bag"):
        from esvio_tpu_torch.io import rosbag
        seq = rosbag.convert_rosbag(
            path,
            event_left="/davis_left/events", event_right="/davis_right/events",
            imu="/davis_left/imu",
            image_left="/davis_left/image_raw" if cfg.system_mode == 1 else None,
            image_right="/davis_right/image_raw" if cfg.system_mode == 1 else None)
    else:
        raise SystemExit(f"unrecognized sequence format: {path}")

    if gt_path and seq.ground_truth is None:
        if gt_path.endswith(".npz"):
            z = np.load(gt_path)
            seq.ground_truth = (z["gt_t"], z["gt_p"])
        else:  # TUM text: t x y z qx qy qz qw
            rows = np.loadtxt(gt_path, comments="#")
            seq.ground_truth = (rows[:, 0], rows[:, 1:4])
    return seq


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--seq", help="sequence: npz | mvsec hdf5 | bag | DSEC dir")
    ap.add_argument("--gt", default=None, help="ground truth (tum/npz/hdf5)")
    ap.add_argument("--out", default=None, help="output dir (or npz for --convert)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--freq", type=float, default=None)
    ap.add_argument("--convert", default=None, metavar="BAG",
                    help="convert a rosbag to packed npz and exit")
    ap.add_argument("--event-capacity", type=int, default=1 << 16)
    ap.add_argument("--save-pose-graph", default=None)
    ap.add_argument("--load-pose-graph", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the pipeline (default: the card)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the per-tick record as JSON lines to PATH")
    args = ap.parse_args(argv)

    from esvio_tpu_torch.io.config import load_config
    cfg = load_config(args.config)

    if args.convert:
        seq = load_sequence(args.convert, cfg, args.gt)
        out = args.out or (os.path.splitext(args.convert)[0] + ".npz")
        ds.save_npz(seq, out)
        print(json.dumps({"converted": out,
                          "events_left": len(seq.events_left),
                          "imu": 0 if seq.imu is None else len(seq.imu.t)}))
        return 0

    if not args.seq:
        ap.error("--seq is required (or use --convert)")
    seq = load_sequence(args.seq, cfg, args.gt)

    from esvio_tpu_torch.apps.pipeline import Pipeline
    pipe = Pipeline(cfg, cfg.cameras, args.device,
                    event_capacity=args.event_capacity,
                    trace=args.trace_out is not None)
    if args.load_pose_graph:
        pipe.load_pose_graph(args.load_pose_graph)
    res = pipe.run(seq, freq=args.freq, max_frames=args.max_frames)

    out_dir = args.out or cfg.output_path
    res.write(out_dir)
    if args.save_pose_graph:
        pipe.save_pose_graph(args.save_pose_graph)
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            for line in res.ticks:
                f.write(json.dumps(line) + "\n")

    summary = {
        "config": args.config, "seq": args.seq,
        "frames": len(res.stamps), "restarts": res.n_restarts,
        "loops": res.n_loops, "out": out_dir,
        "stage_ms": res.stage_times,
    }
    if seq.ground_truth is not None and len(res.stamps) >= 2:
        gt_t, gt_P = seq.ground_truth
        summary["ate_rmse_m"] = float(res.ate(gt_t, gt_P, alignment="yaw"))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
