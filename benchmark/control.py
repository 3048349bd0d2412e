"""The correctness controls and faults of the benchmark, run on the card at
a cell's own size (the benchmark's own runs never run them):

    python3 benchmark/control.py <mode> --workload <cell> --seed <n> --seconds <s> --trace 0 [--ticks <n>]

sound   the pipeline as the benchmark runs it (the lower readings);
tf32    the pipeline with float32 products in TF32, the precision below the
        full float32 (TF32 off) that the pipeline sets for itself;
focal2  the control: the pipeline given its cameras' focal lengths 2 % long,
        which breaks the calibration that the deployment states;
half    the fault "half of the batch left out": the front ends keep half of
        the configuration's max_cnt features a tick.

--ticks closes the window after that many ticks as well as after
--seconds, so that runs sharing a card judge as many ticks as a run alone.
Each prints the run's result line with `correct` and its readings, as
benchmark/run.py does; PERF.md keeps the readings the limits were set from.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run  # noqa: E402

MODES = ("sound", "tf32", "focal2", "half")

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in MODES:
        sys.exit(__doc__)
    argv, ticks = sys.argv[2:], None
    if "--ticks" in argv:
        k = argv.index("--ticks")
        ticks = int(argv[k + 1])
        argv = argv[:k] + argv[k + 2:]
    mode = None if sys.argv[1] == "sound" else sys.argv[1]
    sys.exit(run.main(argv, control=mode, window_ticks=ticks))
