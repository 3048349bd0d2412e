"""Which of the run CLI's default sizes decides where the golden ESIO run
initializes, on one device.

The run CLI (apps/run.py) builds its pipeline from the YAML alone, so its
tracker and estimator take the sizes of `Pipeline`'s defaults; the golden
pipeline (synth_np.vio_pipeline, tests/test_golden_trace.py's settings)
sets them in code.  This script writes the golden's YAML files and runs
the golden sequence through:

  * "cli": the pipeline the CLI builds (its default configurations);
  * "golden": synth_np.vio_pipeline's (phase 17 of chip_smoke.py);
  * "cli+FIELD": the CLI's, with one field of the tracker or estimator
    configuration set to the golden's value (every field that differs);
  * "golden-FIELD": the golden's, with that one field at the CLI's value.

    python tests/golden_defaults_sweep.py cuda            # every variant
    python tests/golden_defaults_sweep.py cpu cli golden  # some of them
    python tests/golden_defaults_sweep.py cpu --dump out/cpu cli
    python tests/port_loop_spread.py compare out/cpu/cli.npz out/cuda/cli.npz

One line per variant: its first NON_LINEAR tick, NON_LINEAR frames, the
yaw-aligned ATE, whether its stamps are the golden's last ones, and the
wall time.  With `--dump DIR` a variant also writes DIR/<variant>.npz, the
per-tick record of port_loop_spread._Recorder (tracker stages, packets,
estimator outputs).  Imports neither jax nor esvio_tpu.
"""
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

EVENT_CAPACITY = 1 << 15      # the golden pipeline's and the CLI calls'


def _diff(a, b):
    return [f.name for f in dataclasses.fields(a)
            if getattr(a, f.name) != getattr(b, f.name)]


def variants(cli, golden):
    """{name: (tracker_cfg, est_cfg)} from the CLI's and the golden's
    pipelines."""
    out = {"cli": (cli.tracker_cfg, cli.est_cfg),
           "golden": (golden.tracker_cfg, golden.est_cfg)}
    for part in ("tracker_cfg", "est_cfg"):
        c, g = getattr(cli, part), getattr(golden, part)
        for name in _diff(c, g):
            for label, base, other in (("cli+", cli, golden),
                                       ("golden-", golden, cli)):
                cfgs = {"tracker_cfg": base.tracker_cfg,
                        "est_cfg": base.est_cfg}
                cfgs[part] = dataclasses.replace(
                    cfgs[part], **{name: getattr(getattr(other, part), name)})
                out[label + name] = (cfgs["tracker_cfg"], cfgs["est_cfg"])
    return out


def main(device, argv):
    import esvio_tpu_torch
    import esvio_tpu_torch.apps.pipeline as pipe_mod
    from esvio_tpu_torch.apps.pipeline import Pipeline
    from esvio_tpu_torch.io.config import load_config
    from port_loop_spread import _Recorder
    from synth_np import GOLDEN, vio_pipeline
    esvio_tpu_torch.disable_tf32()
    dump = None
    if argv[:1] == ["--dump"]:
        dump, argv = argv[1], argv[2:]
        os.makedirs(dump, exist_ok=True)
    z = np.load(os.path.join(HERE, "golden", "esio_planar_rot.npz"))
    with tempfile.TemporaryDirectory() as d:
        make_golden, seq, gt_t, gt_P = vio_pipeline(device, **GOLDEN,
                                                    config_dir=d)
        cfg = load_config(os.path.join(d, "esvio.yaml"))
    cli = Pipeline(cfg, cfg.cameras, device, event_capacity=EVENT_CAPACITY)
    golden = make_golden()
    print(f"{device}: tracker fields that differ "
          f"{ {n: (getattr(cli.tracker_cfg, n), getattr(golden.tracker_cfg, n)) for n in _diff(cli.tracker_cfg, golden.tracker_cfg)} }, "
          f"estimator fields {  {n: (getattr(cli.est_cfg, n), getattr(golden.est_cfg, n)) for n in _diff(cli.est_cfg, golden.est_cfg)} } "
          f"(CLI's, golden's)", flush=True)
    table = variants(cli, golden)
    for name in argv or list(table):
        tracker_cfg, est_cfg = table[name]
        pipe = Pipeline(cfg, cfg.cameras, device, tracker_cfg=tracker_cfg,
                        est_cfg=est_cfg, event_capacity=EVENT_CAPACITY)
        rec = _Recorder(pipe_mod, pipe) if dump else None
        t0 = time.perf_counter()
        res = pipe.run(seq)
        wall = time.perf_counter() - t0
        if rec is not None:
            rec.save(os.path.join(dump, f"{name}.npz"))
        ticks = int(res.metrics["ticks"])
        n = len(res.stamps)
        on_golden = n > 0 and n <= len(z["stamps"]) and bool(np.allclose(
            res.stamps, z["stamps"][-n:], rtol=0, atol=1e-6))
        ate = (f"{float(res.ate(gt_t, gt_P, alignment='yaw')):.4f} m"
               if n >= 2 else "none")
        print(f"{device} {name}: first NON_LINEAR tick "
              f"{ticks - n if n else None} of {ticks}, {n} NON_LINEAR "
              f"frames (golden {len(z['stamps'])}), stamps the golden's last "
              f"{n}: {on_golden}, ATE {ate}, restarts {res.n_restarts}; "
              f"{wall:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda", sys.argv[2:])
