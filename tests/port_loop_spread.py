"""The port's standing on the loop sequence of tests/test_e2e_loops.py
(synth_np.loop_pipeline) with motion correction and fast relocalization
each on and off, on one device.

    python tests/port_loop_spread.py cuda      # on the card
    python tests/port_loop_spread.py cpu

Motion correction with fast relocalization runs twice, to show whether
repeated runs on one device agree.  One line per run: the gates of
tests/test_e2e_loops.py (synth_np.loop_gates), the relocalization solves
and the wall time.  Imports neither jax nor esvio_tpu.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main(device):
    import esvio_tpu_torch
    from synth_np import loop_gates, loop_pipeline
    esvio_tpu_torch.disable_tf32()
    made = {}
    for motion, reloc in ((True, True), (True, True), (False, True),
                          (True, False), (False, False)):
        if motion not in made:
            made[motion] = loop_pipeline(device, motion_correction=motion)
        make_pipeline, seq, gt_t, gt_P = made[motion]
        pipe = make_pipeline()
        pipe.sys_cfg.fast_relocalization = int(reloc)
        t0 = time.perf_counter()
        res = pipe.run(seq)
        g = loop_gates(res, gt_t, gt_P)
        print(f"{device} motion_correction {int(motion)} fast_relocalization "
              f"{int(reloc)}: {g['n_stamps']} NON_LINEAR stamps, restarts "
              f"{g['restarts']}, ATE {g['ate']:.4f} m, loop ATE "
              f"{g['ate_loop']:.4f} m (gate {g['ate_loop_gate']:.4f}), "
              f"{g['loops']} loops, gates met {g['ok']}, "
              f"{pipe.estimator.n_relo_solves} relocalization solves; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
