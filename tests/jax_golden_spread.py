"""The JAX package's own standing against a golden trace, and its spread
when only the event tracker's RANSAC key changes.

    JAX_PLATFORMS=cpu python tests/jax_golden_spread.py esvio default 1 2 3

runs the golden pipeline of tests/test_golden_trace.py (mode "esio" or
"esvio", the JAX package's default fused path, the test suite's JAX
settings) once per seed ("default" keeps the tracker's own key) and prints
one line of gates each (synth_np.golden_gates: stamps, max deviation
unaligned and after the yaw + translation alignment, ATE).  The port's
chip_smoke holds its ESVIO golden run to what these runs meet.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main(argv):
    import conftest  # noqa: F401  (the suite's JAX settings: CPU, x64, cache)
    import jax
    from esvio_tpu.frontend import tracker as trk
    from synth_np import golden_gates
    from test_golden_trace import GOLDEN, GOLDEN_ESVIO, run_golden_pipeline

    mode, seeds = argv[0], argv[1:]
    npz = GOLDEN_ESVIO if mode == "esvio" else GOLDEN
    real = trk.init_state
    for seed in seeds:
        key = None if seed == "default" else jax.random.PRNGKey(int(seed))
        trk.init_state = lambda cfg, key_=key, **kw: real(cfg, key=key_, **kw)
        t0 = time.perf_counter()
        res, gt_t, gt_P = run_golden_pipeline(mode)
        g = golden_gates(res, gt_t, gt_P, npz)
        print(f"{mode} seed {seed}: stamps {g['n_stamps']}/{g['n_golden']} "
              f"ok {g['stamps_ok']}, max dev {g['max_dev']:.4f} m unaligned, "
              f"{g['max_dev_4dof']:.4f} m aligned (yaw {g['yaw_deg']:.2f} deg, "
              f"shift {g['shift_m']:.4f} m), ATE {g['ate']:.4f} m (golden "
              f"{g['ate_golden']:.4f}, gate ok {g['ate_ok']}); "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    trk.init_state = real


if __name__ == "__main__":
    main(sys.argv[1:])
