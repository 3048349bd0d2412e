"""The port's standing on the loop sequence of tests/test_e2e_loops.py
(synth_np.loop_pipeline) with motion correction and fast relocalization
each on and off, or over the event tracker's RANSAC keys, on one device.

    python tests/port_loop_spread.py cuda            # on the card
    python tests/port_loop_spread.py cpu
    python tests/port_loop_spread.py cuda 1:1 1:2 1:3 1:4
    python tests/port_loop_spread.py cpu --dump out/cpu 1:4
    python tests/port_loop_spread.py compare out/cpu/1_4.npz out/cuda/1_4.npz

Without further arguments: motion correction with fast relocalization
twice (to show whether repeated runs on one device agree), then each
option off.  Otherwise one run per argument "M" or "M:SEED", M 0 or 1 for
motion correction (fast relocalization on) and SEED the event tracker's
RANSAC key, drawn as `jax.random.PRNGKey(SEED)` (tests/jax_golden_spread.py
loops takes the same arguments for the JAX package).  One line per run:
the gates of tests/test_e2e_loops.py (synth_np.loop_gates), the
relocalization solves, the wall time, and the gauge the initialization
fixed: the velocity and position at the first NON_LINEAR tick, and the
velocity's error there against the ground truth's (finite differences of
its positions).  With `--dump DIR` each run also writes DIR/M_SEED.npz: per
tick the motion-corrected events, the event tracker's stages and packet,
and the estimator's output (_Recorder).  `compare A B` prints, for two
such files (one run on two devices), the first tick at which each of those
quantities differs.  Imports neither jax nor esvio_tpu.
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def _runs(argv):
    """[(motion correction, fast relocalization, tracker key seed or None)]."""
    if not argv:
        return [(True, True, None), (True, True, None), (False, True, None),
                (True, False, None), (False, False, None)]
    out = []
    for arg in argv:
        motion, _, seed = arg.partition(":")
        out.append((bool(int(motion)), True, int(seed) if seed else None))
    return out


def with_tracker_key(real_init, key):
    """trk.init_state with the event tracker's RANSAC key set to `key`
    (None: the tracker's own)."""
    def init_state(cfg, device="cuda", **kw):
        if key is not None:
            kw["key"] = key
        return real_init(cfg, device, **kw)
    return init_state


def _np_of(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class _Recorder:
    """Per-tick record of a pipeline run, as numpy: the motion-corrected
    events of both cameras (integer pixels), the event tracker's stages
    (time surfaces, every LK call's points and status, the F-RANSAC
    inliers, the corner mask, the grid spacing's keep mask), its packet and
    the estimator's outputs.  Keys are "name:tick:call" with the front-end
    tick counted from 0 and the call's index within that tick."""

    def __init__(self, pipe_mod, pipe):
        from esvio_tpu_torch.frontend import tracker as trk
        self.rec = {}
        self.tick = 0            # front-end tick of the calls being recorded
        self.est_tick = 0
        self._undo = []
        self._wrap(pipe_mod, "motion_correct_chunk", "warped",
                   lambda out: np.stack([_np_of(out.x[:int(out.n_host)]),
                                         _np_of(out.y[:int(out.n_host)])], -1))
        self._wrap(trk.sae_mod, "time_surface", "time_surface", _np_of)
        self._wrap(trk.lk, "lk_track", "lk",
                   lambda out: (_np_of(out[0]), _np_of(out[1])))
        self._wrap(trk.ransac, "fundamental_ransac", "ransac_inliers",
                   lambda out: _np_of(out[0]))
        self._wrap(trk.cor_mod, "detect_corners", "corners", _np_of)
        self._wrap(trk.mask_mod, "grid_spacing", "grid_keep",
                   lambda out: _np_of(out[0]))
        real_trk = pipe_mod.trk.track_event_stereo

        def track(*a, **k):
            state, pkt = real_trk(*a, **k)
            valid = _np_of(pkt.valid)
            self._add("packet_ids", np.sort(_np_of(pkt.ids)[valid]))
            order = np.argsort(_np_of(pkt.ids)[valid])
            self._add("packet_un", _np_of(pkt.un)[valid][order])
            self.tick += 1
            return state, pkt
        pipe_mod.trk.track_event_stereo = track
        self._undo.append((pipe_mod.trk, "track_event_stereo", real_trk))

        est = pipe.estimator
        real_pp = est.process_packets

        def pp(t, *a, **k):
            out = real_pp(t, *a, **k)
            for name in ("V", "P"):
                self._add("estimator_" + name, np.asarray(getattr(out, name),
                                                          np.float64),
                          tick=self.est_tick)
            self.est_tick += 1
            return out
        est.process_packets = pp

    def _wrap(self, mod, attr, name, extract):
        real = getattr(mod, attr)

        def wrapped(*a, **k):
            out = real(*a, **k)
            self._add(name, extract(out))
            return out
        setattr(mod, attr, wrapped)
        self._undo.append((mod, attr, real))

    def _add(self, name, value, tick=None):
        tick = self.tick if tick is None else tick
        values = value if isinstance(value, tuple) else (value,)
        call = sum(1 for k in self.rec
                   if k.startswith(f"{name}:{tick}:") and k.count(":") == 2)
        for i, v in enumerate(values):
            self.rec[f"{name}:{tick}:{call}" + (f":{i}" if i else "")] = v

    def save(self, path):
        for mod, attr, real in self._undo:
            setattr(mod, attr, real)
        np.savez_compressed(path, **self.rec)


def compare(path_a, path_b):
    """For each quantity recorded in two dumps of one run (on two devices),
    the first tick and call at which it differs and by how much; floats
    and discrete values (masks, ids, integer pixels) apart."""
    a, b = np.load(path_a), np.load(path_b)
    print(f"{path_a} vs {path_b}")
    keys = [k for k in a.files if k in b.files]
    order = lambda k: (int(k.split(":")[1]), int(k.split(":")[2]), k)
    first = {}
    for k in sorted(keys, key=order):
        name = k.split(":")[0] + (":" + k.split(":")[3]
                                  if k.count(":") == 3 else "")
        if name in first:
            continue
        x, y = a[k], b[k]
        if x.shape != y.shape:
            first[name] = f"{k}: shapes {x.shape} vs {y.shape}"
        elif not np.array_equal(x, y):
            n = int(np.sum(x != y))
            d = np.abs(x.astype(np.float64) - y.astype(np.float64)).max()
            first[name] = f"{k}: {n} of {x.size} elements differ, max |d| {d:.3g}"
    for name in sorted({k.split(":")[0] + (":" + k.split(":")[3]
                                           if k.count(":") == 3 else "")
                        for k in keys}):
        print(f"  {name}: {first.get(name, 'equal in every tick')}")


def main(device, argv):
    import esvio_tpu_torch
    import esvio_tpu_torch.apps.pipeline as pipe_mod
    from esvio_tpu_torch.core import prng
    from esvio_tpu_torch.frontend import tracker as trk
    from synth_np import loop_gates, loop_pipeline
    esvio_tpu_torch.disable_tf32()
    dump = None
    if argv[:1] == ["--dump"]:
        dump, argv = argv[1], argv[2:]
        os.makedirs(dump, exist_ok=True)
    real_init = trk.init_state
    made = {}
    for motion, reloc, seed in _runs(argv):
        # the pipeline (and every restart) starts its tracker with this key
        trk.init_state = with_tracker_key(
            real_init, None if seed is None else prng.PRNGKey(seed, device))
        if motion not in made:
            made[motion] = loop_pipeline(device, motion_correction=motion)
        make_pipeline, seq, gt_t, gt_P = made[motion]
        pipe = make_pipeline()
        pipe.sys_cfg.fast_relocalization = int(reloc)
        rec = _Recorder(pipe_mod, pipe) if dump else None
        t0 = time.perf_counter()
        res = pipe.run(seq)
        if rec is not None:
            rec.save(os.path.join(dump, f"{int(motion)}_{seed}.npz"))
        g = loop_gates(res, gt_t, gt_P)
        t1, V1, P1 = res.stamps[0], res.V[0], res.P[0]
        V_gt = np.gradient(gt_P, gt_t, axis=0)[np.argmin(np.abs(gt_t - t1))]
        print(f"{device} motion_correction {int(motion)} fast_relocalization "
              f"{int(reloc)} key {'default' if seed is None else seed}: "
              f"{g['n_stamps']} NON_LINEAR stamps, restarts "
              f"{g['restarts']}, ATE {g['ate']:.4f} m, loop ATE "
              f"{g['ate_loop']:.4f} m (gate {g['ate_loop_gate']:.4f}), "
              f"{g['loops']} loops, gates met {g['ok']}, "
              f"{pipe.estimator.n_relo_solves} relocalization solves; "
              f"{time.perf_counter() - t0:.1f} s; first NON_LINEAR t {t1:.4f}: "
              f"V {np.round(V1, 4).tolist()} (|V| {np.linalg.norm(V1):.4f}, "
              f"truth {np.linalg.norm(V_gt):.4f} m/s), P "
              f"{np.round(P1, 4).tolist()}", flush=True)
    trk.init_state = real_init


if __name__ == "__main__":
    if sys.argv[1:2] == ["compare"]:
        compare(*sys.argv[2:4])
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else "cuda", sys.argv[2:])
