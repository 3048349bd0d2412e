"""The mono drive (tests/synth_np.estimator_drive("mono")) on a JAX
estimator copied to the port at its mono init tick (split from
test_torch_init.py; the port's whole drives: test_torch_init_port_drives.py).

Decisions exact: both stereo inits fail, both mono inits succeed,
`find_frame_l`'s l.  The window after the mono init (P, V, Q) within 2e-3,
the tolerance the JAX package allows between its own two paths
(tests/test_fused_tick.py:66-67), Bg within 1e-4.
"""
import numpy as np
import jax

import synth_np
from torch_parity import estimator_to_torch, jax_general_estimator
from esvio_tpu.init import sfm as jsfm
from esvio_tpu_torch.core import prng
from esvio_tpu_torch.init import sfm as tsfm
from esvio_tpu_torch.vio import estimator as test_


def test_mono_init_from_jax_state():
    """The mono drive (stereo off) on the JAX estimator up to its init tick;
    there the stereo bootstrap fails on both sides, and the port, copied
    from the JAX estimator at that moment, initializes through its mono
    fallback as the JAX one does: the same decisions and the same window."""
    traj, ex_p, ex_q, packets, cfg_kw = synth_np.estimator_drive("mono", 11)
    je = jax_general_estimator(ex_p, ex_q, cfg_kw)
    seen = {}
    real_stereo, real_mono = je._try_initialize, je._try_initialize_mono

    def stereo():
        te = estimator_to_torch(je)
        seen["stereo"] = (real_stereo(), te._try_initialize())
        seen["te"] = te
        return seen["stereo"][0]

    def mono():
        te = seen["te"]
        book, _ = te._loop_book()
        obs = book.un.numpy()
        mask = book.obs.numpy() & book.active.numpy()[:, None]
        seed = int(je.timestamps[0] * 1e3) & 0x7FFFFFFF
        seen["l"] = (jsfm.find_frame_l(jax.random.PRNGKey(seed), obs, mask)[0],
                     tsfm.find_frame_l(prng.PRNGKey(seed), obs, mask)[0])
        seen["mono"] = (real_mono(), te._try_initialize_mono())
        return seen["mono"][0]

    je._try_initialize, je._try_initialize_mono = stereo, mono
    je._triangulate = lambda: (_ for _ in ()).throw(StopIteration)
    for f, pkt in enumerate(packets):
        if f > 0:
            synth_np.feed_imu(je, traj, f)
        try:
            je.process_packets(traj["t"][f], pkt)
        except StopIteration:          # initialized: stop before its solve
            break
    assert f == test_.WINDOW and je.solver_flag == "NON_LINEAR"
    assert seen["stereo"] == (False, False)
    assert seen["l"][0] is not None and seen["l"][0] == seen["l"][1]
    assert seen["mono"] == (True, True)
    te = seen["te"]
    for name, tol in (("P", 2e-3), ("V", 2e-3), ("Q", 2e-3), ("Bg", 1e-4),
                      ("Ba", 0.0)):
        np.testing.assert_allclose(getattr(te.ws, name).numpy(),
                                   np.asarray(getattr(je.ws, name)), atol=tol,
                                   err_msg=name)
