"""Pipeline.run(chunk_pairs=...) and the stream watchdog: the same chunk
pairs, with time going backwards once, a duplicated stamp and a gap over
1 s, through the port's and the JAX package's Pipeline built from the same
YAML files.

Tolerances: none — restart and tick counts equal.
"""
import numpy as np

import torch_parity  # noqa: F401 (its torch thread cap)
from synth_np import vio_pipeline
from esvio_tpu_torch.apps.pipeline import Pipeline
from esvio_tpu_torch.io import datasets as tds
from esvio_tpu_torch.io.config import load_config

# (chunk index, stamp shift s): tick 3 goes back to chunk 1 (backwards:
# restart), tick 4 repeats its stamp (no restart), tick 5 comes 2 s later
# (a gap: restart)
PAIRS = [(0, 0.0), (1, 0.0), (2, 0.0), (1, 0.0), (1, 0.0), (3, 2.0)]


def test_chunk_pairs_watchdog_restarts_match_jax(tmp_path):
    import jax.numpy as jnp
    from esvio_tpu.apps.pipeline import Pipeline as JPipeline
    from esvio_tpu.events.sae import EventChunk as JChunk
    from esvio_tpu.io.config import load_config as jload_config
    _, seq, _, _ = vio_pipeline("cpu", H=120, W=160, focal=200.0, duration=0.4,
                                config_dir=str(tmp_path))
    cl = list(tds.iterate_chunks(seq.events_left, 15, 1 << 15, "cpu"))
    cr = list(tds.iterate_chunks(seq.events_right, 15, 1 << 15, "cpu"))
    cfg_path = str(tmp_path / "esvio.yaml")

    cfg = load_config(cfg_path)
    res = Pipeline(cfg, cfg.cameras, "cpu", event_capacity=1 << 15).run(
        seq, chunk_pairs=[((cl[k][0] + dt, cl[k][1]), (cr[k][0] + dt, cr[k][1]))
                          for k, dt in PAIRS])
    as_j = lambda c: JChunk(*(jnp.asarray(getattr(c, f).numpy())
                              for f in ("t", "x", "y", "p", "valid")))
    jcfg = jload_config(cfg_path)
    jres = JPipeline(jcfg, jcfg.cameras, event_capacity=1 << 15).run(
        seq, chunk_pairs=[((cl[k][0] + dt, as_j(cl[k][1])),
                           (cr[k][0] + dt, as_j(cr[k][1]))) for k, dt in PAIRS])
    assert res.n_restarts == jres.n_restarts == 2
    assert res.metrics["ticks"] == jres.metrics["ticks"] == len(PAIRS)
    assert res.metrics["events"] == jres.metrics["events"] > 0
