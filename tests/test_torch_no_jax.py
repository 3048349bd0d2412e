"""The port stands without JAX: in a fresh interpreter where `import jax`
fails, every module of esvio_tpu_torch imports, two ESIO and two ESVIO
pipeline ticks run on the CPU, and chip_smoke and chip_ab import (without
running).  Nothing of jax or esvio_tpu may be loaded along the way."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None              # any `import jax` now raises
    sys.path[:0] = [{root!r}, {tests!r}]
    import torch
    torch.set_num_threads(2)
    import esvio_tpu_torch
    for m in pkgutil.walk_packages(esvio_tpu_torch.__path__, "esvio_tpu_torch."):
        importlib.import_module(m.name)
    from synth_np import vio_pipeline
    for mode in ("esio", "esvio"):
        make_pipeline, seq, _, _ = vio_pipeline("cpu", H=120, W=160, focal=200.0,
                                                duration=0.3, mode=mode)
        res = make_pipeline().run(seq, max_frames=2)
        assert res.metrics["ticks"] == 2, res.metrics
    assert res.stage_times["frontend_image"]["n"] == 2, res.stage_times
    import chip_smoke, chip_ab
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and m.split(".")[0] in ("jax", "jaxlib", "esvio_tpu")]
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def test_port_imports_and_runs_without_jax():
    code = SCRIPT.format(root=ROOT, tests=os.path.join(ROOT, "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
