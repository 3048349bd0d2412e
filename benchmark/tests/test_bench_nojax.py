"""The no-JAX check compares whole top-level names; the entry point gives
no result without a card, or without the port beside it."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from harness import nojax


@pytest.mark.parametrize("mods, bad", [
    (["esvio_tpu_torch", "esvio_tpu_torch.apps.pipeline", "numpy", "torch"], []),
    (["esvio_tpu", "esvio_tpu.core.lie"], ["esvio_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["bench", "tools.report", "tests.synth_np"], ["bench", "tests", "tools"]),
    (["jaxtyping", "benchmarks", "toolsy", "esvio_tpux"], []),
])
def test_top_level_names_are_compared_whole(mods, bad):
    assert nojax.forbidden_loaded(mods) == bad


def _run(cwd, workload="dsec_esio.drive"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except ValueError:
            pass
    return True


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and _no_result(p.stdout), p.stderr[-2000:]


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and _no_result(p.stdout), p.stderr[-2000:]
