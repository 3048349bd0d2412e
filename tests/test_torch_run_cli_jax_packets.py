"""The JAX package's run CLI on the port tracker's packets: the golden as
YAML + npz (test_torch_run_cli.py's files), FRAMES ticks at the CLI's
default sizes.  The port CLI reaches NON_LINEAR at tick 13 there, where
the JAX CLI on its own packets never does; fed the port's packets, the
JAX back end makes the port CLI's run, so the two CLIs part in their
trackers' packets (float32 ulps), not in their back ends.

Tolerances: test_torch_run_cli.py's against the JAX CLI (the same frames,
stamps within 1e-6 s and restarts, the trajectory within 0.05 m once yaw
and translation are aligned, ATE at most 1.5x + 0.01 m).
"""
import torch_parity  # noqa: F401 (its torch thread cap)
from test_torch_run_cli import (golden_files, port_cli,  # noqa: F401 (fixtures)
                                _jax_cli, _same_run, _save_packets)


def test_jax_cli_on_port_packets_makes_the_port_run(golden_files, port_cli,
                                                    tmp_path):
    rc, summary, out, tpackets = port_cli
    tpk, jout = str(tmp_path / "port_packets.npz"), str(tmp_path / "jax")
    _save_packets(tpk, tpackets)
    jrc, jsummary = _jax_cli(golden_files, jout, replay=tpk)()
    assert rc == jrc == 0
    assert summary["frames"] >= 2
    _same_run(jsummary, jout, summary, out)
