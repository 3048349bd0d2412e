"""The configurations read back through the port's load_config as their
published settings, and BENCHMARK.json within its contract."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from harness import cell

B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("conf", [c["name"] for c in B["configs"]])
def test_yaml_reads_back_as_published(conf):
    from esvio_tpu_torch.io.config import load_config
    d = os.path.join(BENCH, "configs", conf)
    dep = json.load(open(os.path.join(d, "deployment.json")))
    cfg = load_config(os.path.join(d, "esvio.yaml"))
    for k, v in dep["published"].items():
        assert getattr(cfg, k) == v, k
    sc = dep["scene"]
    for name, cam in cfg.cameras.items():
        pre = "img_" if name.startswith("cam") else ""
        for k in ("fx", "fy", "cx", "cy"):
            assert float(getattr(cam, k)) == pytest.approx(sc[pre + k]), (name, k)
        assert (cam.width, cam.height) == (sc[pre + "width"], sc[pre + "height"])
        assert float(cam.dist.abs().max()) == 0.0
    assert abs(cfg.t_body_event1[0] - cfg.t_body_event0[0]) == pytest.approx(sc["baseline_m"])
    assert (cfg.system_mode == 1) == bool(sc["frame_hz"])


def test_benchmark_json_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"] and B["command"][1] == "benchmark/run.py"
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/configs/" + c["name"] + "/")
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in B[k]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in B["end_to_end"])
    # a full check: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of
    # compiling per cell and 1,200 s spare fit in 43,200 s
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_every_cell_finds_its_files_and_readers(w):
    c = cell.load(w)
    assert os.path.isfile(c.yaml_path) and c.limits["limits"]
    assert {"circuit", "texture", "events", "imu", "warmup"} <= set(c.traffic)
    for m in c.per_layer:
        r = cell.reader(m["name"])
        assert r.UNIT == m["unit"] and r.LAYER == m["layer"]
        assert m["moves"] == "realtime_x"
