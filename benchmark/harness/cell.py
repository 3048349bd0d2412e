"""A cell of BENCHMARK.json and the files it is made of, found by name.

  configs/<config>/esvio.yaml       the deployment's system YAML (the
                                    reference's esvio.yaml dialect) and its
                                    camera YAMLs beside it
  configs/<config>/deployment.json  source, published settings, what was
                                    assumed and reduced, the event capacity
                                    and the synthetic scene's geometry
  traffic/<traffic>.json            the circuit, events, IMU, texture and
                                    warm-up of the mix
  cells/<workload>.json             the limits that decide `correct`
  metrics/<metric>.py               one reader per per-layer metric
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic_name: str
    chips: int
    yaml_path: str
    deployment: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def scene(self) -> dict:
        return self.deployment["scene"]


def benchmark_json(root=ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load(workload: str, root=ROOT, bench_dir=BENCH_DIR) -> Cell:
    b = benchmark_json(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    cdir = os.path.join(bench_dir, "configs", w["config"])

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, config=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), yaml_path=os.path.join(cdir, "esvio.yaml"),
        deployment=_json(os.path.join(cdir, "deployment.json")),
        traffic=_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(bench_dir, "cells", workload + ".json")),
        end_to_end=[m for m in b["end_to_end"] if applies(m)],
        per_layer=[m for m in b["per_layer"] if applies(m)])


def reader(metric: str, bench_dir=BENCH_DIR):
    """The module metrics/<metric>.py (its `read(slice)`, UNIT, LAYER)."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
