"""Everything of a cell found by name: the cell in BENCHMARK.json, its
configuration file, its traffic mix (benchmark/traffic/<name>.json) and
its per-layer readers (benchmark/metrics/<name>.py, one `read(record)`
each).  A new cell, mix or metric is a new file and a new entry; no file
here changes for it."""
from __future__ import annotations

import importlib.util
import json
import os

from .protocol import capture_format

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    """A configuration file, its capture format checked (ValueError)."""
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                cfg = json.load(fh)
            try:
                capture_format(cfg)
            except ValueError as e:
                raise ValueError(f"{c['file']}: {e}") from None
            return cfg
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as fh:
        return json.load(fh)


def metrics_of(spec: dict, cell_name: str, kind: str) -> list[dict]:
    """The cell's end-to-end or per-layer metrics: those that list it, and
    those with no list that cover a metric the cell reports."""
    out = []
    for m in spec[kind]:
        cells = m.get("workloads")
        if cells is None or cell_name in cells:
            out.append(m)
    return out


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read(record)` of benchmark/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
