"""The benchmark's own tests (python -m pytest benchmark/tests -q): the
harness's arithmetic and files on hand-made input, and its control flow
through the port on the CPU at tiny sizes.  Tests marked `cuda` run a cell
on a card and skip without one."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny stand-ins of the configurations and mixes: the same keys at sizes
# a CPU test holds (2 or 24 channels, 1-row bursts, seconds of capture)
TINY_CONFIGS = {
    "rtl8": {"channels": 2, "block_seconds": 1.0, "max_rows": 1,
             "max_candidates": 16, "max_out": 64},
    "band760": {"fs": 2000000, "fc_hz": 136500000, "base_hz": 136200000,
                "channels": 24, "block_seconds": 0.5, "max_rows": 1,
                "max_candidates": 16, "max_out": 96},
}
TINY_TRAFFIC = {"seconds": 4.0, "text_max": 60, "lead_blocks": 2,
                "grace_blocks": 3, "trace_seconds": 1.0}
# tiny stand-ins of configurations that BENCHMARK.json does not carry:
# name -> (the configuration it is cut from, keys over it).  airspy2 is
# the Airspy R2's real-input route (f32real at 5 Msps, fc from the port's
# choose_fc_airspy, set in tiny_root) over rtl8's two tiny channels
STANDINS = {
    "airspy2": ("rtl8", {"format": "f32real", "fs": 5000000}),
}
# its cells: the cells of the configuration it is cut from, renamed
STANDIN_CELLS = {"airspy2-busy-file": "rtl8-busy-file",
                 "airspy2-busy-live": "rtl8-busy-live"}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like directory: BENCHMARK.json and a copy of benchmark/
    whose configurations and mixes are cut to CPU size, with the
    stand-ins' configurations, cells and metric entries added."""
    from vdlm2dec_tpu_torch.io.sdr import choose_fc_airspy

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY_CONFIGS.items():
        path = dst / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        path.write_text(json.dumps(cfg))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name, (like, over) in STANDINS.items():
        cfg = json.loads((dst / "configs" / f"{like}.json").read_text())
        cfg.update(over)
        freqs = [cfg["base_hz"] + cfg["spacing_hz"] * i for i in range(cfg["channels"])]
        cfg["fc_hz"] = choose_fc_airspy(freqs, cfg["fs"])
        (dst / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a tiny stand-in",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "tests"})
    for name, like in STANDIN_CELLS.items():
        cell = dict(next(w for w in spec["workloads"] if w["name"] == like), name=name)
        cell["config"] = name.split("-")[0]
        spec["workloads"].append(cell)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for path in (dst / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(TINY_TRAFFIC)
        if tr.get("active_every", 1) > 1:
            tr["active_every"] = 4
        path.write_text(json.dumps(tr))
    return tmp_path


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
