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


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like directory: BENCHMARK.json and a copy of benchmark/
    whose configurations and mixes are cut to CPU size."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY_CONFIGS.items():
        path = dst / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        path.write_text(json.dumps(cfg))
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
