"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_banned_names_are_whole_names():
    sys.path.insert(0, BENCH)
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["vdlm2dec_tpu_torch.pipeline"] = object()
        assert "vdlm2dec_tpu" not in run.banned_modules()
        sys.modules["vdlm2dec_tpu.ops"] = object()
        assert "vdlm2dec_tpu" in run.banned_modules()
        sys.modules["jaxlib"] = object()
        assert "jaxlib" in run.banned_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_no_source_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "vdlm2dec_tpu", "bench", "tools"}
    for d, _dirs, files in os.walk(BENCH):
        if os.sep + "tests" in d or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                assert not banned & set(_imports(os.path.join(d, f))), f


def test_reference_and_generator_import_nothing_of_the_port():
    for name in ("reference.py", "gen.py", "roofline.py", "protocol.py"):
        mods = set(_imports(os.path.join(BENCH, "vbench", name)))
        assert "vdlm2dec_tpu_torch" not in mods, name


def test_a_run_loads_no_jax(tiny_root):
    """A tiny run in a fresh process with JAX made unimportable: the run
    ends and no banned module is loaded (the check run.py makes)."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['vdlm2dec_tpu'] = None\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from vbench import cells, harness\n"
        f"spec = cells.load_spec({str(tiny_root)!r})\n"
        "cell = cells.cell(spec, 'rtl8-busy-file')\n"
        "r = harness.run_cell(spec, cell, 3, 1.0, False, device='cpu', "
        f"bench_dir={str(tiny_root / 'benchmark')!r})\n"
        "import run\n"
        "bad = [m for m in run.banned_modules() if sys.modules.get(m) is not None]\n"
        "assert r['correct'] and not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_run_without_a_card_prints_nothing():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "rtl8-busy-file", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
