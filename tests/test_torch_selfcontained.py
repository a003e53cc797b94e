"""The PyTorch port stands alone: it imports nothing of the JAX package.

Three checks:

  * no module of vdlm2dec_tpu_torch, nor chip_smoke.py, has an import of
    `vdlm2dec_tpu`, `jax`, `bench` or `tools` (an AST walk, so imports
    inside functions count too);
  * a process in which those modules cannot be imported imports every
    module of the port, synthesizes a one-burst cu8 capture with the
    port's own framegen / modulator and decodes it through the port's CLI
    on the CPU, through the CLI with a --mesh too, and runs the
    multi-host worker's entry point on it;
  * every numpy module that the port keeps as its own copy is pinned to
    its original in the JAX package: equal code once docstrings are
    dropped and import statements reduced to the names they bind (the
    copies differ from the originals in where they import from and in
    what their docstrings say, in nothing else; metrics.py and io/live.py,
    which the port extends, hold the original's statements in order, with
    the port's own beside them, one snapshot key renamed, and three counters
    added to PipelineMetrics and its snapshot), or, for the two that were
    rewritten around the same code (the native deframer's binding, which
    builds elsewhere, and the stimulus, cut out of bench.py), equal outputs
    on seeded inputs.
"""
import ast
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import bench
from vdlm2dec_tpu.golden import codec as jcodec
from vdlm2dec_tpu.host import native as jnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vdlm2dec_tpu_torch")
ORIG = os.path.join(REPO, "vdlm2dec_tpu")
FORBIDDEN = {"vdlm2dec_tpu", "jax", "bench", "tools"}


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path: str) -> set[tuple[str, int]]:
    """(root package, line) of every absolute import in the file."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {(a.name.split(".")[0], node.lineno) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add((node.module.split(".")[0], node.lineno))
    return found


def test_port_has_no_import_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 30              # the walk found the package
    bad = [(os.path.relpath(p, REPO), line, root) for p in sources
           for root, line in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


_STANDALONE = r"""
import contextlib, importlib, io, json, os, pkgutil, sys
for name in ("jax", "vdlm2dec_tpu", "bench", "tools"):
    sys.modules[name] = None
import numpy as np
import vdlm2dec_tpu_torch as port
mods = sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                    port.__name__ + "."))
for name in mods:
    importlib.import_module(name)
from vdlm2dec_tpu_torch import cli, framegen as fg, modulator as mod
from vdlm2dec_tpu_torch.io.sdr import write_capture
fs, freq, fc = 2_000_000, 136_975_000, 136_900_000
rng = np.random.default_rng(11)
plan = mod.make_burst([fg.acars_frame(text="STANDS ALONE", label="Q0")])
bb = mod.synthesize_baseband(plan, start=900, total=3 * 8400)
wide = mod.upsample_to_wideband(bb, fs, freq - fc) * 40.0
wide = wide + rng.normal(size=len(wide)) + 1j * rng.normal(size=len(wide))
path = os.path.join(sys.argv[1], "one.cu8")
write_capture(path, wide, "cu8")
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = cli.main(["136.975", "--iq", path, "--fc", str(fc), "--max-rows",
                   "2", "-J", "--device", "cpu"])
mesh_out = io.StringIO()
with contextlib.redirect_stdout(mesh_out):
    rc_mesh = cli.main(["136.975", "--iq", path, "--fc", str(fc),
                        "--max-rows", "2", "-J", "--device", "cpu",
                        "--mesh", "1x2"])
from vdlm2dec_tpu_torch.parallel import multihost
worker_out = io.StringIO()
with contextlib.redirect_stdout(worker_out):
    rc_worker = multihost._worker_main(
        ["136.975", "--iq", path, "--fc", str(fc), "--device", "cpu",
         "--time-shards", "3", "--max-symbols", "1376", "--output", "json"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "vdlm2dec_tpu", "bench", "tools")
                and sys.modules[m] is not None)
lines = lambda o: [l for l in o.getvalue().splitlines() if l]
print(json.dumps({"rc": [rc, rc_mesh, rc_worker], "modules": mods,
                  "loaded": loaded, "lines": lines(out),
                  "mesh_lines": lines(mesh_out),
                  "worker_lines": lines(worker_out)}))
"""


def test_port_imports_and_decodes_with_the_jax_package_blocked(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _STANDALONE, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=600,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["rc"] == [0, 0, 0] and res["loaded"] == []
    for name in ("cli", "pipeline", "scan", "stage_times", "stimulus",
                 "bench", "snr_sweep", "kernel_times", "trigger_compare",
                 "host.decoder", "host.native", "ops.sync", "ops.chan_u8",
                 "io.live", "golden.codec", "golden.dsp",
                 "parallel.sharding", "parallel.multihost", "drive_formats",
                 "soak_compare", "scaling_bench"):
        assert f"vdlm2dec_tpu_torch.{name}" in res["modules"]
    assert len(res["lines"]) == 1
    assert json.loads(res["lines"][0])["text"] == "STANDS ALONE"
    # --mesh prints the same record; the worker (one process, three time
    # shards, json surface) decodes the same burst
    for key in ("mesh_lines", "worker_lines"):
        records = [json.loads(l) for l in res[key] if l[0] == "{"]
        assert [r["text"] for r in records] == ["STANDS ALONE"]
    assert res["worker_lines"][-1].startswith("DONE 0 ")


# ------------------------------------------------------------ pinned copies

def _strip_docstring(body: list) -> list:
    first = body[0] if body else None
    if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
            and isinstance(first.value.value, str)):
        body = body[1:] or [ast.Pass()]
    return body


def _normalised(path: str) -> str:
    """The file's code as an AST dump without positions: docstrings dropped,
    every import statement reduced to the sorted names it binds."""
    return ast.dump(_normalised_tree(path))


def _normalised_tree(path: str) -> ast.Module:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            node.body = _strip_docstring(node.body)
        for name in ("body", "orelse", "finalbody"):
            stmts = getattr(node, name, None)
            if not isinstance(stmts, list):
                continue
            for i, stmt in enumerate(stmts):
                if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                    bound = sorted(a.asname or a.name for a in stmt.names)
                    stmts[i] = ast.Expr(ast.Constant(bound))
    return tree


# port path (under vdlm2dec_tpu_torch/) -> original (under vdlm2dec_tpu/)
COPIES = {
    "constants.py": "constants.py",
    "golden/codec.py": "golden/codec.py",
    "golden/dsp.py": "golden/dsp.py",
    "io/sdr.py": "io/sdr.py",
    "io/live.py": "io/live.py",
    "host/avlc.py": "host/avlc.py",
    "host/acars.py": "host/acars.py",
    "host/fans.py": "host/fans.py",
    "host/arinc.py": "host/arinc.py",
    "host/xid.py": "host/xid.py",
    "host/flights.py": "host/flights.py",
    "host/output.py": "host/output.py",
    "host/checkpoint.py": "host/checkpoint.py",
    "host/decoder.py": "host/decoder.py",
    "metrics.py": "metrics.py",
    "framegen.py": "framegen.py",
    "modulator.py": "modulator.py",
}


# copies that the port extends: string constants the port renamed (its
# name -> the original's); the original's top-level statements must appear
# in the port's, in order, and the port's own may stand between them
EXTENDED = {
    # the port's PipelineMetrics.device_time_s is the fused route's stream
    # time from CUDA events; the snapshot names it so
    "metrics.py": {"device_stream_s": "device_time_s"},
    # the fused live route's RawReader
    "io/live.py": {},
}

# names an extended copy adds inside the original's statements: class
# fields of these names, and dict entries under these keys, are left out
# of the port's code before the comparison
ADDED = {
    # the fused live route's wait for each block's result, and its blocks;
    # the raw bytes the fused routes upload
    "metrics.py": {"live_result_wait_s", "live_blocks", "h2d_bytes"},
}


def _top_statements(path: str, rename: dict,
                    added: frozenset = frozenset()) -> list[str]:
    tree = _normalised_tree(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value in rename:
            node.value = rename[node.value]
        elif isinstance(node, ast.ClassDef):
            node.body = [st for st in node.body
                         if not (isinstance(st, ast.AnnAssign)
                                 and isinstance(st.target, ast.Name)
                                 and st.target.id in added)]
        elif isinstance(node, ast.Dict):
            kept = [(k, v) for k, v in zip(node.keys, node.values)
                    if not (isinstance(k, ast.Constant) and k.value in added)]
            node.keys = [k for k, _v in kept]
            node.values = [v for _k, v in kept]
    return [ast.dump(stmt) for stmt in tree.body]


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copied_module_equals_its_original(copy):
    """Same statements in the same order: only docstrings, comments and
    the packages the imports name may differ (an extended copy: the
    original's statements in order among the port's)."""
    port, orig = os.path.join(PORT, copy), os.path.join(ORIG, COPIES[copy])
    if copy not in EXTENDED:
        assert _normalised(port) == _normalised(orig)
        return
    mine = iter(_top_statements(port, EXTENDED[copy],
                                frozenset(ADDED.get(copy, ()))))
    missing = [s for s in _top_statements(orig, {}) if s not in mine]
    assert not missing, missing[:1]


def _cpp_code(path: str) -> list[str]:
    """The source's lines without // comments and blank lines."""
    with open(path) as fh:
        lines = [ln.split("//")[0].rstrip() for ln in fh]
    return [ln for ln in lines if ln]


def _frame_blocks(seed: int, n: int):
    """n burst blocks (8, 255) of HDLC-framed random frames laid out as
    deframe_corrected reads them (249 data bytes a row, nlbyte in the
    last), with their (nbrow, nlbyte)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = [rng.integers(0, 256, int(rng.integers(12, 200))
                               ).astype(np.uint8)
                  for _ in range(int(rng.integers(1, 5)))]
        for f in frames:
            if f[0] == 0x7E:
                f[0] = 0x7D
        bits = jcodec.build_burst_bitstream(frames)
        bits += [0] * (-len(bits) % 8)
        data = np.packbits(np.array(bits, np.uint8).reshape(-1, 8),
                           axis=1, bitorder="little").ravel()
        nbrow = -(-len(data) // 249)
        nlbyte = len(data) - 249 * (nbrow - 1)
        block = rng.integers(0, 256, (8, 255)).astype(np.uint8)
        for r in range(nbrow):
            row = data[249 * r: 249 * (r + 1)]
            block[r, : len(row)] = row
        out.append((block, nbrow, nlbyte, len(frames)))
    return out


def test_native_deframer_copy_equals_its_original():
    """The port's binding builds its own csrc/hostdec.cpp into _build/ and
    deframes as the JAX package's native library and as the Python
    Unstuffer do; the C++ sources carry the same code."""
    from vdlm2dec_tpu_torch.host import native

    assert _cpp_code(os.path.join(PORT, "csrc", "hostdec.cpp")) == \
        _cpp_code(os.path.join(REPO, "native", "hostdec.cpp"))
    assert native.native_available()
    built = native.library_path()
    assert built.exists() and built.parent.name == "_build"
    assert os.path.commonpath([str(built), PORT]) == PORT
    blocks = _frame_blocks(3, 12)
    per_block = []
    for block, nbrow, nlbyte, n_in in blocks:
        got = native.deframe_block_native(block[:nbrow], nbrow, nlbyte)
        un = jcodec.Unstuffer()
        for r in range(nbrow):
            for i in range(nlbyte if r == nbrow - 1 else 249):
                un.push_byte(int(block[r, i]))
        want = [f for f in un.frames if jcodec.frame_crc_ok(f)]
        assert 1 <= len(want) <= n_in
        assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
        if jnative.get_lib() is not None:
            theirs = jnative.deframe_block_native(block[:nbrow], nbrow, nlbyte)
            assert [g.tobytes() for g in got] == [t.tobytes() for t in theirs]
        per_block.append([g.tobytes() for g in got])
    stacked = np.stack([b[0] for b in blocks])
    batch = native.deframe_batch_native(
        stacked, np.array([b[1] for b in blocks]),
        np.array([b[2] for b in blocks]))
    assert [[f.tobytes() for f in fs] for fs in batch] == per_block


def test_stimulus_copy_equals_bench(monkeypatch, tmp_path):
    """stimulus.make_capture / to_u8 give bench.py's arrays and truth, on
    the first (synthesized) call and on the second (from their caches)."""
    from vdlm2dec_tpu_torch import stimulus

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for impaired in (True, False):
        args = dict(fs=2_000_000, n_channels=2, seconds=0.12, seed=5,
                    impaired=impaired)
        for _ in range(2):
            wide_p, freqs_p, fc_p, truth_p = stimulus.make_capture(**args)
            wide_j, freqs_j, fc_j, truth_j = bench.make_capture(**args)
            assert np.array_equal(wide_p, wide_j)
            assert (freqs_p, fc_p, truth_p) == (freqs_j, fc_j, truth_j)
            assert len(truth_p) >= 2
            assert np.array_equal(stimulus.to_u8(wide_p), bench.to_u8(wide_j))
    assert len(list(tmp_path.glob("*.npz"))) == 4
