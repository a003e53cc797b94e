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
    added to PipelineMetrics and its snapshot), or, for those that were
    rewritten (the native deframer's binding, which builds elsewhere; the
    stimulus, cut out of bench.py; the four host modules of FrameDecoder's
    hot path, which handle a frame as whole byte strings), equal outputs on
    seeded inputs.
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


# port path (under vdlm2dec_tpu_torch/) -> original (under vdlm2dec_tpu/);
# host/acars.py, avlc.py, flights.py and output.py, rewritten to work on
# whole byte strings, are held to their originals' outputs (REWRITTEN below)
COPIES = {
    "constants.py": "constants.py",
    "golden/codec.py": "golden/codec.py",
    "golden/dsp.py": "golden/dsp.py",
    "io/sdr.py": "io/sdr.py",
    "io/live.py": "io/live.py",
    "host/fans.py": "host/fans.py",
    "host/arinc.py": "host/arinc.py",
    "host/xid.py": "host/xid.py",
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


# ------------------------------------------- host copies held by their output

def _with_crc(body: bytes, last: int = 0x7F) -> bytes:
    """An ACARS payload: body, its inner CRC (low byte first), a last byte
    that the CRC does not cover."""
    from vdlm2dec_tpu_torch.constants import crc_update

    crc = 0
    for b in body:
        crc = crc_update(crc, b)
    return body + bytes([crc & 0xFF, crc >> 8, last])


def _acars_body(rng) -> bytes:
    """mode, reg, ack, label, bid, bs, then the text part and be, each drawn
    so that every branch of the parse is taken: mode past 'Z', bid 0 or past
    '9', label[1] 0x7F, bs 0x03, a text shorter than no + fid, any byte."""
    pick = lambda *vals: vals[int(rng.integers(0, len(vals)))]
    mode = pick(ord("2"), ord("Z"), ord("["), 0xDB, int(rng.integers(0, 256)))
    reg = pick(b".N123AB", b"..F-GKX", b"D-ABCDE", b"A9CABCD",
               rng.integers(0, 256, 7).astype(np.uint8).tobytes())
    ack = pick(0x15, 0x95, ord("A"), int(rng.integers(0, 256)))
    label = bytes([pick(ord("Q"), ord("1"), ord("H")),
                   pick(ord("0"), 0x7F, 0xFF, ord("E"))])
    bid = pick(0, 0x80, ord("1"), ord("9"), ord(":"), ord("A"))
    bs = pick(0x02, 0x03, 0x83, int(rng.integers(0, 256)))
    text = rng.integers(0, 256, int(rng.integers(0, 40))).astype(np.uint8)
    return (bytes([mode]) + reg + bytes([ack]) + label + bytes([bid, bs])
            + text.tobytes() + bytes([pick(0x03, 0x17, 0x97)]))


def _acars_inputs(rng) -> list:
    out = []
    for _ in range(300):
        good = _with_crc(_acars_body(rng), int(rng.integers(0, 256)))
        out.append(good)
        bad = bytearray(good)
        bit = int(rng.integers(0, 8 * len(bad)))
        bad[bit // 8] ^= 1 << (bit % 8)        # the last byte too: no CRC
        out.append(bytes(bad))
    for n in range(0, 20):                     # n < 13 and the short payloads
        for _ in range(4):
            body = rng.integers(0, 256, max(n - 3, 0)).astype(np.uint8).tobytes()
            out.append(_with_crc(body, int(rng.integers(0, 256)))[:n]
                       if n < 3 else _with_crc(body, int(rng.integers(0, 256))))
    return out


def _as_types(data: bytes, rng) -> list:
    """The integer inputs the original takes: uint8, int64 with high bits,
    int8 (negative values) and a list of ints."""
    a = np.frombuffer(data, np.uint8)
    return [a, a.astype(np.int64) + 256 * rng.integers(0, 3, len(a)),
            a.view(np.int8), a.tolist()]


def _case_parse_acars(port, orig, rng):
    from dataclasses import asdict

    seen = {"none": 0, "msg": 0, "bs3": 0, "short": 0}
    for data in _acars_inputs(rng):
        want_b = None
        for x in _as_types(data, rng):
            mine, theirs = port.acars.parse_acars(x), orig.acars.parse_acars(x)
            assert (mine is None) == (theirs is None), data
            assert mine is None or asdict(mine) == asdict(theirs), data
            assert port.acars.acars_crc_ok(x) == orig.acars.acars_crc_ok(x)
            if want_b is None:
                want_b = theirs
        mine = port.acars.parse_acars(data)      # bytes: the uint8 result
        assert (mine is None) == (want_b is None)
        if mine is None:
            seen["none"] += 1
            continue
        seen["msg"] += 1
        seen["bs3"] += mine.bs == 0x03
        seen["short"] += len(data) < 4 + 13 + 10
        assert asdict(mine) == asdict(port.acars.parse_acars(
            np.frombuffer(data, np.uint8)))
    assert min(seen.values()) > 10, seen


def _case_fixreg(port, orig, rng):
    prefixes = (orig.acars.REG_PREFIX_1 + orig.acars.REG_PREFIX_2
                + orig.acars.REG_PREFIX_3)
    raws = []
    for pre in prefixes:
        for tail in ("ABC", "-ABC", "1234", "", "A", "-", "ABCDEFG", ".X"):
            s = pre + tail
            raws += [s[:7], s.rjust(7, ".")[:7], ("." + s)[:7], s[:3]]
    alphabet = "ABCDNF9XZ23.-"
    raws += ["".join(alphabet[i] for i in rng.integers(0, len(alphabet), 7))
             for _ in range(500)]
    hyphenated = 0
    for raw in raws:
        data = raw.encode("latin-1")
        for x in (raw, data, np.frombuffer(data, np.uint8),
                  np.frombuffer(data, np.uint8).astype(np.int64)):
            assert port.acars.fixreg(x) == orig.acars.fixreg(x), raw
        hyphenated += "-" in port.acars.fixreg(raw) and "-" not in raw
    assert hyphenated > 100


def _case_icaoaddr(port, orig, rng):
    for pos in range(4):
        for v in range(256):
            b = rng.integers(0, 256, 7).astype(np.uint8)
            b[3 + pos] = v
            for x in (b, b.tobytes(), b.astype(np.int64)):
                for off in (0, 3):
                    assert port.avlc.icaoaddr(x, off) == \
                        orig.avlc.icaoaddr(x, off), (pos, v, off)


_JSON_VALUES = [True, False, 0, -7, 1 << 40, 0.1, 1.5e-7, 1e20, -0.0,
                float("nan"), float("inf"), "", "plain", 'quo"te', "back\\slash",
                "é ü ß", "日本", "\U0001f600", "".join(map(chr, range(32))),
                "\x7f\x80\xff", None, [1, "a"]]


def _case_json(port, orig, rng):
    from vdlm2dec_tpu.host.flights import Flight as JFlight

    for _ in range(300):
        mine, theirs = port.output.JsonBuilder(), orig.output.JsonBuilder()
        for j in range(int(rng.integers(0, 12))):
            value = _JSON_VALUES[int(rng.integers(0, len(_JSON_VALUES)))]
            raw = bool(rng.random() < 0.2)
            key = ("k%d" % j, "é", 'q"', "\n")[int(rng.integers(0, 4))]
            mine.add(key, value, raw=raw)
            theirs.add(key, value, raw=raw)
        assert mine.render() == theirs.render()
    assert port.output.APP_JSON == '{"name":"vdlm2dec","ver":"2.3"}'
    for _ in range(200):
        args = (int(rng.integers(0, 1 << 27)), int(rng.integers(0, 1 << 27)),
                bool(rng.random() < 0.5), int(rng.integers(0, 2)),
                int(rng.integers(0, 2)), float(rng.uniform(0, 2e9)),
                float(rng.uniform(118e6, 137e6)),
                ("", "BENCH", "é\"")[int(rng.integers(0, 3))])
        jm = port.output.build_json_header(*args)
        jt = orig.output.build_json_header(*args)
        data = _with_crc(_acars_body(rng))
        msg_m = port.acars.parse_acars(np.frombuffer(data, np.uint8))
        if msg_m is not None:
            msg_t = orig.acars.parse_acars(np.frombuffer(data, np.uint8))
            oooi_m, _ = port.acars.decode_label(msg_m)
            oooi_t, _ = orig.acars.decode_label(msg_t)
            oooi_m.epu = oooi_t.epu = int(rng.integers(0, 2))
            oooi_m.lat = oooi_t.lat = float(rng.uniform(-90, 90))
            port.output.add_acars_json(jm, msg_m, oooi_m)
            orig.output.add_acars_json(jt, msg_t, oooi_t)
        assert port.output.finish_json(jm) == orig.output.finish_json(jt)
        fm = port.flights.Flight(addr=args[0], reg="F-GABC", fid="AF123")
        ft = JFlight(addr=args[0], reg="F-GABC", fid="AF123")
        for f in (fm, ft):
            f.oooi.sa, f.oooi.da, f.oooi.epu = "LFPG", "EGLL", 6
        port.output.add_xid_json(jm, fm)
        orig.output.add_xid_json(jt, ft)
        assert jm.render() == jt.render()
        assert port.output.route_json(fm, args[5], args[7]) == \
            orig.output.route_json(ft, args[5], args[7])


def _case_flight_tracker(port, orig, rng, tmp_path):
    from vdlm2dec_tpu.host import checkpoint as jcheckpoint
    from vdlm2dec_tpu_torch.host import checkpoint

    def table(tr):
        return [jcheckpoint._flight_to_dict(f) for f in tr.flights()]

    mine, theirs = port.flights.FlightTracker(), orig.flights.FlightTracker()
    t = 1000.0
    expired = 0
    # a random walk, then steps on a quarter-second grid that land on the
    # expiry's edge and step back by less than a second
    steps = [float(x) for x in rng.normal(60.0, 400.0, 1000)]
    steps[700] = 5000.0                        # past the 1800 s expiry
    grid = (-1800.0, -0.5, -0.25, 0.25, 1.0, 60.0, 1799.75, 1800.0, 1800.25)
    steps += [grid[int(i)] for i in rng.integers(0, len(grid), 1000)]
    for i, step in enumerate(steps):
        t += step                              # out of order when negative
        addr = (1 << 24) | int(rng.integers(0, 60))
        a, b = mine.add(addr, t), theirs.add(addr, t)
        assert jcheckpoint._flight_to_dict(a) == jcheckpoint._flight_to_dict(b)
        before = len(theirs)
        assert table(mine) == table(theirs), i
        expired += before < 60 and len(theirs) < before
        if i == 900:                           # through a checkpoint and back
            pm, pt = tmp_path / "port.json", tmp_path / "orig.json"
            checkpoint.save_checkpoint(str(pm), 7, mine, {"x": 1})
            jcheckpoint.save_checkpoint(str(pt), 7, theirs, {"x": 1})
            assert pm.read_bytes() == pt.read_bytes()
            mine = port.flights.FlightTracker()
            assert checkpoint.load_checkpoint(str(pm), mine) == (7, {"x": 1})
    for now in (float("inf"), t, float("nan"), t):
        mine.add(5, now), theirs.add(5, now)
        assert table(mine) == table(theirs)
    assert len(theirs) == 1
    pm, pt = tmp_path / "port.json", tmp_path / "orig.json"
    checkpoint.save_checkpoint(str(pm), 9, mine)
    jcheckpoint.save_checkpoint(str(pt), 9, theirs)
    assert pm.read_bytes() == pt.read_bytes()


class _Pkg:
    def __init__(self, root):
        import importlib

        for name in ("acars", "avlc", "flights", "output"):
            setattr(self, name, importlib.import_module(f"{root}.host.{name}"))


@pytest.mark.parametrize("case", ["parse_acars", "fixreg", "icaoaddr",
                                  "json", "flight_tracker"])
def test_rewritten_host_copy_outputs_equal_original(case, tmp_path):
    """acars.py, avlc.py, output.py and flights.py of the port give what the
    JAX package's originals give on the same seeded inputs."""
    port, orig = _Pkg("vdlm2dec_tpu_torch"), _Pkg("vdlm2dec_tpu")
    rng = np.random.default_rng(17)
    args = (tmp_path,) if case == "flight_tracker" else ()
    globals()[f"_case_{case}"](port, orig, rng, *args)


def _decoder_corpus():
    """DecodedBursts of 1-3 frames (flags and FCS included) from the
    benchmark's generator: its ACARS and XID frames, and beside them OOOI
    texts, ACARS frames with odd fields or a flipped bit, frames from the
    ground, to address 0 or all ones, undecodable payloads, short frames."""
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    try:
        from vbench import gen
    finally:
        sys.path.remove(os.path.join(REPO, "benchmark"))
    from vdlm2dec_tpu_torch._tables import DecodedBurst
    from vdlm2dec_tpu_torch.golden.codec import frame_fcs

    rng = np.random.default_rng(23)
    fleet, regs, ground = gen._fleet(rng, 40)
    oooi = {"Q1": "LFPG0800081208300945LFPGEGLL", "QE": "LFPG1234EGLL",
            "15": "FST01LFPGEGLLN48500E002500", "44": "POS02,N48500E002500,"
            "EGLL,LFPG,00000000001234", "20": "RST" + "X" * 19 + "LFPGEGLL",
            "2Z": "EGLL", "16": "POSA1 N48500W002500", "H1": "#M1BPOSN48500E00250"}
    contents = []
    for i in range(1200):
        u = rng.random()
        kind = "xid" if u < 0.1 else "acars"
        f = gen._fields(kind, int(rng.integers(20, 201)), rng, fleet, ground,
                        regs, i)
        if kind == "xid":
            contents.append(gen.xid_frame(f))
            continue
        if u < 0.2:
            f["label"] = list(oooi)[int(rng.integers(0, len(oooi)))]
            f["text"] = oooi[f["label"]]
        c = gen.acars_frame(f)
        hdr = c[:12]
        if u > 0.95:                               # from the ground
            c = gen.avlc_header(gen.GROUND_D | int(ground[0]),
                                gen.AIRCRAFT | f["icao"], 0x03) + c[9:]
        elif u > 0.9:
            c = hdr + _with_crc(_acars_body(rng))
        elif u > 0.87:
            c = bytearray(c)
            c[int(rng.integers(12, len(c)))] ^= 1 << int(rng.integers(0, 8))
            c = bytes(c)
        elif u > 0.84:                             # undecodable
            c = c[:9] + rng.integers(0, 256, int(rng.integers(1, 40))
                                     ).astype(np.uint8).tobytes()
        elif u > 0.83:
            c = c[:9] + bytes([0x82]) + c[10:int(rng.integers(10, 14))]
        elif u > 0.82:
            c = gen.avlc_header(gen.AIRCRAFT | (0xFFFFFF * int(rng.integers(0, 2))),
                                gen.GROUND_D | 5, 0x03) + c[9:]
        elif u > 0.81:
            c = c[:int(rng.integers(9, 13))]
        contents.append(bytes(c))
    bursts, i = [], 0
    while i < len(contents):
        k = int(rng.integers(1, 4))
        frames = []
        for c in contents[i: i + k]:
            fcs = frame_fcs(np.frombuffer(c, np.uint8))
            frames.append(np.frombuffer(
                b"\x7e" + c + bytes([fcs & 0xFF, fcs >> 8]) + b"\x7e",
                np.uint8).copy())
        bursts.append(DecodedBurst(
            channel=i % 8, t0=37 * i, time_s=0.0119 * i + 0.0001 * (i % 7),
            freq_hz=136.6e6 + 25e3 * (i % 8), ppm=float(rng.uniform(-9, 9)),
            length_bits=0, nbrow=1, nlbyte=1, block=None, rs_counts=[],
            frames=frames))
        i += k
    return bursts


_DECODER_SETTINGS = {
    "json": (dict(verbose=0, jsonout=True, station_id="BENCH"), None),
    "verbose1": (dict(verbose=1), None),
    "verbose2": (dict(verbose=2, jsonout=True), None),
    "routeout": (dict(verbose=0, jsonout=True, routeout=True), None),
    "regout": (dict(verbose=1, regout=True), "Q1:QE:5Z:SA"),
    "undecmess": (dict(verbose=2, jsonout=True, undecmess=True), None),
    "grndmess": (dict(verbose=1, jsonout=True, grndmess=True,
                      emptymess=True, station_id="é"), None),
}


@pytest.mark.parametrize("setting", sorted(_DECODER_SETTINGS))
def test_frame_decoder_output_equals_original(setting):
    """The port's FrameDecoder, which runs the rewritten host modules, prints
    what the JAX package's prints, to the byte, on a seeded corpus of 1200
    frames, and keeps the same counts and flight table."""
    import io
    from dataclasses import asdict

    from vdlm2dec_tpu.host import checkpoint as jcheckpoint
    from vdlm2dec_tpu.host import decoder as jdecoder
    from vdlm2dec_tpu.host import output as joutput
    from vdlm2dec_tpu_torch.host import decoder, output

    kw, labels = _DECODER_SETTINGS[setting]
    logs = io.StringIO(), io.StringIO()
    mine = decoder.FrameDecoder(output.OutputConfig(logfile=logs[0], **kw),
                                labels, time_base=0.0)
    theirs = jdecoder.FrameDecoder(joutput.OutputConfig(logfile=logs[1], **kw),
                                   labels, time_base=0.0)
    bursts = _decoder_corpus()
    for b in bursts:
        assert mine.process_burst(b) == theirs.process_burst(b)
    assert logs[0].getvalue() == logs[1].getvalue()
    assert len(logs[0].getvalue()) > 2_000
    assert asdict(mine.stats) == asdict(theirs.stats)
    st = mine.stats
    assert min(st.acars, st.xid, st.filtered, st.undecoded) > 0, st
    assert [jcheckpoint._flight_to_dict(f) for f in mine.flights.flights()] == \
        [jcheckpoint._flight_to_dict(f) for f in theirs.flights.flights()]
