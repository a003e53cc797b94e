"""The PyTorch port's CLI, and its independence from jax.

The machine with the CUDA card has no jax, so the port must import and
decode with jax blocked (sys.modules["jax"] = None): a subprocess runs the
port's CLI that way on the CPU and its JSON lines must equal the JAX
CLI's on the same capture, for both sync modes, every channelizer route
(--pallas with JAX's Pallas kernel in interpret mode, --chan-impl matmul
and pfb) and every capture format (cs16, cf32, f32real at 6 Msps).  The
other flags are in tests/test_torch_cli_modes.py.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vdlm2dec_tpu import framegen as fg
from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.io.sdr import write_capture
from vdlm2dec_tpu.ops import pallas_channelizer as jpallas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC = 136_900_000


TEXTS = ["PORT CLI ONE", "PORT CLI TWO"]


def _wide(fs: int, fc: int, total: int, seed: int) -> np.ndarray:
    """Two ACARS bursts on two channels (TEXTS), as complex baseband
    around fc at fs, plus unit noise."""
    rng = np.random.default_rng(seed)
    wide = np.zeros(total, np.complex128)
    for freq, text, start in ((136_975_000, TEXTS[0], 900),
                              (136_725_000, TEXTS[1], 20_000)):
        plan = mod.make_burst([fg.acars_frame(text=text, label="Q0")])
        bb = mod.synthesize_baseband(plan, start=start,
                                     total=total * 84_000 // fs)
        wide += mod.upsample_to_wideband(bb, fs, freq - fc, total=total) * 40
    return wide + rng.normal(size=total) + 1j * rng.normal(size=total)


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """0.6 s of the two bursts as cu8, cs16 and cf32 at 2 Msps, and as an
    airspy f32real capture 2 Re{wide} at 6 Msps around F0 = FC, tuned to
    FC - 1.5 MHz (offsets +75 and -175 kHz: the conjugate images fall
    outside both channels)."""
    d = tmp_path_factory.mktemp("cli")
    wide = _wide(2_000_000, FC, 1_200_000, 4)
    paths = {}
    for fmt in ("cu8", "cs16", "cf32"):
        paths[fmt] = str(d / f"cap.{fmt}")
        write_capture(paths[fmt], wide, fmt)
    paths["f32real"] = str(d / "cap.f32")
    write_capture(paths["f32real"], 2 * _wide(6_000_000, FC, 3_600_000, 5).real,
                  "f32real")
    return paths


@pytest.fixture(scope="module")
def cap(caps):
    return caps["cu8"]


ARGS = ["136.975", "136.725", "--fc", str(FC), "--max-rows", "1",
        "--block-seconds", "0.25", "-J", "-i", "TESTSTN",
        "--start-time", "1700000000"]


def _run_port_cli(argv, stdin=None):
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from vdlm2dec_tpu_torch import cli\n"
            "rc = cli.main(sys.argv[1:])\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'jax'"
            " and sys.modules[m] is not None]\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", code, *argv], env=env,
                          stdin=stdin, capture_output=True, text=True,
                          timeout=300, cwd=REPO)


def _assert_port_cli_matches_jax_cli(argv, capsys):
    r = _run_port_cli([*argv, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    got = [l for l in r.stdout.splitlines() if l.strip()]

    from vdlm2dec_tpu.cli import main as jax_main

    capsys.readouterr()
    assert jax_main(argv) == 0
    want = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert got == want
    texts = sorted(json.loads(l)["text"] for l in got)
    assert texts == TEXTS


@pytest.mark.parametrize("sync_impl", ["stream", "fused"])
def test_port_cli_without_jax_matches_jax_cli(cap, sync_impl, capsys):
    argv = ["--iq", cap, "--sync-impl", sync_impl, *ARGS]
    _assert_port_cli_matches_jax_cli(argv, capsys)


ROUTES = {
    "pallas": ("cu8", ["--pallas"]),
    "matmul": ("cu8", ["--chan-impl", "matmul"]),
    "pfb": ("cu8", ["--chan-impl", "pfb"]),
    "cs16": ("cs16", ["--format", "cs16"]),
    "cf32": ("cf32", ["--format", "cf32"]),
    "f32real": ("f32real", ["--format", "f32real", "--fs", "6000000",
                            "--fc", str(FC - 1_500_000)]),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_port_cli_route_matches_jax_cli(caps, route, capsys, monkeypatch):
    """The flags this port now runs: the port's CLI without jax prints
    the JAX CLI's JSON lines (JAX's Pallas kernel in interpret mode)."""
    fmt, flags = ROUTES[route]
    monkeypatch.setattr(jpallas, "channelize_u8_pallas", functools.partial(
        jpallas.channelize_u8_pallas, interpret=True))
    argv = ["--iq", caps[fmt], *ARGS, *flags]
    _assert_port_cli_matches_jax_cli(argv, capsys)


@pytest.mark.parametrize("flags", [
    ["--pallas", "--chan-impl", "dft"],
    ["--chan-impl", "pfb", "--channel-filter", "fir"],
])
def test_port_cli_refuses_as_jax_cli(cap, flags, capsys):
    """The JAX CLI's early refusals: exit 1 and the same message."""
    from vdlm2dec_tpu.cli import main as jax_main
    from vdlm2dec_tpu_torch import cli

    argv = ["136.975", "--iq", cap, *flags]
    assert cli.main([*argv, "--device", "cpu"]) == 1
    got = capsys.readouterr().err
    assert jax_main(argv) == 1
    assert got == capsys.readouterr().err != ""


def test_port_cli_mesh_matches_jax_cli(cap, capsys):
    """--mesh 2x2: the port builds its mesh from the CPU (the caller asks
    for it), the JAX CLI from its virtual CPU devices; both then stream
    through the host-converted route and print the same lines."""
    argv = ["--iq", cap, "--mesh", "2x2", *ARGS]
    _assert_port_cli_matches_jax_cli(argv, capsys)


@pytest.mark.parametrize("mesh,message", [
    ("2x4", "--mesh 2x4: need 8 devices, have 0"),
    ("1x1", "--mesh 1x1: need 1 devices, have 0"),
    ("two", "--mesh takes CxT"),
])
def test_port_cli_mesh_too_few_devices_is_refused(cap, mesh, message, capsys):
    """Without --device cpu the mesh is made of the visible CUDA cards:
    none here, so the CLI exits 1 and names the count (it does not fall
    back to the CPU); a flag that does not parse is refused the same way."""
    from vdlm2dec_tpu_torch import cli

    assert cli.main(["136.975", "--iq", cap, "--mesh", mesh]) == 1
    assert message in capsys.readouterr().err
