"""The PyTorch port's CLI, and its independence from jax.

The machine with the CUDA card has no jax, so the port must import and
decode with jax blocked (sys.modules["jax"] = None): a subprocess runs the
port's CLI that way on the CPU and its JSON lines must equal the JAX
CLI's on the same capture.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vdlm2dec_tpu import framegen as fg
from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.io.sdr import write_capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC = 136_900_000


@pytest.fixture(scope="module")
def cap(tmp_path_factory):
    """Two ACARS bursts on two channels, 0.6 s of 2 Msps cu8."""
    rng = np.random.default_rng(4)
    fs, total = 2_000_000, 1_200_000
    wide = np.zeros(total, np.complex128)
    for freq, text, start in ((136_975_000, "PORT CLI ONE", 900),
                              (136_725_000, "PORT CLI TWO", 20_000)):
        plan = mod.make_burst([fg.acars_frame(text=text, label="Q0")])
        bb = mod.synthesize_baseband(plan, start=start,
                                     total=total * 84_000 // fs)
        wide += mod.upsample_to_wideband(bb, fs, freq - FC, total=total) * 40
    wide += rng.normal(size=total) + 1j * rng.normal(size=total)
    path = tmp_path_factory.mktemp("cli") / "cap.cu8"
    write_capture(str(path), wide, "cu8")
    return str(path)


ARGS = ["136.975", "136.725", "--fc", str(FC), "--max-rows", "1",
        "--block-seconds", "0.25", "-J", "-i", "TESTSTN",
        "--start-time", "1700000000"]


def _run_port_cli(argv):
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
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)


@pytest.mark.parametrize("sync_impl", ["stream", "fused"])
def test_port_cli_without_jax_matches_jax_cli(cap, sync_impl, capsys):
    argv = ["--iq", cap, "--sync-impl", sync_impl, *ARGS]
    r = _run_port_cli([*argv, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    got = [l for l in r.stdout.splitlines() if l.strip()]

    from vdlm2dec_tpu.cli import main as jax_main

    capsys.readouterr()
    assert jax_main(argv) == 0
    want = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert got == want
    texts = sorted(json.loads(l)["text"] for l in got)
    assert texts == ["PORT CLI ONE", "PORT CLI TWO"]


@pytest.mark.parametrize("flag", [
    ["--pallas"], ["--chan-impl", "pfb"], ["--chan-impl", "matmul"],
    ["--channel-filter", "fir"], ["--compute", "bf16"], ["--mesh", "1x4"],
    ["--checkpoint", "ck.json"], ["--format", "cs16"], ["--sync-impl", "xla"],
])
def test_port_cli_refuses_unported_flags(flag, capsys):
    from vdlm2dec_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["136.975", "--iq", "cap.cu8", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not supported by the PyTorch backend" in capsys.readouterr().err


def test_port_cli_refuses_live_input(capsys):
    from vdlm2dec_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["136.975", "--iq", "-", "--device", "cpu"])
    assert "--iq -" in capsys.readouterr().err
