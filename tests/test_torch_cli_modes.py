"""The port's CLI on the CPU: the decode modes and the output flags.

A subprocess runs the port's CLI with jax blocked (sys.modules["jax"] =
None) on the 0.6 s captures of tests/test_torch_cli.py, and its output
must equal the JAX CLI's for the same flags: --sync-impl xla, --compute
bf16, --channel-filter fir, --pallas --format cs16 (the non-fused
route), -p, -R, -a, -b, and -l with --stats-interval.  The streaming,
network and device flags are in tests/test_torch_cli_stream.py.
"""
import functools
import json
import sys
import types

import pytest

from test_torch_cli import (  # noqa: F401  (fixtures)
    ARGS,
    TEXTS,
    _run_port_cli,
    cap,
    caps,
)
from vdlm2dec_tpu.ops import pallas_channelizer as jpallas


def _jax_cli(argv, capsys, monkeypatch, stdin_path=None):
    """The JAX CLI in-process: (exit code, stdout, stderr)."""
    from vdlm2dec_tpu.cli import main as jax_main

    monkeypatch.setattr(jpallas, "channelize_u8_pallas", functools.partial(
        jpallas.channelize_u8_pallas, interpret=True))
    capsys.readouterr()
    if stdin_path is None:
        rc = jax_main(argv)
    else:
        with open(stdin_path, "rb") as fh:
            monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=fh))
            rc = jax_main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


MODES = {
    "xla": ("cu8", ["--sync-impl", "xla"]),
    "bf16": ("cu8", ["--compute", "bf16"]),
    "bf16_pallas": ("cu8", ["--compute", "bf16", "--pallas"]),
    "fir": ("cu8", ["--channel-filter", "fir"]),
    "fir_bf16_xla": ("cu8", ["--channel-filter", "fir", "--compute", "bf16",
                             "--sync-impl", "xla"]),
    "pallas_cs16": ("cs16", ["--pallas", "--format", "cs16"]),
    "ppm": ("cu8", ["-p", "1.5"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_port_cli_mode_matches_jax_cli(caps, mode, capsys, monkeypatch):
    """The JSON lines of both decoded texts, identical to the JAX CLI's."""
    fmt, flags = MODES[mode]
    argv = ["--iq", caps[fmt], *ARGS, *flags]
    r = _run_port_cli([*argv, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    rc, want, _err = _jax_cli(argv, capsys, monkeypatch)
    assert rc == 0
    assert _lines(r.stdout) == _lines(want)
    assert sorted(json.loads(ln)["text"] for ln in _lines(want)) == TEXTS


OUTPUTS = {
    "route": ["-R"],                  # implies -J: route/registration JSON
    "reg": ["-J", "-a"],              # registration CSV; -a turns -J off
    "label_kept": ["-J", "-b", "Q0"],
    "label_dropped": ["-J", "-b", "H1:Q1"],
    "text": ["-U"],                   # the text block
}


@pytest.mark.parametrize("out", list(OUTPUTS))
def test_port_cli_output_flags_match_jax_cli(cap, out, capsys, monkeypatch):
    argv = ["--iq", cap, *[a for a in ARGS if a != "-J"], *OUTPUTS[out]]
    r = _run_port_cli([*argv, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    rc, want, _err = _jax_cli(argv, capsys, monkeypatch)
    assert rc == 0
    assert r.stdout == want
    assert (want.strip() == "") == (out == "label_dropped")


def test_port_cli_logfile_and_stats_interval(cap, tmp_path, capsys,
                                             monkeypatch):
    """-l appends the output to a file (stdout stays empty) and
    --stats-interval prints the metrics JSON to stderr while decoding."""
    logs = {name: tmp_path / f"{name}.log" for name in ("port", "jax")}
    for path in logs.values():
        path.write_text("earlier line\n")
    argv = ["--iq", cap, *ARGS, "--stats-interval", "1e-9"]
    r = _run_port_cli([*argv, "-l", str(logs["port"]), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    rc, out, _err = _jax_cli([*argv, "-l", str(logs["jax"])], capsys,
                             monkeypatch)
    assert rc == 0
    assert r.stdout == out == ""
    assert logs["port"].read_text() == logs["jax"].read_text()
    assert logs["port"].read_text().startswith("earlier line\n")
    assert len(_lines(logs["port"].read_text())) == 3
    reports = [json.loads(ln) for ln in _lines(r.stderr) if ln[0] == "{"]
    assert len(reports) >= 2                    # one per block at least
