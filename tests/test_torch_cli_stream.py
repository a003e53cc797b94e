"""The port's CLI on the CPU: -j, live input (--iq -), --checkpoint,
SIGTERM and the SDR device flags.

As tests/test_torch_cli_modes.py: the port's CLI runs with jax blocked
on the 0.6 s captures of tests/test_torch_cli.py and must print what
the JAX CLI prints for the same flags: -j to a loopback socket, and
--iq - from stdin on both live branches.  Also the port's twins of the
JAX CLI's --checkpoint kill-and-resume
(tests/test_checkpoint_metrics.py), SIGTERM drain and -g/-r/-k checks
(tests/test_cli_stream.py).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from test_torch_cli import (  # noqa: F401  (fixtures)
    ARGS,
    REPO,
    TEXTS,
    _run_port_cli,
    cap,
    caps,
)
from test_torch_cli_modes import _jax_cli, _lines
from vdlm2dec_tpu.host.checkpoint import load_checkpoint
from vdlm2dec_tpu.host.flights import FlightTracker
from vdlm2dec_tpu.io.sdr import write_capture
from vdlm2dec_tpu_torch.metrics import PipelineMetrics


def test_port_cli_udp_json_matches_jax_cli(cap, capsys, monkeypatch):
    """-j addr:port sends each JSON line as one UDP datagram (to a
    socket of this process on the loopback), as the JAX CLI does."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        sock.settimeout(60)
        argv = ["--iq", cap, *ARGS, "-j",
                f"127.0.0.1:{sock.getsockname()[1]}"]
        r = _run_port_cli([*argv, "--device", "cpu"])
        assert r.returncode == 0, r.stderr[-2000:]
        got = [sock.recv(65536) for _ in TEXTS]
        rc, out, _err = _jax_cli(argv, capsys, monkeypatch)
        assert rc == 0
        want = [sock.recv(65536) for _ in TEXTS]
    assert got == want
    assert [g.decode() for g in got] == [ln + "\n" for ln in _lines(r.stdout)]
    assert sorted(json.loads(g)["text"] for g in got) == TEXTS


@pytest.mark.parametrize("flags", [[], ["--channel-filter", "fir"],
                                   ["--pallas", "--format", "cs16"]])
def test_port_cli_live_stdin_matches_jax_cli(caps, flags, capsys,
                                             monkeypatch):
    """--iq - with the capture on stdin: the fused live branch (cu8), and
    the host-conversion branch (FIR; --pallas on cs16).  The JAX CLI
    reads the same bytes; the fused branch also prints the file run's
    lines."""
    fmt = "cs16" if "cs16" in flags else "cu8"
    argv = ["--iq", "-", *ARGS, *flags]
    with open(caps[fmt], "rb") as fh:
        r = _run_port_cli([*argv, "--device", "cpu"], stdin=fh)
    assert r.returncode == 0, r.stderr[-2000:]
    rc, want, _err = _jax_cli(argv, capsys, monkeypatch, stdin_path=caps[fmt])
    assert rc == 0
    assert _lines(r.stdout) == _lines(want)
    assert sorted(json.loads(ln)["text"] for ln in _lines(want)) == TEXTS
    if not flags:
        rc, filed, _err = _jax_cli(["--iq", caps[fmt], *ARGS], capsys,
                                   monkeypatch)
        assert _lines(r.stdout) == _lines(filed)


@pytest.mark.parametrize("flags", [[], ["--channel-filter", "fir"]])
def test_port_cli_kill_and_resume_byte_identical(cap, flags, tmp_path, capsys,
                                                 monkeypatch):
    """The twin of tests/test_checkpoint_metrics.py's resume test on the
    port: interrupted after block 1 of 4, resumed from --checkpoint, the
    two outputs concatenate to the uninterrupted run's, on the fused
    route and on stream_wideband (FIR)."""
    from vdlm2dec_tpu_torch import cli

    base = ["136.975", "136.725", "--iq", cap, "--fc", "136900000",
            "--max-rows", "1", "--block-seconds", "0.15",
            "--start-time", "1700000000", "-U", "-E", "-G",
            "--device", "cpu", *flags]

    def run(argv):
        capsys.readouterr()
        assert cli.main(argv) == 0
        return capsys.readouterr().out

    full = run(base)
    assert full.count("[#") == 2                  # bursts in blocks 0 and 1
    ck = str(tmp_path / "state.ckpt")
    calls = {"n": 0}
    orig = PipelineMetrics.observe_bursts

    def boom(self, bursts):
        if calls["n"] == 1:
            raise KeyboardInterrupt
        calls["n"] += 1
        return orig(self, bursts)

    monkeypatch.setattr(PipelineMetrics, "observe_bursts", boom)
    part1 = run([*base, "--checkpoint", ck])
    monkeypatch.setattr(PipelineMetrics, "observe_bursts", orig)
    cursor, extra = load_checkpoint(ck, FlightTracker())
    assert cursor == 300_000                      # block-aligned
    assert extra["prev_end"]
    part2 = run([*base, "--checkpoint", ck])
    assert part1.count("[#") == part2.count("[#") == 1
    assert part1 + part2 == full


def test_port_cli_sigterm_drains_and_exits(tmp_path):
    """The twin of tests/test_cli_stream.py's SIGTERM test: the port's
    CLI without jax, live on stdin that stays open, decodes the burst
    (its --stats-interval report on stderr counts the CRC-valid frame),
    then on SIGTERM drains, writes the frame to its log file and exits
    0."""
    from vdlm2dec_tpu import framegen as fg
    from vdlm2dec_tpu import modulator as mod

    rng = np.random.default_rng(6)
    fs, freq, fc = 2_000_000, 136_975_000, 136_900_000
    content = fg.acars_frame(text="TERM TEST", label="Q0")
    bb = mod.synthesize_baseband(mod.make_burst([content]), start=2500,
                                 total=3 * 8400)
    wide = mod.upsample_to_wideband(bb, fs, freq - fc) * 40.0
    wide += rng.normal(size=len(wide)) + 1j * rng.normal(size=len(wide))
    cap_path = tmp_path / "term.cu8"
    write_capture(str(cap_path), wide, "cu8")
    log = tmp_path / "term.log"
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from vdlm2dec_tpu_torch import cli\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "136.975", "--iq", "-", "--fc", str(fc),
         "--max-rows", "2", "--block-seconds", "0.2", "-J", "-l", str(log),
         "--stats-interval", "1e-9", "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, cwd=REPO)
    decoded = threading.Event()
    err_lines = []

    def watch_stderr():
        for raw in proc.stderr:
            line = raw.decode()
            err_lines.append(line)
            if line.startswith("{") and json.loads(line)["frames_crc_ok"]:
                decoded.set()

    watcher = threading.Thread(target=watch_stderr, daemon=True)
    watcher.start()
    try:
        # idle samples after the burst give its block the right margin
        # while stdin stays open
        proc.stdin.write(cap_path.read_bytes() + b"\x7f" * (2 * fs))
        proc.stdin.flush()
        assert decoded.wait(timeout=120), "".join(err_lines)[-2000:]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        proc.kill()
        proc.wait()
        watcher.join(timeout=10)
    assert not watcher.is_alive()
    assert rc == 0, "".join(err_lines)[-2000:]
    lines = _lines(log.read_text())
    assert len(lines) == 1
    assert json.loads(lines[0])["text"] == "TERM TEST"


def test_live_stdin_reads_whole_blocks_and_polls():
    """cli._LiveStdin.read(n): n bytes across short pipe reads, the rest
    at end of stream, then b""; while the pipe is quiet it returns to the
    interpreter every POLL_S, which is when the main thread runs the
    handler of a signal that the OS delivered to another thread."""
    from vdlm2dec_tpu_torch import cli

    r, w = os.pipe()
    live = cli._LiveStdin(r)
    polls = []
    real_select = cli.select.select

    def counting_select(*args):
        polls.append(args[3])
        return real_select(*args)

    def feed():
        for part in (b"ab", b"cdef", b"g"):
            threading.Event().wait(0.3)
            os.write(w, part)
        os.close(w)

    th = threading.Thread(target=feed)
    cli.select.select = counting_select
    try:
        th.start()
        assert live.read(5) == b"abcde"
        assert live.read(5) == b"fg"
        assert live.read(5) == b""
    finally:
        cli.select.select = real_select
        th.join(timeout=10)
        os.close(r)
    assert not th.is_alive()
    assert len(polls) >= 4 and set(polls) == {cli._LiveStdin.POLL_S}


SDR_CASES = [
    ["-r", "zzz", "--devices", "serial1,serial2"],
    ["-k", "notahex"],
    ["--format", "f32real", "-g", "30"],
    ["-v", "-g", "90", "-r", "serial2", "--devices", "serial1,serial2",
     "-k", "0xA74068C82F2E3793"],
    ["-v", "--format", "f32real", "-g", "12"],
]


@pytest.mark.parametrize("flags", SDR_CASES)
def test_port_cli_sdr_flags_match_jax_cli(flags, capsys, monkeypatch):
    """-g/-r/-k (and --devices): the JAX CLI's validation, exit code and
    messages, its verbose prints included; on a missing capture file
    both then exit 1."""
    from vdlm2dec_tpu_torch import cli

    argv = ["136.975", "--iq", "/nonexistent/cap.cu8", "--fc", "136900000",
            *flags]
    capsys.readouterr()
    rc_port = cli.main([*argv, "--device", "cpu"])
    err_port = capsys.readouterr().err
    rc, _out, err = _jax_cli(argv, capsys, monkeypatch)
    assert rc_port == rc == 1
    assert err_port == err != ""
