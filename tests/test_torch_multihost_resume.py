"""The PyTorch port's multi-host worker on the CPU: --checkpoint resume
(exactly once, on the frames and the json surface), the resume point at the
slowest host's cursor, the SIGTERM drain and the checkpoint's geometry
guard, over 2 gloo processes x 4 shards (counterparts of
tests/test_multihost.py::test_worker_checkpoint_resume_exactly_once).
"""
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from vdlm2dec_tpu.io.sdr import write_capture

from test_torch_multihost_surface import (MESH_ARGS, _cpu, _frame_lines,
                                          _json_lines, _wide)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def five_windows(tmp_path_factory):
    """One ACARS burst per 0.25 s window, one just before the window-2/3
    seam."""
    starts = (3000, 25_000, 46_500, 62_700, 88_000)
    cap = str(tmp_path_factory.mktemp("tmh_ckpt") / "mh_ckpt.cu8")
    write_capture(cap, _wide([(f"CKPT{st}", st) for st in starts],
                             5 * 250 * 2000, 41), "cu8")
    return ["--iq", cap, "--fc", "136900000", "136.975", *MESH_ARGS,
            "--block-seconds", "0.25"]


@pytest.fixture(scope="module")
def uninterrupted(five_windows):
    """The FRAME lines of the uninterrupted two-process job: five, each
    once (one process prints the same lines: tests/test_torch_multihost.py)."""
    ref = _frame_lines(_cpu(2, five_windows))
    assert len(ref) == 5 and set(ref.values()) == {1}
    return ref


@pytest.mark.parametrize("surface", ["frames", "json"])
def test_worker_checkpoint_resume_exactly_once(five_windows, uninterrupted,
                                               tmp_path, surface):
    """Abort a 2-process windowed decode after window 1 (per-host
    checkpoints written), relaunch with the same checkpoint: both runs'
    lines together equal an uninterrupted run's, each exactly once; a
    further restart prints nothing.  On the json surface the checkpoint
    carries the flight tracker too."""
    base, lines, ref = five_windows, _frame_lines, uninterrupted
    if surface == "json":
        base = [*base, "--output", "json", "--start-time", "1e9"]
        lines = _json_lines
        ref = lines(_cpu(2, base))
        assert len(ref) == 5 and set(ref.values()) == {1}
    ckpt = str(tmp_path / "ckpt")

    part1 = lines(_cpu(2, [*base, "--checkpoint", ckpt,
                           "--abort-after-window", "1"]))
    assert part1          # windows 0-1 hold at least the first burst
    assert os.path.exists(ckpt + ".p0") and os.path.exists(ckpt + ".p1")
    part2 = lines(_cpu(2, [*base, "--checkpoint", ckpt]))
    assert part2 and part1 + part2 == ref
    assert not lines(_cpu(2, [*base, "--checkpoint", ckpt]))


def test_worker_resumes_at_the_slowest_host(five_windows, uninterrupted,
                                            tmp_path):
    """Host 0's checkpoint is one window behind host 1's: both replay from
    the minimum cursor (the exchanges must pair up); host 0 emits its
    window 1 again, host 1 prints nothing twice, nothing is lost."""
    ckpt, other = str(tmp_path / "ckpt"), str(tmp_path / "other")
    part1 = _cpu(2, [*five_windows, "--checkpoint", ckpt,
                     "--abort-after-window", "1"])
    behind = _cpu(2, [*five_windows, "--checkpoint", other,
                      "--abort-after-window", "0"])
    os.replace(other + ".p0", ckpt + ".p0")
    part2 = _cpu(2, [*five_windows, "--checkpoint", ckpt])
    again = _frame_lines(part1[:1]) - _frame_lines(behind[:1])
    assert sum(again.values()) == 1       # the burst at 25000, host 0's
    assert _frame_lines(part1) + _frame_lines(part2) == uninterrupted + again


def test_worker_sigterm_drains_and_resumes_exactly_once(five_windows,
                                                        uninterrupted,
                                                        tmp_path):
    """SIGTERM once the first FRAME line is out: the worker finishes the
    windows it has dispatched, checkpoints and exits 0; the rerun prints
    the rest, and the two outputs hold every frame exactly once."""
    argv = [sys.executable, "-m", "vdlm2dec_tpu_torch.parallel.multihost",
            "--device", "cpu", "--local-devices", ",".join(["cpu"] * 8),
            *five_windows, "--checkpoint", str(tmp_path / "ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out_path = tmp_path / "part1.txt"
    with open(out_path, "wb") as out:
        p = subprocess.Popen(argv, stdout=out, stderr=subprocess.PIPE, env=env,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))
        try:
            deadline = time.monotonic() + 120
            while (b"FRAME " not in out_path.read_bytes()
                   and p.poll() is None and time.monotonic() < deadline):
                time.sleep(0.02)
            p.send_signal(signal.SIGTERM)
            _, err = p.communicate(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert p.returncode == 0, err.decode()[-2000:]
    part1 = out_path.read_text()
    assert part1.splitlines()[-1].startswith("DONE 0 ")
    part2 = _cpu(1, [*five_windows, "--checkpoint", str(tmp_path / "ckpt")])
    assert _frame_lines([part1]) + _frame_lines(part2) == uninterrupted


def test_checkpoint_refuses_another_geometry(five_windows, tmp_path):
    """A checkpoint written under one frequency plan is not resumed under
    another: the worker exits with the guard's message."""
    ckpt = str(tmp_path / "ckpt")
    _cpu(1, [*five_windows, "--checkpoint", ckpt, "--abort-after-window", "0"])
    other = [a if a != "136.975" else "136.950" for a in five_windows]
    with pytest.raises(RuntimeError, match="different job geometry"):
        _cpu(1, [*other, "--checkpoint", ckpt])
