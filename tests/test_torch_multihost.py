"""The PyTorch port's multi-process decode on the CPU: 2 real processes x 4
shards over torch.distributed (gloo), against one process and against the
JAX package's worker.

A global (chan=1, time=8) mesh spans two processes; the halos at the
process seam travel as point-to-point messages; each process emits the
frames whose triggers lie in its own shards.  A burst whose demod window
CROSSES the process boundary must decode exactly as in a single-process
run of the same mesh, and as the JAX worker decodes it.  The worker's
output surface (json, text, UDP, formats) is in
tests/test_torch_multihost_surface.py, checkpoints and the SIGTERM drain
in tests/test_torch_multihost_resume.py.
"""
import re

import numpy as np
import pytest
import torch

from vdlm2dec_tpu import modulator as mod
from vdlm2dec_tpu.io.sdr import write_capture
from vdlm2dec_tpu.parallel.multihost import launch_local as jax_launch_local
from vdlm2dec_tpu_torch.parallel import multihost as tmh
from vdlm2dec_tpu_torch.parallel.multihost import launch_local

torch.set_num_threads(1)

N_TIME = 8
T_SHARD = 4200
T_TOTAL = N_TIME * T_SHARD           # 33600 decimated samples, 0.4 s
SEAM = T_TOTAL // 2                  # process boundary (shards 0-3 | 4-7)


def _frames(outs):
    """(all frames, frames per process); a frame printed twice fails."""
    got = set()
    by_proc = []
    for out in outs:
        fr = []
        for line in out.splitlines():
            m = re.match(r"FRAME (\d+) (\d+) ([0-9a-f]+)", line)
            if m:
                fr.append((int(m.group(1)), int(m.group(2)), m.group(3)))
        assert len(fr) == len(set(fr))
        assert not got & set(fr)          # each frame from one process only
        by_proc.append(set(fr))
        got |= set(fr)
    return got, by_proc


def _cpu(n, worker_args, local_devices=4, **kw):
    return launch_local(n, worker_args, local_devices=local_devices,
                        device="cpu", timeout=300, **kw)


@pytest.fixture(scope="module")
def seam_capture(tmp_path_factory):
    rng = np.random.default_rng(7)
    contents = [rng.integers(0, 256, 30).astype(np.uint8),
                rng.integers(0, 256, 40).astype(np.uint8),
                rng.integers(0, 256, 25).astype(np.uint8)]
    # burst 1 inside p0; burst 2 triggers just BEFORE the process seam so
    # its demod window needs p1's samples; burst 3 inside p1
    starts = [3000, SEAM - 500, SEAM + 9000]
    sig = np.zeros(T_TOTAL, dtype=np.complex128)
    for st, c in zip(starts, contents):
        sig += mod.synthesize_baseband(mod.make_burst([c]), start=st,
                                       total=T_TOTAL)
    sig = mod.awgn(sig, 15.0, rng)
    y = np.stack([sig, sig]).astype(np.complex64)     # 2 channels
    path = tmp_path_factory.mktemp("tmh") / "y.npy"
    np.save(path, y)
    return str(path)


SEAM_ARGS = ["--time-shards", str(N_TIME), "--max-symbols", "512",
             "--max-candidates", "4"]


@pytest.fixture(scope="module")
def seam_two_process(seam_capture):
    return _cpu(2, ["--y-npy", seam_capture, *SEAM_ARGS])


@pytest.fixture(scope="module")
def seam_one_process(seam_capture):
    return _cpu(1, ["--y-npy", seam_capture, *SEAM_ARGS], local_devices=8)


def test_two_process_seam_matches_single_process(seam_one_process,
                                                 seam_two_process):
    frames2, by_proc = _frames(seam_two_process)
    frames1, _ = _frames(seam_one_process)
    # all three bursts decode on both channels
    assert len(frames1) == 6
    # bit-identical across the process count
    assert frames2 == frames1
    # ownership: the seam burst's trigger is in p0's last shard, so p0
    # emits it (demodulated from p1's halo samples)
    seam_frames = {f for f in frames2 if SEAM - 600 < f[1] < SEAM}
    assert seam_frames and seam_frames <= by_proc[0]
    # p1 emits the burst in its own region
    assert any(f[1] > SEAM for f in by_proc[1])
    assert [o.splitlines()[-1].split()[:2] for o in seam_two_process] == \
        [["DONE", "0"], ["DONE", "1"]]


def test_two_process_seam_matches_the_jax_worker(seam_capture,
                                                 seam_two_process):
    """The same .npy through the JAX package's two-process job (4 virtual
    CPU devices each): the same FRAME lines from the same process."""
    want = jax_launch_local(2, ["--y-npy", seam_capture, *SEAM_ARGS],
                            local_devices=4)
    frames_j, by_proc_j = _frames(want)
    frames_t, by_proc_t = _frames(seam_two_process)
    assert len(frames_j) == 6
    assert frames_t == frames_j and by_proc_t == by_proc_j


def test_chan_shards_two_process(seam_capture, seam_one_process):
    """A (chan=2, time=4) global mesh: two shards down each time column,
    two columns a process; the same frames with global channel numbers."""
    outs = _cpu(2, ["--y-npy", seam_capture, "--chan-shards", "2",
                    "--time-shards", "4", "--max-symbols", "512",
                    "--max-candidates", "4"])
    frames, by_proc = _frames(outs)
    assert len(frames) == 6 and {f[0] for f in frames} == {0, 1}
    assert frames == _frames(seam_one_process)[0]


@pytest.fixture(scope="module")
def window_capture(tmp_path_factory):
    """6 windows of 0.25 s at 2 Msps, a burst every 9000 decimated samples
    (the one at 20500 runs across the first window boundary at 21000)."""
    rng = np.random.default_rng(23)
    fs = 2_000_000
    t_raw = 6 * 250 * 2000
    total_dec = t_raw * 84 // 2000
    sig = np.zeros(total_dec, dtype=np.complex128)
    starts = list(range(2500, total_dec - 3000, 9000))
    for st in starts:
        c = rng.integers(0, 256, 25).astype(np.uint8)
        sig += mod.synthesize_baseband(mod.make_burst([c]), start=st,
                                       total=total_dec)
    wide = mod.upsample_to_wideband(sig, fs, 75_000.0, total=t_raw) * 30
    wide += rng.normal(size=t_raw) + 1j * rng.normal(size=t_raw)
    cap = str(tmp_path_factory.mktemp("tmh_win") / "mh_depth.cu8")
    write_capture(cap, wide, "cu8")
    return cap, len(starts)


def _window_args(cap):
    return ["--iq", cap, "--fc", "136900000", "136.975",
            "--time-shards", "8", "--max-symbols", "512",
            "--max-candidates", "8"]


@pytest.fixture(scope="module")
def windowed_runs(window_capture):
    """The windowed two-process job at dispatch depth 1, 2 and 3."""
    cap, _n = window_capture
    return {depth: _cpu(2, [*_window_args(cap), "--block-seconds", "0.25",
                            "--dispatch-depth", str(depth), "--timing"])
            for depth in (1, 2, 3)}


def test_windowed_streaming_matches_oneshot(window_capture, windowed_runs):
    """--block-seconds streams overlapping windows across the mesh; a
    burst near a window boundary decodes exactly as in the one-shot decode
    of the whole capture, and once."""
    cap, n_bursts = window_capture
    oneshot, _ = _frames(_cpu(2, _window_args(cap)))
    streamed, _ = _frames(windowed_runs[2])
    assert len(oneshot) == n_bursts
    assert streamed == oneshot


def test_dispatch_depth_frame_parity(windowed_runs):
    """--dispatch-depth deepens the in-flight window pipeline; it must not
    change WHAT is decoded.  Depth 1 (fetch before the next dispatch), 2
    (the default) and 3 print the same FRAME lines."""
    got = {d: _frames(outs)[0] for d, outs in windowed_runs.items()}
    assert got[1] and got[1] == got[2] == got[3]


def test_depth_three_over_two_processes_finishes(windowed_runs):
    """With three windows in flight per process every exchange still pairs
    up in dispatch order: both workers run to DONE, and each reports its
    timed windows (all but the warm-up window)."""
    import json

    for pid, out in enumerate(windowed_runs[3]):
        lines = out.splitlines()
        assert lines[-1].startswith(f"DONE {pid} ")
        stats = json.loads([ln for ln in lines
                            if ln.startswith("STATS ")][0][6:])
        assert stats["pid"] == pid and stats["timed_windows"] == 5
        assert stats["global_samples_per_window"] == 250 * 2000
        assert set(stats["phase_s"]) == {"channelize", "collective_decode",
                                         "finish"}


def test_windowed_job_matches_the_jax_worker(window_capture, windowed_runs):
    """The windowed raw-ingest job (each shard channelizes its own raw
    planes) prints the JAX worker's FRAME lines."""
    cap, n_bursts = window_capture
    want, _ = _frames(jax_launch_local(
        2, [*_window_args(cap), "--block-seconds", "0.25"], local_devices=4))
    got, _ = _frames(windowed_runs[2])
    assert len(want) == n_bursts and got == want


def test_dft_channelizer_route_matches_raw_ingest(window_capture,
                                                  windowed_runs):
    """--chan-impl dft channelizes each process's slice once and shards
    the decimated block (no raw ingest): the same frames."""
    cap, _n = window_capture
    outs = _cpu(2, [*_window_args(cap), "--block-seconds", "0.25",
                    "--chan-impl", "dft"])
    assert _frames(outs)[0] == _frames(windowed_runs[2])[0]


def test_dispatches_in_flight_in_one_process():
    """Two windows dispatched before either is fetched (the depth-2
    pattern) give the candidates of the serial path, window by window."""
    rng = np.random.default_rng(5)
    t_total = 8 * 4200
    content = rng.integers(0, 256, 25).astype(np.uint8)
    sig = mod.synthesize_baseband(mod.make_burst([content]), start=9000,
                                  total=t_total)
    sig = (sig * 20 + rng.normal(size=t_total)
           + 1j * rng.normal(size=t_total)).astype(np.complex64)

    mesh = tmh.global_mesh(1, 8, ["cpu"] * 8)
    assert mesh.shape == (1, 8) and mesh.time_start == 0
    dec = tmh.MultiHostDecoder(mesh, max_candidates=2, max_symbols=512)
    out0 = dec.dispatch(sig[None, :])
    out1 = dec.dispatch(sig[None, ::-1].copy())
    c0 = dec.fetch(out0)
    c1 = dec.fetch(out1)
    frames0 = sorted((c["chan"], c["t0"]) for c in c0)
    assert any(8400 <= t0 < 12600 for _, t0 in frames0)
    assert frames0 != sorted((c["chan"], c["t0"]) for c in c1)
    serial = dec.decode_local(sig[None, :])
    assert sorted((c["chan"], c["t0"]) for c in serial) == frames0
    with pytest.raises(ValueError, match="raw_f_offsets"):
        dec.dispatch_raw(np.zeros((8 * 2000, 2), np.float32), 0)


def test_device_lists_per_worker(seam_capture, seam_two_process):
    """A worker's entry may be a comma list of devices, over which its
    shards are laid in turn: the seam job with one worker's four shards on
    a two-entry list prints the FRAME lines of the plain two-process job."""
    outs = launch_local(2, ["--y-npy", seam_capture, *SEAM_ARGS],
                        local_devices=4, device=["cpu,cpu", "cpu"],
                        timeout=300)
    assert _frames(outs) == _frames(seam_two_process)


class _FakeWorker:
    returncode = 0

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return 0


def test_launcher_gives_nccl_workers_their_cards(monkeypatch):
    """Two workers x two cards over nccl: each worker is started with its
    own cards, its four shards laid over them in turn, the first its
    --device; a card in two workers' lists is refused ("cuda" is a
    worker's first card) before anything starts."""
    import subprocess

    cmds = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: cmds.append(cmd) or _FakeWorker())
    outs = launch_local(2, ["--iq", "cap.cu8"], local_devices=4,
                        device=["cuda:0,cuda:1", "cuda:2,cuda:3"],
                        backend="nccl")
    assert outs == ["", ""]

    def flag(cmd, name):
        return cmd[cmd.index(name) + 1]

    assert [flag(c, "--device") for c in cmds] == ["cuda:0", "cuda:2"]
    assert [flag(c, "--local-devices") for c in cmds] == [
        "cuda:0,cuda:1,cuda:0,cuda:1", "cuda:2,cuda:3,cuda:2,cuda:3"]
    assert [flag(c, "--backend") for c in cmds] == ["nccl", "nccl"]
    assert [c[-2:] for c in cmds] == [["--iq", "cap.cu8"]] * 2
    cmds.clear()
    for devices, card in ((["cuda:0,cuda:1", "cuda:1,cuda:2"], "cuda:1"),
                          (["cuda", "cuda:0"], "cuda:0")):
        with pytest.raises(ValueError, match=f"{card} is in two"):
            launch_local(2, [], device=devices, backend="nccl")
    assert cmds == []
    # gloo lets workers share a card
    launch_local(2, [], local_devices=1, device=["cuda:0", "cuda:0"],
                 backend="gloo")
    assert len(cmds) == 2


def test_launcher_fails_fast_and_leaves_no_worker(tmp_path):
    """A worker that exits non-zero raises with its stderr; nccl on a
    shared device is refused before anything starts."""
    with pytest.raises(RuntimeError, match="worker failed"):
        _cpu(2, ["--y-npy", str(tmp_path / "missing.npy"), *SEAM_ARGS])
    with pytest.raises(ValueError, match="cuda:0 is in two"):
        launch_local(2, [], device="cuda:0", backend="nccl")
    with pytest.raises(ValueError, match="3 devices for 2 workers"):
        launch_local(2, [], device=["cpu"] * 3)
