"""The port's (chan, time) mesh and multi-host worker on CUDA cards.

This file imports no jax, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_cuda_mesh.py

Every test is marked `cuda` and skips without a card (the NCCL one below
four cards).  On one card: a 1 x 2 and a 2 x 1 mesh give the packed rows
of the unsharded decode (a 1 x 1 mesh: one shard, no halo) with K1
launched once a shard, and two workers sharing the card over gloo print
the one-process job's FRAME lines.  On four: two NCCL workers with two
cards each print them too, windows in flight.
"""
import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch import stimulus
from vdlm2dec_tpu_torch.ops import sync
from vdlm2dec_tpu_torch.ops.channelizer import Channelizer
from vdlm2dec_tpu_torch.parallel.multihost import launch_local
from vdlm2dec_tpu_torch.parallel.sharding import ShardedDecoder, make_mesh

FS = 2_000_000
INT_WORDS = [0, 1, 2, 3, 4, 5, 6]          # chan, t0, length, .., live
# of / df on the same decimated input (tests/test_torch_sharding.py)
FLOAT_TOL = 1e-5


def _need_cards(n: int) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


@pytest.fixture(scope="module")
def capture():
    """2 channels x 1 s of the stimulus, and its decimated streams."""
    wide, freqs, fc, truth = stimulus.make_capture(FS, 2, 1.0)
    return stimulus.to_u8(wide), wide, freqs, fc, truth


def _live_rows(buf: np.ndarray) -> dict:
    meta = buf[:, 2048:].copy().view(np.int32)
    return {(int(r[0]), int(r[1])): i for i, r in enumerate(meta) if r[6]}


def _sharded_rows(mesh, y):
    dec = ShardedDecoder(mesh, max_candidates=32, max_symbols=512)
    bufs = []
    dec.decode(y, observer=bufs.append)
    return bufs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_mesh_on_one_card_matches_unsharded(capture, shape):
    _need_cards(1)
    _raw, wide, freqs, fc, _truth = capture
    ch = Channelizer([f - fc for f in freqs], fs=FS, device="cuda")
    y = ch.channelize(wide[: len(wide) // ch.p_in * ch.p_in])
    whole = _sharded_rows(make_mesh(1, 1, devices=["cuda:0"]), y)
    before = sync.launches["stream"]
    got = _sharded_rows(make_mesh(*shape, devices=["cuda:0"] * 2), y)
    assert sync.launches["stream"] - before == 2      # K1 once a shard
    want_rows, got_rows = _live_rows(whole), _live_rows(got)
    assert len(want_rows) > 0 and got_rows.keys() == want_rows.keys()
    wm = whole[:, 2048:].copy().view(np.int32)
    gm = got[:, 2048:].copy().view(np.int32)
    for key, i in want_rows.items():
        k = got_rows[key]
        np.testing.assert_array_equal(got[k, :2048], whole[i, :2048])
        np.testing.assert_array_equal(gm[k, INT_WORDS], wm[i, INT_WORDS])
        np.testing.assert_allclose(gm[k, 7:9].view(np.float32),
                                   wm[i, 7:9].view(np.float32),
                                   rtol=FLOAT_TOL, atol=FLOAT_TOL)


def _frame_lines(outs) -> list[str]:
    lines = [ln for out in outs for ln in out.splitlines()
             if ln.startswith("FRAME ")]
    assert len(lines) == len(set(lines))             # none twice
    return sorted(lines)


def _worker_args(tmp_path, capture, extra=()):
    raw, _wide, freqs, fc, _truth = capture
    path = str(tmp_path / "cap.cu8")
    raw.tofile(path)
    return [*(f"{f / 1e6:.6f}" for f in freqs), "--iq", path, "--fc",
            str(fc), "--max-symbols", "512", "--max-candidates", "32",
            *extra]


@pytest.mark.cuda
def test_gloo_workers_sharing_the_card(tmp_path, capture):
    _need_cards(1)
    args = _worker_args(tmp_path, capture, ["--time-shards", "2"])
    one = launch_local(1, args, local_devices=2, device="cuda:0")
    two = launch_local(2, args, local_devices=1,
                       device=["cuda:0", "cuda:0"], backend="gloo")
    assert len(_frame_lines(one)) > 0
    assert _frame_lines(two) == _frame_lines(one)


@pytest.mark.cuda
def test_nccl_two_workers_two_cards_each(tmp_path, capture):
    """Each worker's two shards on two cards of its own: the halos are
    staged on its first card and fanned out to the second only after the
    receive; windows in flight at depth 2."""
    _need_cards(4)
    args = _worker_args(tmp_path, capture,
                        ["--time-shards", "4", "--block-seconds", "0.25",
                         "--dispatch-depth", "2"])
    one = launch_local(1, args, local_devices=4, device="cuda:0")
    two = launch_local(2, args, local_devices=2,
                       device=["cuda:0,cuda:1", "cuda:2,cuda:3"],
                       backend="nccl")
    assert len(_frame_lines(one)) > 0
    assert _frame_lines(two) == _frame_lines(one)
