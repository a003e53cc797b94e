"""The port's hand-written CUDA kernels against their plain versions.

This file imports no jax, so it also runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels.py

(--noconftest skips tests/conftest.py, which sets up jax for the other
test files).  Tests marked `cuda` skip without a CUDA card.
"""
import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch._tables import (aggregation_matrix, lo_tables,
                                        period_phases)
from vdlm2dec_tpu_torch.ops import chan_u8, sync
from vdlm2dec_tpu_torch.ops.ingest import DC_OFFSET

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

# the kernel runs the plain version's float32 operations in the same
# order; the tolerance is the one the JAX package holds its own two sync
# paths to (tests/test_fused_sync.py), kept in case an atan2 ulp differs
ERR_TOL = dict(rtol=1e-4, atol=1e-4)
FR_TOL = dict(rtol=1e-4, atol=1e-5)
# fused u8 channelizer, kernel against its plain version: |x lo| <= 181,
# each output sums ~24 (2 Msps) to ~72 (6 Msps) products, in ascending n
# in the kernel and in another order in the dense einsum
CHAN_U8_ATOL = 1e-3


def _stream(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (2,)).astype(np.float32) * 30


@pytest.mark.parametrize("mode", sync.MODES)
def test_cpu_tensor_takes_plain_version(mode):
    y = torch.from_numpy(_stream((2, 3000), 1))
    before = dict(sync.launches)
    err, fr = sync.sync_scan(y, mode)
    assert sync.launches == before
    ref = sync.sync_scan_stream_ref if mode == "stream" \
        else sync.sync_scan_fused_ref
    err_r, fr_r = ref(y)
    assert torch.equal(err, err_r) and torch.equal(fr, fr_r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 211_848), (3, 1_000), (1, 130),
                                   (2, 1_024), (1, 1_025), (5, 2_047),
                                   (1, 1), (64, 84_000), (76, 84_000),
                                   (760, 46_368), (2000, 21_000)])
@pytest.mark.parametrize("mode", sync.MODES)
def test_sync_kernel_matches_plain_on_card(mode, shape):
    """On a CUDA tensor the wrapper launches csrc/sync_scan.cu (one launch
    counted) and agrees with the plain version of its mode: at the 2 s
    block, at streams shorter than one 1024-position tile and than the
    sync window, at exactly one tile, one past it and one short of two,
    with a single channel, and at the wide plans' channel counts (64, 76,
    the 760-channel band's 0.5 s block with its margins, 2000 channels of
    0.25 s), where the channel count fills the grid's second dimension."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync kernel has no CPU mode")
    y = torch.tensor(_stream(shape, 3), device="cuda")
    before = sync.launches[mode]
    err, fr = sync.sync_scan(y, mode)
    torch.cuda.synchronize()
    assert sync.launches[mode] == before + 1
    ref = sync.sync_scan_stream_ref if mode == "stream" \
        else sync.sync_scan_fused_ref
    err_r, fr_r = ref(y)
    np.testing.assert_allclose(err.cpu().numpy(), err_r.cpu().numpy(),
                               **ERR_TOL)
    np.testing.assert_allclose(fr.cpu().numpy(), fr_r.cpu().numpy(), **FR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sync.MODES)
def test_sync_kernel_takes_strided_and_unaligned_views(mode):
    """The kernel reads (re, im) pairs as 8-byte words of a dense block; a
    view with other strides, or one that starts at an odd float, is
    copied first and gives the same bits as the dense tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync kernel has no CPU mode")
    y = torch.tensor(_stream((3, 5_000), 4), device="cuda")
    err, fr = sync.sync_scan(y, mode)
    wide = torch.zeros((3, 6_000, 2), device="cuda")
    wide[:, 500:5_500] = y
    strided = wide[:, 500:5_500]
    assert not strided.is_contiguous()
    flat = torch.cat([y.new_zeros(1), y.reshape(-1)])
    shifted = flat[1:].reshape(y.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 4
    for view in (strided, shifted):
        before = sync.launches[mode]
        err_v, fr_v = sync.sync_scan(view, mode)
        assert sync.launches[mode] == before + 1
        assert torch.equal(err_v, err) and torch.equal(fr_v, fr)


@pytest.mark.cuda
def test_stream_decode_on_second_card_matches_first():
    """With cuda:0 current, a decode on cuda:1 launches the kernel and
    copies its packed rows to the host on cuda:1's stream: the fetch
    waits for that copy, and the frames equal cuda:0's and the truth."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from vdlm2dec_tpu_torch import stimulus
    from vdlm2dec_tpu_torch._tables import PipelineConfig
    from vdlm2dec_tpu_torch.pipeline import Pipeline

    fs = 2_000_000
    wide, freqs, fc, truth = stimulus.make_capture(fs, 2, 1.0)
    raw = stimulus.to_u8(wide[: len(wide) - len(wide) % 2000])
    frames = {}
    for dev in ("cuda:0", "cuda:1"):
        cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=fs,
                             fc_hz=float(fc), max_candidates=16,
                             max_symbols=512, max_out=48)
        pipe = Pipeline(cfg, device=dev)
        before = sync.launches["stream"]
        frames[dev] = sorted(
            (b.channel, bytes(bytearray(f[1:-3])))
            for bs in pipe.stream_wideband_u8(raw, block_seconds=0.25)
            for b in bs for f in b.frames)
        assert sync.launches["stream"] > before
    assert torch.cuda.current_device() == 0
    assert frames["cuda:1"] == frames["cuda:0"] == \
        sorted((c, b) for c, b, *_ in truth)


def _chan_u8_inputs(n_chan, b, fs, lo_wrap, seed, device="cpu"):
    """Random cu8 bytes and the tables of a channel plan, as tensors."""
    rng = np.random.default_rng(seed)
    sdrclk = fs // 4000
    offs = tuple(float(25_000 * (3 * i - 7)) + (0.0 if lo_wrap else 1_300.0)
                 for i in range(n_chan))
    lo, _ = lo_tables(offs, fs, sdrclk, lo_wrap)
    ph = period_phases(offs, fs, sdrclk, lo_wrap, b, 5)
    raw = rng.integers(0, 256, b * 4 * sdrclk * 2).astype(np.uint8)
    arrays = (raw, lo.real, lo.imag, ph.real, ph.imag,
              aggregation_matrix(sdrclk))
    return [torch.tensor(np.ascontiguousarray(v), device=device)
            for v in arrays]


def test_chan_u8_cpu_tensor_takes_plain_version():
    args = _chan_u8_inputs(3, 4, 2_000_000, False, 1)
    before = chan_u8.launches
    y = chan_u8.channelize_u8(*args, DC_OFFSET)
    assert chan_u8.launches == before
    assert y.shape == (3, 4, 84, 2)
    assert torch.equal(y, chan_u8.channelize_u8_ref(*args, DC_OFFSET))
    with pytest.raises(ValueError):            # raw of the wrong length
        chan_u8.channelize_u8(args[0][:-2], *args[1:], DC_OFFSET)
    with pytest.raises(ValueError):            # a table of the wrong type
        chan_u8.channelize_u8(args[0], args[1].double(), *args[2:],
                              DC_OFFSET)


@pytest.mark.parametrize("sdrclk", [500, 1250, 1500])
def test_aggregation_windows_rebuild_the_matrix(sdrclk):
    """The kernel's window starts and weights hold every nonzero of the
    dense matrix, and a matrix of another form is refused."""
    a = aggregation_matrix(sdrclk)
    starts, weights = chan_u8.aggregation_windows(a)
    dense = np.zeros_like(a)
    for k in range(a.shape[1]):
        dense[starts[k]:starts[k + 1], k] = weights[starts[k]:starts[k + 1]]
    np.testing.assert_array_equal(dense, a)
    two = a.copy()
    two[5, 40] = 1.0                           # an input feeding two outputs
    gap = a.copy()
    gap[:, 1] = 0.0
    gap[starts[1]:starts[2], 0] = 1.0          # output 1 owns no input
    for bad in (two, gap, a[::-1]):
        with pytest.raises(ValueError):
            chan_u8.aggregation_windows(np.ascontiguousarray(bad))


@pytest.mark.parametrize("sdrclk", [500, 1250, 1500])
def test_window_slots_transpose_the_windows(sdrclk):
    """The kernel's shared-memory layout: input n, the i-th of window k,
    sits at i * pitch + k of a (maxlen, pitch) plane with an odd pitch >=
    K, every input at a place of its own, the windows' first inputs side
    by side in row 0."""
    starts, _w = chan_u8.aggregation_windows(aggregation_matrix(sdrclk))
    slots, pitch, maxlen = chan_u8.window_slots(starts)
    k_out = len(starts) - 1
    assert slots.dtype == np.int32 and slots.shape == (4 * sdrclk,)
    assert pitch % 2 == 1 and k_out <= pitch <= k_out + 1
    assert maxlen == np.diff(starts).max() == -(-4 * sdrclk // k_out)
    plane = np.full(maxlen * pitch, -1)
    plane[slots] = np.arange(4 * sdrclk)
    assert (plane >= 0).sum() == 4 * sdrclk       # no two inputs collide
    plane = plane.reshape(maxlen, pitch)
    assert (plane[:, k_out:] == -1).all()
    for k in range(k_out):
        n = starts[k + 1] - starts[k]
        np.testing.assert_array_equal(plane[:n, k],
                                      np.arange(starts[k], starts[k + 1]))
        assert (plane[n:, k] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan,b,fs,lo_wrap", [
    (8, 2528, 2_000_000, True), (8, 2528, 2_000_000, False),
    (8, 4544, 2_000_000, True), (4, 64, 6_000_000, True),
    (3, 5, 5_000_000, False), (1, 1, 2_000_000, True),
    (5, 7, 2_000_000, False), (2, 3, 6_000_000, False),
    (8, 9, 9_000_000, True), (8, 40, 10_000_000, True),
    (3, 7, 20_000_000, False), (2, 4, 38_000_000, True),
    (64, 1024, 2_000_000, True), (76, 1024, 2_000_000, True),
])
def test_chan_u8_kernel_matches_plain_on_card(n_chan, b, fs, lo_wrap):
    """On CUDA tensors the wrapper launches csrc/chan_u8.cu (one launch
    counted) and agrees with its plain version, at the 2 s block of the
    8-channel slice, at the CLI's 4 s block, at 6 Msps, at a B that is no
    multiple of 32 nor of the three periods a block sums at a time, with
    one channel and one period, with a channel count that leaves the
    last channel group part empty, and at rates whose period no longer
    fits a block's shared memory whole (9 Msps just does; at 10, 20 and
    38 Msps the 84 windows are cut into chunks), and at 64 and 76
    channels of a 32-period-aligned 1 s block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channelizer kernel has no CPU "
                    "mode")
    args = _chan_u8_inputs(n_chan, b, fs, lo_wrap, 2, device="cuda")
    before = chan_u8.launches
    y = chan_u8.channelize_u8(*args, DC_OFFSET)
    torch.cuda.synchronize()
    assert chan_u8.launches == before + 1
    ref = chan_u8.channelize_u8_ref(*args, DC_OFFSET)
    assert y.shape == ref.shape == (n_chan, b, 84, 2)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=CHAN_U8_ATOL)


@pytest.mark.cuda
def test_chan_u8_kernel_takes_raw_at_any_byte_offset():
    """The kernel copies 8 bytes a request; a raw view that starts at
    another offset is moved first and gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channelizer kernel has no CPU "
                    "mode")
    args = _chan_u8_inputs(3, 6, 2_000_000, True, 3, device="cuda")
    y = chan_u8.channelize_u8(*args, DC_OFFSET)
    shifted = torch.cat([args[0][:2], args[0]])[2:]
    assert shifted.data_ptr() % 8 == 2
    assert torch.equal(chan_u8.channelize_u8(shifted, *args[1:], DC_OFFSET), y)
