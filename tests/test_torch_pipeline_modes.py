"""The port's sync "xla", compute "bf16", FIR filter and non-fused entry
points against the JAX Pipeline, on the CPU.

Same captures and PipelineConfig on both sides.  Packed rows compare as
in tests/test_torch_pipeline.py (live rows byte for byte, of/df to 1e-5);
streamed bursts block for block and field for field, with the frames
equal to the JAX frames and the stimulus truth.
"""
import numpy as np
import pytest
import torch

from test_torch_pipeline import (  # noqa: F401  (fixtures)
    _assert_bursts_match,
    _assert_packed_match,
    _cfg_kw,
    _frames,
    _pipes,
    capture,
)
from vdlm2dec_tpu import pipeline as jpipe
from vdlm2dec_tpu_torch import pipeline as tpipe
from vdlm2dec_tpu_torch._tables import PipelineConfig

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)


def _complex(raw_u8: np.ndarray) -> np.ndarray:
    """cu8 bytes -> complex64 samples, DC subtracted, as the capture
    reader converts them."""
    f = raw_u8.astype(np.float32) - np.float32(127.37)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


@pytest.mark.parametrize("chan_impl", ["dft", "matmul"])
def test_xla_packed_rows_match_jax(capture, chan_impl):
    """sync_impl="xla": stream's metric through K1's stream mode, then
    the flat demod on the materialized four-branch filter output."""
    raw, freqs, fc, truth = capture
    jp, tp = _pipes(freqs, fc, "xla", chan_impl=chan_impl)
    jb = np.asarray(jpipe._dispatch_fused(jp, raw, "cu8", 0, 0))
    tb = tp.dispatch_fused(raw, "cu8", 0, 0).numpy()
    _assert_packed_match(jb, tb)
    got = tp._finish(tpipe.unpack_results(tb), 0)
    assert _frames(got) == sorted((c, b) for c, b, *_ in truth)


FUSED_MODES = {
    "xla": dict(sync_impl="xla"),
    "bf16_dft": dict(compute="bf16", chan_impl="dft"),
    "bf16_matmul": dict(compute="bf16", chan_impl="matmul"),
    "bf16_pfb": dict(compute="bf16", chan_impl="pfb"),
}


@pytest.mark.parametrize("mode", list(FUSED_MODES))
def test_stream_wideband_u8_modes_match_jax(capture, mode):
    """The fused streaming path under "xla" and under bf16 on every
    residue / dense channelizer: JAX's bursts, block for block."""
    raw, freqs, fc, truth = capture
    kw = dict(FUSED_MODES[mode])
    jp, tp = _pipes(freqs, fc, kw.pop("sync_impl", "stream"), **kw)
    want = [b for bs in jp.stream_wideband_u8(raw, block_seconds=0.25)
            for b in bs]
    got = [b for bs in tp.stream_wideband_u8(raw, block_seconds=0.25)
           for b in bs]
    _assert_bursts_match(got, want, truth)


def test_bf16_frames_equal_f32_frames(capture):
    """bf16 rounds the channelizer's operands, yet the frames are the f32
    run's and the truth, as tests/test_bf16_mode.py holds for JAX; the
    decimated streams themselves differ."""
    raw, freqs, fc, truth = capture
    frames, ys = {}, {}
    for compute in ("f32", "bf16"):
        tp = tpipe.Pipeline(PipelineConfig(**_cfg_kw(freqs, fc, "stream",
                                                     compute=compute)),
                            device="cpu")
        frames[compute] = _frames(b for bs in tp.stream_wideband_u8(
            raw, block_seconds=0.25) for b in bs)
        ys[compute] = tpipe.channelize_raw(torch.from_numpy(raw[:80_000]),
                                           tp.channelizer, "cu8", False)
    assert frames["bf16"] == frames["f32"] == sorted(
        (c, b) for c, b, *_ in truth)
    assert not torch.equal(ys["bf16"], ys["f32"])


def test_decode_wideband_and_channels_match_jax(capture):
    """decode_wideband on complex samples (padded to whole periods
    through the channelizer's sample entry), and decode_channels on the
    decimated streams as complex numpy and as torch planes."""
    raw, freqs, fc, truth = capture
    x = _complex(raw)[:-700]                    # not a whole period
    jp, tp = _pipes(freqs, fc, "stream")
    want = jp.decode_wideband(x)
    got = tp.decode_wideband(x)
    _assert_bursts_match(got, want, truth)
    assert tp.channelizer._period_cursor == jp.channelizer._period_cursor
    y = np.array(jp.channelizer(x[: len(x) // 2000 * 2000], period0=0))
    yc = y[..., 0] + 1j * y[..., 1]
    _assert_bursts_match(tp.decode_channels(yc), jp.decode_channels(yc),
                         truth)
    _assert_bursts_match(tp.decode_channels(torch.from_numpy(y)),
                         jp.decode_channels(y), truth)


STREAM_MODES = {
    "boxcar": dict(),
    "fir": dict(filter_mode="fir"),
    "fir_bf16": dict(filter_mode="fir", compute="bf16"),
    "bf16": dict(compute="bf16"),
    "lo_wrap_false": dict(lo_wrap=False),
    "xla_pfb": dict(sync_impl="xla", chan_impl="pfb"),
}


@pytest.mark.parametrize("mode", list(STREAM_MODES))
def test_stream_wideband_matches_jax(capture, mode):
    """stream_wideband over complex samples: each segment channelized at
    its absolute period (lo_wrap=False stays phase-exact over the
    overlapping reads), the FIR route included; blocks 1.. resumed with
    start_block and the prev_end of block 0 give the tail."""
    raw, freqs, fc, truth = capture
    x = _complex(raw)
    kw = dict(STREAM_MODES[mode])
    jp, tp = _pipes(freqs, fc, kw.pop("sync_impl", "stream"), **kw)
    assert tp.cfg.chan_impl == jp.cfg.chan_impl
    want = list(jp.stream_wideband(x, block_seconds=0.25))
    prev_end: dict[int, int] = {}
    got = []
    for bursts in tp.stream_wideband(x, block_seconds=0.25,
                                     prev_end=prev_end):
        got.append(bursts)
        if len(got) == 1:
            after0 = dict(prev_end)
    assert len(got) == len(want) == 4
    _assert_bursts_match([b for bs in got for b in bs],
                         [b for bs in want for b in bs], truth)
    tail = [b for bs in tp.stream_wideband(x, block_seconds=0.25,
                                           start_block=1, prev_end=after0)
            for b in bs]
    assert [(b.channel, b.t0) for b in tail] == \
        [(b.channel, b.t0) for bs in got[1:] for b in bs]


def test_stream_channels_matches_jax(capture):
    raw, freqs, fc, truth = capture
    jp, tp = _pipes(freqs, fc, "stream")
    y = np.array(jp.channelizer(_complex(raw), period0=0))
    want = [b for bs in jp.stream_channels(y, core_len=21_000) for b in bs]
    got = [b for bs in tp.stream_channels(y, core_len=21_000) for b in bs]
    _assert_bursts_match(got, want, truth)

