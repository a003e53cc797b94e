"""The port's live-pipe decode (Pipeline.stream_live, both branches) and
the resume arguments of stream_wideband_u8 against the JAX Pipeline, on
the CPU.

A live stream is the capture's bytes behind an io.BytesIO: the fused
branch (reference LO, boxcar, cu8 or no use_pallas) keeps a rolling raw
window, the other converts on the host and channelizes from the period
cursor.  Bursts compare block for block and field for field with JAX's,
the frames equal the truth, and decimated_samples is JAX's: on the fused
branch it counts only what was read.
"""
import functools
import io

import pytest
import torch

from test_torch_pipeline import (  # noqa: F401  (fixtures)
    _assert_bursts_match,
    _cfg_kw,
    _pipes,
    capture,
    small_captures,
)
from vdlm2dec_tpu import pipeline as jpipe
from vdlm2dec_tpu.metrics import PipelineMetrics
from vdlm2dec_tpu.ops import pallas_channelizer as jpallas
from vdlm2dec_tpu_torch import pipeline as tpipe
from vdlm2dec_tpu_torch._tables import PipelineConfig

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

LIVE = {
    "fused_cu8": ("cu8", dict()),
    "fused_pallas": ("cu8", dict(use_pallas=True)),
    "fused_cs16": ("cs16", dict()),
    "fir": ("cu8", dict(filter_mode="fir")),
    "pallas_cs16": ("cs16", dict(use_pallas=True)),
    "lo_wrap_false": ("cu8", dict(lo_wrap=False)),
}


@pytest.mark.parametrize("route", list(LIVE))
def test_stream_live_matches_jax(small_captures, route, monkeypatch):
    """Each branch of stream_live: fused for cu8 (also through K2's
    plain version under use_pallas, JAX's Pallas kernel in interpret
    mode) and cs16; host conversion for the FIR filter, for use_pallas
    on cs16 and for the continuous LO.  The stream ends 3001 bytes short
    of its last block (an odd byte count: a partial cu8 item)."""
    caps, (freqs, fc, truth), _ = small_captures
    fmt, extra = LIVE[route]
    if extra.get("use_pallas"):
        monkeypatch.setattr(jpallas, "channelize_u8_pallas", functools.partial(
            jpallas.channelize_u8_pallas, interpret=True))
    data = caps[fmt].tobytes()[:-3001]
    kw = {**_cfg_kw(freqs, fc, "stream"), **extra}
    out = {}
    for name, pipe in (
            ("jax", jpipe.Pipeline(jpipe.PipelineConfig(**kw))),
            ("torch", tpipe.Pipeline(PipelineConfig(**kw), device="cpu"))):
        pipe.metrics = PipelineMetrics()
        blocks = list(pipe.stream_live(io.BytesIO(data), fmt=fmt,
                                       block_seconds=0.15))
        out[name] = (blocks, pipe.metrics.decimated_samples)
    (want, n_want), (got, n_got) = out["jax"], out["torch"]
    assert len(got) == len(want) >= 3
    # the fused branch counts the items read; the other counts nothing,
    # in both packages
    assert n_got == n_want
    assert (n_got > 0) == route.startswith("fused")
    _assert_bursts_match([b for bs in got for b in bs],
                         [b for bs in want for b in bs], truth)


def test_stream_live_fused_equals_the_file_run(small_captures):
    """The fused live branch cuts the file run's segments: the same
    bursts as stream_wideband_u8 on the whole capture."""
    caps, (freqs, fc, _truth), _ = small_captures
    tp = tpipe.Pipeline(PipelineConfig(**_cfg_kw(freqs, fc, "stream")),
                        device="cpu")
    live = [(b.channel, b.t0, b.frames[0].tobytes())
            for bs in tp.stream_live(io.BytesIO(caps["cu8"].tobytes()),
                                     block_seconds=0.15)
            for b in bs if b.frames]
    filed = [(b.channel, b.t0, b.frames[0].tobytes())
             for bs in tp.stream_wideband_u8(caps["cu8"], block_seconds=0.15)
             for b in bs if b.frames]
    assert live == filed != []


@pytest.mark.parametrize("sync_impl", ["stream", "xla"])
def test_stream_wideband_u8_resume_equals_the_tail(capture, sync_impl):
    """start_block with the prev_end of the blocks before it yields
    exactly the uninterrupted run's remaining blocks (a checkpoint
    resume), and JAX's resumed blocks."""
    raw, freqs, fc, _truth = capture
    jp, tp = _pipes(freqs, fc, sync_impl)
    prev_end: dict[int, int] = {}
    full, snaps = [], []
    for bursts in tp.stream_wideband_u8(raw, block_seconds=0.25,
                                        prev_end=prev_end):
        full.append(bursts)
        snaps.append(dict(prev_end))
    assert len(full) == 4
    for k in (1, 2):
        tail = list(tp.stream_wideband_u8(raw, block_seconds=0.25,
                                          start_block=k,
                                          prev_end=dict(snaps[k - 1])))
        assert [[(b.channel, b.t0, b.nbrow) for b in bs] for bs in tail] \
            == [[(b.channel, b.t0, b.nbrow) for b in bs] for bs in full[k:]]
        want = list(jp.stream_wideband_u8(raw, block_seconds=0.25,
                                          start_block=k,
                                          prev_end=dict(snaps[k - 1])))
        _assert_bursts_match([b for bs in tail for b in bs],
                             [b for bs in want for b in bs],
                             [(c, b) for c, b, p, _n in _truth
                              if p >= k * 21_000])
