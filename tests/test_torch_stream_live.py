"""The port's live-pipe decode (Pipeline.stream_live, both branches) and
the resume arguments of stream_wideband_u8 against the JAX Pipeline, on
the CPU.

A live stream is the capture's bytes behind an io.BytesIO: the fused
branch (reference LO, boxcar, cu8 or no use_pallas) keeps a rolling raw
window, the other converts on the host and channelizes from the period
cursor.  Bursts compare block for block and field for field with JAX's,
the frames equal the truth, and decimated_samples is JAX's: on the fused
branch it counts only what was read.  The fused branch reads up to each
segment's end, one read a block, and yields each block before it reads
on, wherever the stream ends.
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
from vdlm2dec_tpu.metrics import PipelineMetrics as JaxMetrics
from vdlm2dec_tpu.ops import pallas_channelizer as jpallas
from vdlm2dec_tpu_torch import pipeline as tpipe
from vdlm2dec_tpu_torch._tables import PipelineConfig, stream_geometry
from vdlm2dec_tpu_torch.metrics import PipelineMetrics

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
    for name, pipe, metrics in (
            ("jax", jpipe.Pipeline(jpipe.PipelineConfig(**kw)), JaxMetrics),
            ("torch", tpipe.Pipeline(PipelineConfig(**kw), device="cpu"),
             PipelineMetrics)):
        pipe.metrics = metrics()
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


def _geometry(pipe, block_seconds):
    """(bytes a period, core_p, rmarg_p) of the fused cu8 live route."""
    ch = pipe.channelizer
    _lm, rmarg_p, core_p, _tot = stream_geometry(
        ch.p_in, ch.p_out, pipe.cfg.fs, pipe.cfg.max_symbols, block_seconds)
    return 2 * ch.p_in, core_p, rmarg_p


# where the stream ends: after whole cores, inside the right margin of
# the second block, and at an odd byte count (a partial cu8 sample)
ENDS = {
    "whole_cores": lambda bpp, core_p, rmarg_p, n: 3 * core_p * bpp,
    "in_a_margin": lambda bpp, core_p, rmarg_p, n:
        (2 * core_p + rmarg_p // 2) * bpp,
    "odd_bytes": lambda bpp, core_p, rmarg_p, n: n - 3001,
}


@pytest.mark.parametrize("end", list(ENDS))
def test_stream_live_fused_equals_the_file_run(small_captures, end):
    """The fused live branch cuts the file run's segments: the same
    blocks and bursts as stream_wideband_u8 on the bytes it was fed,
    wherever the stream ends, and decimated_samples counts the whole
    periods read and no padding."""
    caps, (freqs, fc, _truth), _ = small_captures
    tp = tpipe.Pipeline(PipelineConfig(**_cfg_kw(freqs, fc, "stream")),
                        device="cpu")
    bpp, core_p, rmarg_p = _geometry(tp, 0.15)
    raw = caps["cu8"][: ENDS[end](bpp, core_p, rmarg_p, caps["cu8"].size)]
    assert (end == "odd_bytes") == (raw.size % 2 == 1)

    def run(stream):
        tp.metrics = PipelineMetrics()
        blocks = [[(b.channel, b.t0, b.frames[0].tobytes())
                   for b in bs if b.frames] for bs in stream]
        return blocks, tp.metrics.decimated_samples

    live, n_live = run(tp.stream_live(io.BytesIO(raw.tobytes()),
                                      block_seconds=0.15))
    filed, n_file = run(tp.stream_wideband_u8(raw, block_seconds=0.15))
    assert live == filed and sum(map(len, live)) > 0
    assert len(live) == -(-raw.size // (core_p * bpp))
    assert n_live == n_file == 2 * (raw.size // bpp) * tp.channelizer.p_out


class _LoggedReader:
    """A stream over bytes that logs each read(n) as ("read", n, got)."""

    def __init__(self, data: bytes, log: list):
        self._f, self.log = io.BytesIO(data), log

    def read(self, n: int) -> bytes:
        out = self._f.read(n)
        self.log.append(("read", n, len(out)))
        return out


def test_stream_live_reads_to_each_segment_end_and_yields_before_reading_on(
        small_captures):
    """One read a block: the first asks for a core and its right margin,
    each later one for a core (a short read at the stream's end is
    followed by one for the rest, which finds nothing).  Block k is
    yielded before read k+1 is issued, and the blocks are the file run's."""
    caps, (freqs, fc, _truth), _ = small_captures
    tp = tpipe.Pipeline(PipelineConfig(**_cfg_kw(freqs, fc, "stream")),
                        device="cpu")
    bpp, core_p, rmarg_p = _geometry(tp, 0.15)
    # the stream ends inside a right margin: the last block, fed only by
    # that margin's read, has no read of its own
    raw = caps["cu8"][: -core_p * bpp // 6]
    assert 0 < raw.size % (core_p * bpp) < rmarg_p * bpp
    log: list = []
    for k, bs in enumerate(tp.stream_live(_LoggedReader(raw.tobytes(), log),
                                          block_seconds=0.15)):
        log.append(("yield", k, [(b.channel, b.t0, b.nbrow) for b in bs]))
    reads = [(i, n, got) for i, (kind, n, got) in enumerate(log)
             if kind == "read"]
    # a block's read starts with the request after a full return
    starts = [reads[0]] + [r for prev, r in zip(reads, reads[1:])
                           if prev[2] == prev[1]]
    assert starts[0][1] == (core_p + rmarg_p) * bpp
    assert all(n == core_p * bpp for _i, n, _got in starts[1:])
    short = [r for r in reads if r[2] < r[1]]
    assert len(short) == 2 and short[-1] == reads[-1] and reads[-1][2] == 0
    assert sum(got for _i, _n, got in reads) == raw.size
    yields = [(i, k) for i, (kind, k, _b) in enumerate(log) if kind == "yield"]
    assert [k for _i, k in yields] == list(range(len(yields)))
    assert len(starts) == len(yields) - 1
    for (i_yield, k) in yields:
        # after its own read, before the next block's
        if k < len(starts):
            assert starts[k][0] < i_yield
        if k + 1 < len(starts):
            assert i_yield < starts[k + 1][0]
    filed = [[(b.channel, b.t0, b.nbrow) for b in bs]
             for bs in tp.stream_wideband_u8(raw, block_seconds=0.15)]
    assert [b for kind, _k, b in log if kind == "yield"] == filed
    assert len(filed) == -(-raw.size // (core_p * bpp)) >= 3


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
