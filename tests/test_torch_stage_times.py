"""stage_times' table describes the real device program: the program run
with the stage observer gives device_decode_packed's bytes, and the
observer sees every stage once, in order.  (The times themselves are
CUDA-event times and exist only on a card.)"""
import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch import stage_times, stimulus
from vdlm2dec_tpu_torch._tables import PipelineConfig
from vdlm2dec_tpu_torch.ops.ingest import raw_to_planes_split
from vdlm2dec_tpu_torch.pipeline import (STAGES, Pipeline,
                                         device_decode_packed)

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

FS = 2_000_000
BLOCK_S = 0.25


@pytest.fixture(scope="module")
def capture():
    """2 channels, three 0.25 s blocks of dense impaired bursts."""
    wide, freqs, fc, _truth = stimulus.make_capture(FS, 2, 3 * BLOCK_S)
    return stimulus.to_u8(wide), freqs, fc


@pytest.mark.parametrize("sync_impl", ["stream", "fused", "xla"])
def test_staged_program_gives_the_programs_bytes(capture, sync_impl):
    raw, freqs, fc = capture
    cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=FS,
                         fc_hz=float(fc), max_candidates=16, max_symbols=512,
                         max_out=24, sync_impl=sync_impl)
    pipe = Pipeline(cfg, device="cpu")
    program, seg, n = stage_times.block_program(pipe, raw, BLOCK_S)
    seen = []
    staged = program(seen.append)
    assert tuple(seen) == STAGES
    # the same block through the program's two halves, no observer
    ch = pipe.channelizer
    seg_np, core_start, core_len = stage_times.block_segment(pipe, raw,
                                                             BLOCK_S, 1)
    assert n == len(seg_np) // 2 and torch.equal(seg, torch.from_numpy(seg_np))
    y = ch(*raw_to_planes_split(seg, ch.p_in), split=True)
    plain = device_decode_packed(y, 16, 512, 24, core_start=core_start,
                                 core_len=core_len, sync_impl=sync_impl)
    assert staged.dtype == torch.uint8 and staged.shape == (24, 2096)
    assert torch.equal(staged, plain)
    assert torch.equal(program(), plain)
    # the block holds traffic: live rows, and the core owns only its own
    live = plain[:, 2048:].contiguous().view(torch.int32)[:, 6]
    assert int(live.sum()) >= 2


def test_block_segment_is_the_streams_cut(capture, monkeypatch):
    """Block i of block_segment is the segment stream_wideband_u8 hands to
    the device program, padding included (the last block runs past the
    capture)."""
    import vdlm2dec_tpu_torch.pipeline as P

    raw, freqs, fc = capture
    cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=FS,
                         fc_hz=float(fc), max_candidates=16, max_symbols=512,
                         max_out=24)
    pipe = Pipeline(cfg, device="cpu")
    got = []
    orig = P.Pipeline.dispatch_fused

    def spy(pipe_, seg, fmt, core_start, core_len, *block):
        got.append((np.array(seg), core_start, core_len))
        return orig(pipe_, seg, fmt, core_start, core_len, *block)

    monkeypatch.setattr(P.Pipeline, "dispatch_fused", spy)
    for _ in pipe.stream_wideband_u8(raw, block_seconds=BLOCK_S):
        pass
    assert len(got) == 3
    for i, (seg, core_start, core_len) in enumerate(got):
        mine, cs, cl = stage_times.block_segment(pipe, raw, BLOCK_S, i)
        assert (cs, cl) == (core_start, core_len)
        np.testing.assert_array_equal(mine, seg)
    assert (got[2][0][-100:] == 127).all()


def test_stage_table_needs_a_card(capture):
    raw, freqs, fc = capture
    pipe = Pipeline(PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=FS,
                                   fc_hz=float(fc)), device="cpu")
    with pytest.raises(ValueError, match="CUDA-event"):
        stage_times.stage_table(pipe, raw, BLOCK_S)
