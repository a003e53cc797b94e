"""The port's block spans (metrics.SpanLog as Pipeline.spans) on the CPU:
off, they record nothing and change nothing; on, every block of the
streaming routes has one span of each kind, with one sequence number,
the live route reads once a block and finishes a block before it reads
on, the stage spans nest in the dispatch in STAGES order, the result is ready
before the consumer finishes it, the fetch thread's spans carry its own
thread id, and the ring drops and counts what it cannot hold."""
import io
import threading
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from vdlm2dec_tpu_torch import pipeline as tpipe
from vdlm2dec_tpu_torch import stimulus
from vdlm2dec_tpu_torch._tables import PipelineConfig
from vdlm2dec_tpu_torch.metrics import PipelineMetrics, SpanLog

# test workers share the CPU: one PyTorch thread each
torch.set_num_threads(1)

FS = 2_000_000
BLOCK_S = 0.25
STAGE_SPANS = ["stage." + s for s in tpipe.STAGES]
# the spans of one block on the fused routes, each exactly once
ONCE = ["block.segment", "block.dispatch", "block.upload", "block.queue",
        "block.unpack", "block.ready", "block.finish", *STAGE_SPANS]
FETCH = ("block.unpack", "block.ready")


@pytest.fixture(scope="module")
def capture():
    wide, freqs, fc, _truth = stimulus.make_capture(FS, 2, 1.0)
    wide = wide[: len(wide) - len(wide) % 2000]
    return stimulus.to_u8(wide), freqs, fc


def _pipe(capture, spans=None, **kw):
    _raw, freqs, fc = capture
    cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=FS,
                         fc_hz=float(fc), max_candidates=16, max_symbols=512,
                         max_out=48, **kw)
    pipe = tpipe.Pipeline(cfg, device="cpu")
    pipe.spans = spans
    return pipe


def _run(pipe, raw, route):
    """The blocks a streaming route yields, as (channel, t0, ppm, frames)."""
    if route == "file":
        it = pipe.stream_wideband_u8(raw, block_seconds=BLOCK_S)
    elif route == "live":
        it = pipe.stream_live(io.BytesIO(raw.tobytes()), "cu8", BLOCK_S)
    else:                                      # the host-converted route
        x = (raw[0::2].astype(np.float32) - 127.5) + 1j * (raw[1::2] - 127.5)
        it = pipe.stream_wideband(x.astype(np.complex64), block_seconds=BLOCK_S)
    return [[(b.channel, b.t0, b.ppm, [bytes(f) for f in b.frames]) for b in bs]
            for bs in it]


def _by_block(log):
    out = defaultdict(list)
    for r in log.records():
        out[r.block].append(r)
    return out


@pytest.mark.parametrize("route", ["file", "live"])
def test_spans_off_record_nothing_and_change_nothing(capture, route):
    raw = capture[0]
    off = _pipe(capture)
    want = _run(off, raw, route)
    assert off.spans is None
    log = SpanLog()
    got = _run(_pipe(capture, log), raw, route)
    assert got == want and sum(map(len, want)) > 0
    assert log.records() and log.dropped == 0


@pytest.mark.parametrize("route", ["file", "live"])
def test_every_block_has_each_span_once(capture, route):
    log = SpanLog()
    blocks = _run(_pipe(capture, log), capture[0], route)
    spans = _by_block(log)
    dispatched = sorted(b for b, rs in spans.items()
                        if any(r.name == "block.dispatch" for r in rs))
    assert len(dispatched) == len(blocks) >= 4
    # consecutive numbers, in the order the blocks were yielded
    finished = [r.block for r in log.records() if r.name == "block.finish"]
    assert finished == dispatched == list(range(dispatched[0], dispatched[-1] + 1))
    for b in dispatched:
        n = Counter(r.name for r in spans[b])
        assert all(n[name] == 1 for name in ONCE), (b, n)
        extra = set(n) - set(ONCE) - {"block.read"}
        assert not extra
        if route == "live":
            # one read a block, up to its segment's end, before its
            # segment; a last block fed only by the margin read before it
            # is padding and reads nothing
            reads = [r for r in spans[b] if r.name == "block.read"]
            seg = next(r for r in spans[b] if r.name == "block.segment")
            assert len(reads) == 1 or (not reads and b == dispatched[-1])
            assert all(r.end_ns <= seg.start_ns for r in reads)
            # the block is finished (and yielded) before the next read
            nxt = [r for r in spans[b + 1] if r.name == "block.read"]
            fin = next(r for r in spans[b] if r.name == "block.finish")
            assert all(fin.start_ns < r.start_ns for r in nxt)
        else:
            assert "block.read" not in n


@pytest.mark.parametrize("route", ["file", "live"])
def test_stages_nest_in_dispatch_in_order(capture, route):
    log = SpanLog()
    _run(_pipe(capture, log), capture[0], route)
    for b, rs in _by_block(log).items():
        d = [r for r in rs if r.name == "block.dispatch"]
        if not d:
            continue
        d = d[0]
        children = sorted((r for r in rs if r.parent == "block.dispatch"),
                          key=lambda r: r.start_ns)
        assert [r.name for r in children] == ["block.upload", *STAGE_SPANS]
        for prev, r in zip(children, children[1:]):
            assert prev.end_ns <= r.start_ns
        assert all(d.start_ns <= r.start_ns <= r.end_ns <= d.end_ns for r in children)
        assert all(r.tid == d.tid for r in children)


@pytest.mark.parametrize("route", ["file", "live"])
def test_ready_before_finish_and_fetch_thread_ids(capture, route):
    log = SpanLog()
    _run(_pipe(capture, log), capture[0], route)
    me = threading.get_native_id()
    for b, rs in _by_block(log).items():
        name = {r.name: r for r in rs}
        if "block.dispatch" not in name:
            continue
        ready, fin = name["block.ready"], name["block.finish"]
        assert ready.start_ns == ready.end_ns <= fin.start_ns
        assert name["block.unpack"].end_ns <= ready.start_ns
        for r in rs:
            assert (r.tid != me) == (r.name in FETCH), r


def test_fetch_spans_carry_the_fetch_threads_id(capture):
    """PipelinedDecoder alone: its fetch thread records block.unpack and
    block.ready under that thread's native id."""
    raw = capture[0]
    log = SpanLog()
    pipe = _pipe(capture, log)
    pd = tpipe.PipelinedDecoder(pipe, fmt="cu8")
    seg = raw[: 2 * int(BLOCK_S * FS)]
    try:
        out = list(pd.submit(seg, block=log.new_block()))
        out += list(pd.submit(seg, block=log.new_block()))
        out += list(pd.drain())
        fetch_ids = {pd._thread.native_id}
    finally:
        pd.close()
    assert len(out) == 2
    fetched = [r for r in log.records() if r.name in FETCH]
    assert len(fetched) == 4 and {r.tid for r in fetched} == fetch_ids
    assert threading.get_native_id() not in fetch_ids


def test_submit_without_a_block_number_records_nothing(capture):
    log = SpanLog()
    pipe = _pipe(capture, log)
    pd = tpipe.PipelinedDecoder(pipe, fmt="cu8")
    try:
        list(pd.submit(capture[0][: 2 * int(BLOCK_S * FS)]))
        list(pd.drain())
    finally:
        pd.close()
    assert log.records() == [] and log.blocks == 0


@pytest.mark.parametrize("route", ["host", "live_fir"])
def test_host_converted_routes_record_dispatch_and_finish(capture, route):
    log = SpanLog()
    if route == "host":
        pipe = _pipe(capture, log)
        blocks = _run(pipe, capture[0], "host")
    else:
        pipe = _pipe(capture, log, filter_mode="fir")
        assert not pipe.fused_route("cu8")
        blocks = _run(pipe, capture[0], "live")
    spans = _by_block(log)
    assert len(spans) == len(blocks) >= 4
    for rs in spans.values():
        assert sorted(r.name for r in rs) == ["block.dispatch", "block.finish"]
        d, f = sorted(rs, key=lambda r: r.start_ns)
        assert d.end_ns <= f.start_ns


def test_ring_drops_and_counts_past_its_capacity():
    log = SpanLog(capacity=4)
    for i in range(10):
        log.add("block.segment", log.new_block(), i, i + 1)
    recs = log.records()
    assert [r.block for r in recs] == [6, 7, 8, 9]
    assert log.dropped == 6 and log.blocks == 10
    with log.span("block.finish", 9):
        pass
    assert log.dropped == 7 and log.records()[-1].name == "block.finish"


def test_marker_spans_run_from_mark_to_mark():
    log = SpanLog()
    mark = log.marker(3, "block.dispatch")
    mark("channelize")
    mark("sync")
    a, b = log.records()
    assert (a.name, b.name) == ("stage.channelize", "stage.sync")
    assert a.end_ns == b.start_ns and a.block == b.block == 3
    assert a.parent == "block.dispatch"


def test_device_time_on_the_streaming_route(capture):
    """On the CPU, submit() runs the program: device_time_s is the host
    time from dispatch to fetch, and the snapshot names it stream time."""
    pipe = _pipe(capture)
    pipe.metrics = PipelineMetrics()
    _run(pipe, capture[0], "file")
    assert pipe.metrics.device_time_s > 0
    snap = pipe.metrics.snapshot()
    assert snap["device_stream_s"] == round(pipe.metrics.device_time_s, 3)
    assert "device_time_s" not in snap


@pytest.mark.parametrize("route", ["file", "live"])
def test_live_result_wait_in_the_snapshot(capture, route):
    """The live route counts the blocks it hands out and the host time it
    waits for each one's result before reading on; the file route counts
    neither."""
    pipe = _pipe(capture)
    pipe.metrics = PipelineMetrics()
    blocks = _run(pipe, capture[0], route)
    snap = pipe.metrics.snapshot()
    assert snap["live_result_wait_s"] == round(
        pipe.metrics.live_result_wait_s, 3)
    if route == "live":
        assert snap["live_blocks"] == len(blocks) >= 4
        assert pipe.metrics.live_result_wait_s > 0
    else:
        assert snap["live_blocks"] == 0
        assert pipe.metrics.live_result_wait_s == 0


@pytest.fixture(scope="module")
def real_capture():
    """An airspy f32real capture, 2 Re{wide} at 6 Msps, and its plan (fc
    given as F0 - fs/4, so that F0 is the stimulus's centre)."""
    fs = 6_000_000
    wide, freqs, fc, _truth = stimulus.make_capture(fs, 2, 0.5)
    real = (2 * wide.real).astype(np.float32)
    return real[: len(real) - len(real) % 6000], freqs, fc - fs // 4


@pytest.mark.parametrize("fmt,route", [("cu8", "file"), ("f32real", "file"),
                                       ("cu8", "live")])
def test_h2d_bytes_counts_every_raw_upload(capture, real_capture, monkeypatch,
                                           fmt, route):
    """h2d_bytes is the sum of the raw blocks dispatch_fused uploaded: on
    the file route each block's whole-period segment, total_p x p_in
    samples at 2 bytes (cu8) or 4 (f32real) a sample; the snapshot
    reports it."""
    uploads = []
    real_to_device = tpipe._to_device

    def recorded(arr, device):
        out = real_to_device(arr, device)
        uploads.append(out.nbytes)
        return out
    monkeypatch.setattr(tpipe, "_to_device", recorded)
    if fmt == "f32real":
        raw, freqs, fc = real_capture
        cfg = PipelineConfig(freqs_hz=[float(f) for f in freqs], fs=6_000_000,
                             fc_hz=float(fc), real_input=True, max_candidates=16,
                             max_symbols=512, max_out=48)
        pipe = tpipe.Pipeline(cfg, device="cpu")
    else:
        raw = capture[0]
        pipe = _pipe(capture)
    pipe.metrics = PipelineMetrics()
    if route == "file":
        blocks = list(pipe.stream_wideband_u8(raw, block_seconds=BLOCK_S, fmt=fmt))
    else:
        blocks = list(pipe.stream_live(io.BytesIO(raw.tobytes()), fmt, BLOCK_S))
    assert len(uploads) == len(blocks) >= 2
    assert pipe.metrics.h2d_bytes == sum(uploads)
    assert pipe.metrics.snapshot()["h2d_bytes"] == pipe.metrics.h2d_bytes
    if route == "file":
        ch = pipe.channelizer
        total_p = tpipe.stream_geometry(ch.p_in, ch.p_out, pipe.cfg.fs,
                                        pipe.cfg.max_symbols, BLOCK_S)[3]
        per_sample = {"cu8": 2, "f32real": 4}[fmt]
        assert uploads == [total_p * ch.p_in * per_sample] * len(blocks)
