"""vbench/spans.py: the port's block spans on the profiler's clock, on
hand-made traces and spans, on a CPU profile, and a tiny CPU live run in
which the spans split the block wait that drive.py measures."""
import json
import os
import statistics
import tempfile
import time

import pytest
import torch

from vbench import cells, drive, harness
from vbench import spans as vs
from vdlm2dec_tpu_torch import pipeline as pl
from vdlm2dec_tpu_torch.metrics import Span, SpanLog

torch.set_num_threads(1)

MAIN, FETCH = 101, 202                  # native thread ids
OFFSET_US = 5000.0                      # trace us = program ns / 1e3 + this


def _span(name, block, start_us, end_us, parent=None, tid=MAIN):
    """A span given on the trace's clock."""
    return Span(name, block, parent, tid, int((start_us - OFFSET_US) * 1e3),
                int((end_us - OFFSET_US) * 1e3))


def _x(name, cat, ts, dur, tid=MAIN, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _block(b, t0):
    """One block's spans from trace time t0 (us): dispatch 0-100 with the
    upload 0-20 and two stages, queue, unpack and ready on the fetch
    thread, finish 300-340."""
    return [
        _span("block.dispatch", b, t0, t0 + 100),
        _span("block.upload", b, t0 + 1, t0 + 20, "block.dispatch"),
        _span("stage.channelize", b, t0 + 20, t0 + 60, "block.dispatch"),
        _span("stage.demod", b, t0 + 60, t0 + 90, "block.dispatch"),
        _span("block.queue", b, t0 + 100, t0 + 110),
        _span("block.unpack", b, t0 + 200, t0 + 220, tid=FETCH),
        _span("block.ready", b, t0 + 221, t0 + 221, tid=FETCH),
        _span("block.finish", b, t0 + 300, t0 + 340),
    ]


def _launch(corr, ts, kind, name, dts, dur):
    """A runtime call at ts on the main thread and the device op it
    launched, dts later, lasting dur (us)."""
    return [_x("cudaLaunchKernel", "cuda_runtime", ts, 2, corr=corr),
            _x(name, kind, ts + dts, dur, tid=7, corr=corr)]


def test_device_ops_link_through_correlation_to_the_innermost_span():
    spans = _block(0, 1000) + _block(1, 2000)
    events = [_x(vs.ANCHOR, "user_annotation", 900, 1),
              _x(vs.ANCHOR, "user_annotation", 2900, 1)]
    for b, t0 in ((0, 1000), (1, 2000)):
        c = 10 * (b + 1)
        events += _launch(c, t0 + 5, "gpu_memcpy", "Memcpy HtoD (Pageable)", 1, 30)
        events += _launch(c + 1, t0 + 30, "kernel", "front_kernel", 40, 50)
        events += _launch(c + 2, t0 + 70, "kernel", "demod_kernel", 60, 20)
        events += _launch(c + 3, t0 + 95, "gpu_memcpy", "Memcpy DtoH", 60, 5)
    # a kernel whose launch the trace lacks, and one launched outside spans
    events.append(_x("orphan", "kernel", 2500, 10, tid=7, corr=999))
    events += _launch(50, 2450, "kernel", "outside", 5, 10)
    got = vs.attribute(events, spans, OFFSET_US)
    st = got["stages"]
    assert st["block.upload"] == pytest.approx(2 * 30e-6)
    assert st["stage.channelize"] == pytest.approx(2 * 50e-6)
    assert st["stage.demod"] == pytest.approx(2 * 20e-6)
    assert st["block.dispatch"] == pytest.approx(2 * 5e-6)
    assert st["unattributed"] == pytest.approx(20e-6)
    assert got["attributed_share"] == pytest.approx(210 / 230)
    assert got["blocks"] == 2
    assert got["launches_per_block"] == 2          # kernels inside dispatch
    assert got["h2d_ms_per_block"] == pytest.approx(0.030)
    assert got["front_device_ms_per_block"] == pytest.approx(0.050)
    assert got["burst_device_ms_per_block"] == pytest.approx(0.020)


def test_only_blocks_dispatched_inside_the_slice_are_averaged():
    spans = _block(0, 1000) + _block(1, 2000)
    events = [_x(vs.ANCHOR, "user_annotation", 1500, 1),
              _x(vs.ANCHOR, "user_annotation", 2900, 1)]
    events += _launch(1, 1030, "kernel", "front_kernel", 40, 50)
    events += _launch(2, 2030, "kernel", "front_kernel", 40, 70)
    got = vs.attribute(events, spans, OFFSET_US)
    assert got["blocks"] == 1
    assert got["front_device_ms_per_block"] == pytest.approx(0.070)


def test_gaps_are_named_by_program_spans_else_by_the_harness():
    spans = _block(0, 1000)
    events = [_x("stream.next", "user_annotation", 990, 360),
              _x("output", "user_annotation", 1400, 300)]
    # device busy 1000-1010, 1050-1060 (gap mid in stage.channelize),
    # 1290-1300 (gap mid 1175: no program span on the main thread, inside
    # stream.next), 1330-1340 (gap mid 1315: block.finish), 1600-1610
    # (gap mid 1470: output), 1900-1910 (gap mid 1755: nothing open)
    for i, ts in enumerate((1000, 1050, 1290, 1330, 1600, 1900)):
        events.append(_x(f"k{i}", "kernel", ts, 10, tid=7, corr=i))
    gaps = vs.attribute(events, spans, OFFSET_US)["idle_gaps"]
    assert [n for n, _s in gaps] == ["harness", "output", "stream.next",
                                     "stage.channelize", "block.finish"]
    assert gaps[0][1] == pytest.approx(290e-6)


def test_anchor_offset_and_its_disagreement():
    """The middle of each anchor's range against the middle of its two
    stamps."""
    anchors = [(1_000_000_000_123, 1_000_000_002_123),
               (1_000_002_000_456, 1_000_002_001_456)]      # ns
    events = [_x(vs.ANCHOR, "user_annotation", a / 1e3 + 777.0 + d - 1.5,
                 (b - a) / 1e3 + 3.0) for (a, b), d in zip(anchors, (0.0, 0.004))]
    off, spread = vs.clock_offset(events, anchors)
    assert off == pytest.approx(777.002, abs=1e-6)
    assert spread == pytest.approx(0.004, abs=1e-6)
    with pytest.raises(ValueError):
        vs.clock_offset(events[:1], anchors)


def test_spans_land_on_the_cpu_profile_clock():
    """A real profile on the CPU: an operator run inside a program span
    maps inside it, within the anchors' disagreement."""
    from torch.profiler import ProfilerActivity, profile

    log = SpanLog()
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]):
        vs.clock_anchor()                  # the first use, slow to enter
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchors = [vs.clock_anchor()]
        with log.span("block.dispatch", 0):
            (x * 3).sum()
        anchors.append(vs.clock_anchor())
    # the chrome export, as trace.py reads it
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    off, spread = vs.clock_offset(trace, anchors)
    (sp,) = log.records()
    lo, hi = sp.start_ns / 1e3 + off, sp.end_ns / 1e3 + off
    ops = [e for e in trace if e.get("name") == "aten::mul" and e.get("ph") == "X"]
    assert ops
    slack = spread + 20.0
    assert all(lo - slack <= e["ts"] and e["ts"] + e["dur"] <= hi + slack for e in ops)


def test_host_means_over_the_given_blocks():
    spans = _block(0, 1000) + _block(1, 2000) + [_span("block.dispatch", 2, 3000, 3500)]
    got = vs.host_means(spans, [0, 1])
    assert got["dispatch_ms_per_block"] == pytest.approx(0.1)
    assert got["finish_ms_per_block"] == pytest.approx(0.06)


def test_live_wait_splits_into_the_blocks_spans(tiny_root, monkeypatch):
    """A tiny live run on the CPU with spans on: the wait from a block's
    due time to the dispatch, the dispatch to ready, the ready to the
    finish and the finish add up to block_result_wait_ms."""
    seen = {}
    real_run, real_stream = drive.run_live, pl.Pipeline.stream_live
    calls = []                             # per stream: (first block, yields)

    def run_live(pipe, cap, rec, *args):
        pipe.spans = SpanLog()
        seen.update(pipe=pipe, rec=rec)
        return real_run(pipe, cap, rec, *args)

    def stream_live(self, source, fmt="cu8", block_seconds=2.0):
        yields = []
        calls.append((self.spans.blocks, yields))
        for bursts in real_stream(self, source, fmt, block_seconds):
            yields.append(time.monotonic_ns())
            yield bursts

    monkeypatch.setattr(drive, "run_live", run_live)
    monkeypatch.setattr(pl.Pipeline, "stream_live", stream_live)
    spec = cells.load_spec(str(tiny_root))
    cell = cells.cell(spec, "rtl8-busy-live")
    seconds = 4.0
    r = harness.run_cell(spec, cell, 2**31 + 11, seconds, False, device="cpu",
                         bench_dir=str(tiny_root / "benchmark"))
    assert r["correct"]
    pipe, rec = seen["pipe"], seen["rec"]
    first, yields = calls[-1]
    # the feed's origin from the yields, which drive.py keeps relative to it
    origin = statistics.fmean(t - 1e9 * s for t, s in zip(yields, rec.feed["yields_s"]))
    block_s = float(rec.config["block_seconds"])
    core = pipe.core_raw_samples(block_s)
    per_block = core * 2 / (2.0 * int(rec.config["fs"]))
    w0 = origin + 1e9 * int(rec.traffic["lead_blocks"]) * block_s
    w1 = w0 + 1e9 * seconds
    dues = {}
    for k in range(len(yields)):
        due = origin + 1e9 * (k + 1) * per_block
        if w0 <= due <= w1:
            dues[first + k] = due
    assert len(dues) == len(rec.block_waits_ms) >= 2
    parts = vs.live_waits(pipe.spans.records(), dues)
    total = sum(parts.values())
    assert total == pytest.approx(statistics.fmean(rec.block_waits_ms), abs=5.0)
    assert parts["block_dispatch_wait_ms"] > 0 and parts["block_ready_wait_ms"] >= 0
