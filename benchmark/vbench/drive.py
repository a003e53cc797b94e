"""The measured window: the port's served path, driven as its CLI drives it.

File cells: `Pipeline.stream_wideband_u8(raw, block_seconds, fmt=...)` over
the capture, as cli._file_stream calls it, each yielded block's bursts through
`FrameDecoder.process_burst` under `-J` into an in-memory log, as
cli._decode does; pass after pass, each a new stream (fresh prev_end) and
a new FrameDecoder, like a user decoding the recorded file again.  Only
blocks whose lines were emitted inside the window count.

Live cells: `Pipeline.stream_live(source, fmt, block_seconds)` on the
fused route, where source is the CLI's own pipe reader on the read end of
an OS pipe that a separate feeder process fills on the capture's sample
clock (feeder.py), at the format's bytes a sample times fs.

The capture format is the configuration's "format" (protocol.RAW_FMT),
as the CLI's --format gives it.
"""
from __future__ import annotations

import gc
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from array import array
from dataclasses import dataclass, field

import numpy as np

from . import gen
from .protocol import RAW_FMT, bytes_per_sample, capture_format
from .reference import DEMOD_RATE, Judge, tally

STATION = "BENCH"
FEED_WRITE = 65_536


class LineSink:
    """The -l log of FrameDecoder, kept in memory: every write with the
    time it was made and the stream (pass) it belongs to, in flat arrays
    and a list of strings, so that the garbage collector has next to
    nothing to walk."""

    def __init__(self):
        self.stream = 0
        self.texts: list[str] = []
        self.times = array("d")
        self.streams = array("i")

    def write(self, s: str) -> int:
        self.texts.append(s)
        self.times.append(time.monotonic())
        self.streams.append(self.stream)
        return len(s)

    def flush(self) -> None:
        pass

    def lines(self):
        """(stream, time, line) of every line written."""
        for text, t, stream in zip(self.texts, self.times, self.streams):
            for line in text.splitlines():
                if line:
                    yield stream, t, line


@dataclass
class Record:
    """What a run saw, for the result line and the per-layer readers."""
    cell: dict
    config: dict
    traffic: dict
    blocks: int = 0                   # blocks counted in the window
    samples: int = 0                  # wideband samples of those blocks
    bursts: int = 0                   # DecodedBursts the counted blocks held
    bursts_framed: int = 0            # of them, with a CRC-valid frame
    output_s: float = 0.0             # FrameDecoder time over those blocks
    window_s: float = 0.0
    setup_s: float = 0.0
    latencies_ms: list = field(default_factory=list)
    block_waits_ms: list = field(default_factory=list)
    feed: dict = field(default_factory=dict)
    trace: dict | None = None
    trace_blocks: int = 0
    k1_shape: tuple | None = None
    overflow: int = 0
    tally: dict = field(default_factory=dict)
    block_done: list = field(default_factory=list)   # when each counted block ended
    # per counted block: (next() s, output s, output thread CPU s, GC s,
    # involuntary context switches, process CPU s), for the host's account
    block_host: list = field(default_factory=list)
    # (channel, t0, offset Hz) of every burst with a frame in a counted block
    soft: array = field(default_factory=lambda: array("d"))
    due_t: dict = field(default_factory=dict)   # live: (burst, repeat) -> due
    t_close: float = 0.0              # live: when the run stopped waiting


def pipeline_config(cfg: dict, control: str | None = None):
    """The port's PipelineConfig of a configuration file (the CLI's flags
    it stands for are named in the file)."""
    from vdlm2dec_tpu_torch._tables import PipelineConfig

    return PipelineConfig(
        freqs_hz=[float(f) for f in gen.channel_plan(cfg)],
        fs=int(cfg["fs"]), fc_hz=float(cfg["fc_hz"]),
        real_input=capture_format(cfg) == "f32real",
        max_symbols=min(5449, int(cfg["max_rows"]) * 680 + 16),
        max_candidates=int(cfg["max_candidates"]),
        max_out=int(cfg["max_out"]),
        chan_impl=cfg["chan_impl"], sync_impl=cfg["sync_impl"],
        compute="bf16" if control == "bf16" else cfg["compute"])


def k1_shape(pipe, block_seconds: float) -> tuple[int, int]:
    """(channels, decimated samples) of one block's sync scan."""
    from vdlm2dec_tpu_torch._tables import stream_geometry

    ch = pipe.channelizer
    _l, _r, _c, total_p = stream_geometry(ch.p_in, ch.p_out, pipe.cfg.fs,
                                          pipe.cfg.max_symbols, block_seconds)
    return len(pipe.f_offsets), total_p * ch.p_out


def _decoder(sink):
    from vdlm2dec_tpu_torch.host.decoder import FrameDecoder
    from vdlm2dec_tpu_torch.host.output import OutputConfig

    out = OutputConfig(verbose=0, jsonout=True, station_id=STATION, logfile=sink)
    return FrameDecoder(out, time_base=0.0)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class HostAccount:
    """The host's side of each block: wall and thread CPU time of the
    stream's next() and of the output, time in the garbage collector, the
    process's involuntary context switches and CPU time, so that a window
    whose rate moves can be told apart by what moved."""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t

    def close(self):
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def snap(self) -> tuple[float, float, int, float]:
        return (time.thread_time(), self.gc_s,
                resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw, time.process_time())

    @staticmethod
    def delta(a, b) -> tuple:
        return tuple(y - x for x, y in zip(a, b))


def _keep_soft(rec: Record, bursts) -> None:
    for b in bursts:
        if b.frames:
            rec.soft.extend((b.channel, b.t0, b.ppm * b.freq_hz / 1e6))


def run_file(pipe, cap: gen.Capture, rec: Record, seconds: float, tracer,
             t_start: float, device) -> tuple[LineSink, list]:
    """Warm one pass, then decode pass after pass for `seconds`.  Returns
    the sink and the due bursts [(stream, burst index, 0)]."""
    block_s = float(rec.config["block_seconds"])
    core = pipe.core_raw_samples(block_s)
    core_dec = core // pipe.channelizer.p_in * pipe.channelizer.p_out
    n_samp = cap.samples
    host = HostAccount()

    def one_pass(sink, dec, on_block=None):
        it = pipe.stream_wideband_u8(cap.raw, block_seconds=block_s, fmt=cap.fmt)
        try:
            i = 0
            while True:
                h0 = host.snap()
                tn = time.monotonic()
                with tracer.range("stream.next"):
                    bursts = next(it, None)
                if bursts is None:
                    return True
                t0 = time.monotonic()
                h1 = host.snap()
                with tracer.range("output"):
                    for b in bursts:
                        dec.process_burst(b)
                t1 = time.monotonic()
                h2 = host.snap()
                if on_block is not None and not on_block(
                        i, bursts, t1 - t0, t1,
                        (t0 - tn, t1 - t0, h2[0] - h1[0]) + HostAccount.delta(h0, h2)[1:]):
                    return False
                i += 1
        finally:
            it.close()

    # set-up: one whole pass warms every shape of the cell
    warm_sink = LineSink()
    one_pass(warm_sink, _decoder(warm_sink))
    tracer.warm()
    _sync(device)

    sink = LineSink()
    spans: list = []                   # (stream, first, last) into order
    starts = [b.start for b in cap.bursts]
    order = np.argsort(starts, kind="stable")
    sorted_starts = np.asarray(starts)[order]
    gc.collect()
    gc.freeze()                        # set-up's objects: not walked again
    t_win0 = time.monotonic()
    rec.setup_s = t_win0 - t_start
    t_end = t_win0 + seconds
    tracer.start()
    t_trace_end = t_win0 + float(rec.traffic["trace_seconds"])
    state = {"last": False}

    def on_block(i, bursts, out_s, t_done, host_s):
        if tracer.running and t_done >= t_trace_end:
            tracer.stop()
        if t_done > t_end:
            # the block after the window: its lines serve the matching of
            # bursts that straddle the last counted block's end, no more
            state["last"] = True
            return False
        rec.blocks += 1
        rec.block_done.append(t_done - t_win0)
        rec.samples += min(core, n_samp - i * core)
        rec.bursts += len(bursts)
        rec.bursts_framed += sum(1 for b in bursts if b.frames)
        rec.output_s += out_s
        rec.block_host.append(host_s)
        _keep_soft(rec, bursts)
        if tracer.running:
            rec.trace_blocks += 1
        a, b = np.searchsorted(sorted_starts, [i * core_dec, (i + 1) * core_dec])
        spans.append((sink.stream, int(a), int(b)))
        return True

    while not state["last"]:
        sink.stream += 1
        if one_pass(sink, _decoder(sink), on_block=on_block) and time.monotonic() > t_end:
            break
    rec.window_s = seconds
    tracer.stop()
    gc.unfreeze()
    host.close()
    rec.trace = tracer.summary
    due = [(st, int(k), 0) for st, a, b in spans for k in order[a:b]]
    return sink, due


class _TimedReader:
    """The CLI's pipe reader, with the wait for the pipe inside a range."""

    def __init__(self, inner, tracer):
        self.inner = inner
        self.tracer = tracer
        self.done: list[float] = []          # when each read returned

    def read(self, n: int) -> bytes:
        with self.tracer.range("feed"):
            out = self.inner.read(n)
        self.done.append(time.monotonic())
        return out


def run_live(pipe, cap: gen.Capture, rec: Record, seconds: float, tracer,
             t_start: float, device) -> tuple[LineSink, list]:
    """Feed the capture through a pipe on its sample clock, from a separate
    process, and decode it as the CLI's `--iq -` does."""
    import io

    from vdlm2dec_tpu_torch.cli import _LiveStdin

    tr = rec.traffic
    block_s = float(rec.config["block_seconds"])
    fs = int(rec.config["fs"])
    core = pipe.core_raw_samples(block_s)
    core_dec = core // pipe.channelizer.p_in * pipe.channelizer.p_out
    bps = bytes_per_sample(cap.fmt)
    rate = float(bps * fs)                         # the feed's bytes a second
    lead = int(tr["lead_blocks"])
    grace = int(tr["grace_blocks"])
    feed_s = lead * block_s + seconds + grace * block_s + block_s
    total_writes = int(np.ceil(feed_s * rate / FEED_WRITE))

    fd, path = tempfile.mkstemp(suffix="." + cap.fmt)
    r_fd = w_fd = None
    feeder = None
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(cap.raw.tobytes())
        r_fd, w_fd = os.pipe()
        feeder = subprocess.Popen(
            [sys.executable, os.path.join(os.path.dirname(__file__), "feeder.py"),
             path, str(w_fd), repr(rate), str(total_writes)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, pass_fds=(w_fd,),
            text=True)
        os.close(w_fd)
        w_fd = None

        # set-up: the live route over the capture's first blocks, from
        # memory, warms every shape the feed will use
        warm_sink = LineSink()
        warm_dec = _decoder(warm_sink)
        items = (lead + 1) * core * RAW_FMT[cap.fmt][0]
        for bursts in pipe.stream_live(io.BytesIO(cap.raw[:items].tobytes()),
                                       cap.fmt, block_s):
            for b in bursts:
                warm_dec.process_burst(b)
        tracer.warm()
        _sync(device)
        if feeder.stdout.readline().strip() != "ready":
            raise RuntimeError("the feeder did not start")

        sink = LineSink()
        sink.stream = 1
        dec = _decoder(sink)
        gc.collect()
        gc.freeze()
        origin = time.monotonic() + 0.05
        feeder.stdin.write(f"{origin!r}\n")
        feeder.stdin.flush()
        period = FEED_WRITE / rate
        w0 = origin + lead * block_s
        w1 = w0 + seconds
        deadline = w1 + grace * block_s
        # the block whose yield brings out every burst fed in the window
        # (the one holding the window's end, and the next for the bursts
        # that straddle it)
        last_block = int((w1 - origin) / block_s) + 1
        src = _TimedReader(_LiveStdin(r_fd), tracer)
        it = pipe.stream_live(src, cap.fmt, block_s)
        k = 0
        yields = []
        try:
            while True:
                now = time.monotonic()
                if now >= w0 and not tracer.running and tracer.summary is None:
                    tracer.start()
                with tracer.range("stream.next"):
                    bursts = next(it, None)
                if bursts is None:
                    break
                t_y = time.monotonic()
                with tracer.range("output"):
                    for b in bursts:
                        dec.process_burst(b)
                t1 = time.monotonic()
                yields.append((k, t_y))
                if w0 <= t_y <= w1:
                    _keep_soft(rec, bursts)
                    rec.blocks += 1
                    rec.bursts += len(bursts)
                    rec.bursts_framed += sum(1 for b in bursts if b.frames)
                    rec.output_s += t1 - t_y
                    if tracer.running:
                        rec.trace_blocks += 1
                if tracer.running and t1 >= w0 + float(tr["trace_seconds"]):
                    tracer.stop()
                k += 1
                if k > last_block or t1 > deadline:
                    break
        finally:
            it.close()
        tracer.stop()
        gc.unfreeze()
        rec.trace = tracer.summary
        t_close = time.monotonic()
        os.close(r_fd)
        r_fd = None
        feeder.stdin.close()
        out = feeder.stdout.read()
        feeder.wait(timeout=60)
        feeder = None
        import json as _json

        tail = [ln for ln in out.splitlines() if ln.startswith("{")]
        rec.feed = _json.loads(tail[-1]) if tail else {}
    finally:
        if feeder is not None:
            feeder.kill()
            feeder.wait()
        for f in (r_fd, w_fd):
            if f is not None:
                os.close(f)
        os.unlink(path)

    rec.setup_s = w0 - t_start
    rec.window_s = seconds
    rec.feed["reads_s"] = [round(t - origin, 4) for t in src.done]
    rec.feed["yields_s"] = [round(t - origin, 4) for _k, t in yields]
    # block waits: the due time of a block's last core byte to its yield
    for kb, t_y in yields:
        due_t = origin + (kb + 1) * core * bps / rate
        if w0 <= due_t <= w1:
            rec.block_waits_ms.append(1e3 * (t_y - due_t))

    # bursts whose last sample was fed inside the window, over the feed's
    # repeats of the capture
    period_dec = int(round(cap.seconds * DEMOD_RATE))
    due = []
    due_t = {}
    reps = int(np.ceil(feed_s / cap.seconds)) + 1
    for rep in range(reps):
        for i, b in enumerate(cap.bursts):
            last_raw = -(-(rep * period_dec + b.end) * fs // DEMOD_RATE)
            j = (bps * last_raw) // FEED_WRITE
            t = origin + (j + 1) * period
            if w0 <= t < w1:
                due.append((1, i, rep))
                due_t[(i, rep)] = t
    rec.due_t = due_t
    rec.t_close = t_close
    return sink, due


def live_latencies(judge: Judge, sink: LineSink, rec: Record) -> list:
    """Per due burst: the time of its line minus the due time of the write
    that held its last sample; a burst with no line counts at its age when
    the run stopped waiting."""
    first = {}
    for _stream, t, line in sink.lines():
        hit = judge.locate(line)
        if hit is not None:
            key = (hit[0], hit[1])
            first.setdefault(key, t)
    out = []
    for key, t_due in rec.due_t.items():
        t = first.get(key, rec.t_close)
        out.append(1e3 * (t - t_due))
    return out


def quantile(values, q: float) -> float:
    """The q-quantile of values by statistics.quantiles' default method."""
    if len(values) == 1:
        return float(values[0])
    qs = statistics.quantiles(values, n=100)
    return float(qs[int(round(q * 100)) - 1])
