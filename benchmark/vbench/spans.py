"""The port's block spans (vdlm2dec_tpu_torch.metrics.SpanLog, records
of `Span(name, block, parent, tid, start_ns, end_ns)` on
time.monotonic_ns()) read alone and against the profiler's trace.

One clock: `clock_anchor()` opens a record_function range right after the
profiler starts and again just before it stops, and takes
time.monotonic_ns() first and last inside each; the middle of the range
in the trace (`ts`, `dur`: microseconds) minus the middle of the two
stamps is the offset from the program's clock to the trace's, and the two
anchors' offsets agree within tens of microseconds (`clock_offset`).  The
range's first use in a process is slow to enter (a millisecond on a CPU):
open one in the profiler's warm-up.

On that clock `attribute()` links every kernel, copy and memset to the
CUDA runtime call that launched it (the trace's `correlation`), and that
call to the innermost program span open at that moment on the same
thread; it names each idle gap of the card by the innermost program span
open at the gap's middle on the consuming thread, or else by the
harness's ranges (trace.RANGES).  `host_means` and `live_waits` read the
spans alone.

The harness does not call this module yet: the readers need drive.py to
set `pipe.spans` and keep the window's blocks, and trace.py to take the
anchors and keep the trace's events (PERF.md, section 7).
"""
from __future__ import annotations

import bisect
import statistics
import time
from collections import defaultdict

from .trace import DEVICE_CATS, NAME_CHARS, RANGES, _union

ANCHOR = "clock.anchor"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DISPATCH = "block.dispatch"
UPLOAD = "block.upload"
FRONT = ("stage.channelize",)
BURST = ("stage.demod", "stage.header", "stage.assembly", "stage.rs", "stage.pack")


def clock_anchor() -> tuple[int, int]:
    """time.monotonic_ns() first and last inside a record_function range
    named ANCHOR."""
    import torch

    with torch.profiler.record_function(ANCHOR):
        first = time.monotonic_ns()
        return first, time.monotonic_ns()


def clock_offset(events: list, anchors: list[tuple[int, int]]) -> tuple[float, float]:
    """(offset, disagreement), both in microseconds: the trace's clock
    minus the program's, the mean over the anchors, and the spread of the
    anchors' offsets.  anchors: clock_anchor()'s stamps, in order."""
    ranges = sorted((float(e["ts"]), float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("name") == ANCHOR)
    if len(ranges) != len(anchors) or not ranges:
        raise ValueError(f"{len(ranges)} {ANCHOR} ranges in the trace for "
                         f"{len(anchors)} anchors")
    offs = [ts + dur / 2 - (a + b) / 2e3 for (ts, dur), (a, b) in zip(ranges, anchors)]
    return statistics.fmean(offs), max(offs) - min(offs)


class SpanIndex:
    """The spans of each thread, on the trace's clock (microseconds),
    with each span's enclosing span, for `innermost(tid, t)` lookups.
    Spans of one thread nest or are disjoint."""

    def __init__(self, spans, offset_us: float):
        self.by_tid: dict[int, tuple] = {}
        self.pos: dict[int, tuple[int, int]] = {}     # id(span) -> (tid, row)
        groups = defaultdict(list)
        for s in spans:
            groups[s.tid].append((s.start_ns / 1e3 + offset_us,
                                  s.end_ns / 1e3 + offset_us, s))
        for tid, rows in groups.items():
            rows.sort(key=lambda r: (r[0], -r[1]))
            parent, stack = [], []
            for i, (st, _en, s) in enumerate(rows):
                while stack and rows[stack[-1]][1] < st:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
                self.pos[id(s)] = (tid, i)
            self.by_tid[tid] = ([r[0] for r in rows], rows, parent)

    def innermost(self, tid: int, t: float):
        """The innermost span open at trace time t on thread tid, or None.
        A span that opens before t and encloses it encloses every later
        span that opens before t and has closed: walk up from the last
        opened."""
        got = self.by_tid.get(tid)
        if got is None:
            return None
        starts, rows, parent = got
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if rows[i][1] >= t:
                return rows[i][2]
            i = parent[i]
        return None

    def ancestors(self, span):
        """The names of span's enclosing spans, innermost first."""
        tid, i = self.pos[id(span)]
        _starts, rows, parent = self.by_tid[tid]
        out = []
        i = parent[i]
        while i >= 0:
            out.append(rows[i][2].name)
            i = parent[i]
        return out


def attribute(events: list, spans, offset_us: float) -> dict:
    """Device time and launches by program span over the traced slice.

    Returns `stages` (device seconds by the innermost span that launched
    them, and `unattributed`), `attributed_share`, the slice's blocks
    (those whose block.dispatch lies between the first and last anchor),
    per-block means over them (`launches_per_block`: kernels launched
    inside block.dispatch; `h2d_ms_per_block`: copies launched in
    block.upload; `front_device_ms_per_block`, `burst_device_ms_per_block`:
    device time launched in the front and burst stages), and `idle_gaps`
    named by program spans."""
    index = SpanIndex(spans, offset_us)
    launch = {}
    dev, ranges = [], []
    anchors = []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((ts, dur, cat, name, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = (ts, int(ev.get("tid", -1)))
        elif cat == "user_annotation" and name in RANGES:
            ranges.append((ts, ts + dur, name))
        elif name == ANCHOR:
            anchors.append(ts)

    stages: dict[str, float] = defaultdict(float)
    per_block = defaultdict(lambda: {"launches": 0, "h2d": 0.0, "front": 0.0, "burst": 0.0})
    in_dispatch: dict[int, bool] = {}
    total = attributed = 0.0
    for ts, dur, cat, _name, corr in dev:
        s = dur * 1e-6
        total += s
        call = launch.get(corr)
        span = None if call is None else index.innermost(call[1], call[0])
        if span is None:
            stages["unattributed"] += s
            continue
        attributed += s
        stages[span.name] += s
        b = per_block[span.block]
        key = id(span)
        if key not in in_dispatch:
            in_dispatch[key] = span.name == DISPATCH or DISPATCH in index.ancestors(span)
        if cat == "kernel" and in_dispatch[key]:
            b["launches"] += 1
        if span.name == UPLOAD and cat == "gpu_memcpy":
            b["h2d"] += s
        if span.name in FRONT:
            b["front"] += s
        elif span.name in BURST:
            b["burst"] += s

    lo, hi = (min(anchors), max(anchors)) if anchors else (-float("inf"), float("inf"))
    blocks = sorted({s.block for s in spans if s.name == DISPATCH
                     and lo <= s.start_ns / 1e3 + offset_us
                     and s.end_ns / 1e3 + offset_us <= hi})
    out = {"stages": dict(stages), "device_s": total,
           "attributed_share": attributed / total if total > 0 else None,
           "blocks": len(blocks)}
    for key, metric, scale in (("launches", "launches_per_block", 1.0),
                               ("h2d", "h2d_ms_per_block", 1e3),
                               ("front", "front_device_ms_per_block", 1e3),
                               ("burst", "burst_device_ms_per_block", 1e3)):
        out[metric] = (scale * statistics.fmean(per_block[b][key] for b in blocks)
                       if blocks else None)
    out["idle_gaps"] = name_gaps(dev, ranges, index, spans)
    return out


def name_gaps(dev: list, ranges: list, index: SpanIndex, spans, top: int = 10) -> list:
    """The card's longest idle gaps, [name, seconds], each named by the
    innermost program span open at its middle on the thread that records
    block.dispatch, else by the innermost harness range (trace.reduce's
    rule), else "harness"."""
    consumer = next((s.tid for s in spans if s.name == DISPATCH), None)
    busy = _union((ts, ts + dur) for ts, dur, *_ in dev)
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    gaps = []
    for (_s0, e0), (s1, _e1) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        span = None if consumer is None else index.innermost(consumer, mid)
        if span is not None:
            name = span.name
        else:
            name, best = "harness", None
            i = bisect.bisect_right(starts, mid)
            for rs, re_, rn in ranges[max(0, i - 4): i]:
                if mid <= re_ and (best is None or re_ - rs < best):
                    best, name = re_ - rs, rn
        gaps.append((name[:NAME_CHARS], (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return [[n, s] for n, s in gaps[:top]]


def _by_block(spans) -> dict:
    out: dict[int, dict] = defaultdict(dict)
    for s in spans:
        out[s.block].setdefault(s.name, s)
    return out


def host_means(spans, blocks) -> dict:
    """Means over the given blocks (the window's counted ones), in ms:
    `dispatch_ms_per_block` (block.dispatch) and `finish_ms_per_block`
    (block.unpack on the fetch thread plus block.finish on the consumer)."""
    by = _by_block(spans)
    rows = [by[b] for b in blocks if b in by]

    def mean(names):
        vals = [sum(r[n].end_ns - r[n].start_ns for n in names) / 1e6
                for r in rows if all(n in r for n in names)]
        return statistics.fmean(vals) if vals else None
    return {"dispatch_ms_per_block": mean(("block.dispatch",)),
            "finish_ms_per_block": mean(("block.unpack", "block.finish"))}


def live_waits(spans, dues: dict[int, int]) -> dict:
    """A live stream's wait for its blocks, split at the block's spans:
    dues maps a block's number to the due time (monotonic ns) of its last
    core byte on the feed.  Means over those blocks, in ms:
    `block_dispatch_wait_ms` (due to the start of block.dispatch),
    `dispatch_to_ready_ms` (to block.ready), `block_ready_wait_ms` (to the
    start of block.finish, the wait for the consumer's next submit()) and
    `finish_ms` (block.finish); together the due time to the yield."""
    by = _by_block(spans)
    parts = {"block_dispatch_wait_ms": [], "dispatch_to_ready_ms": [],
             "block_ready_wait_ms": [], "finish_ms": []}
    for b, due in dues.items():
        r = by.get(b, {})
        if not all(n in r for n in ("block.dispatch", "block.ready", "block.finish")):
            continue
        d, rd, f = r["block.dispatch"], r["block.ready"], r["block.finish"]
        parts["block_dispatch_wait_ms"].append((d.start_ns - due) / 1e6)
        parts["dispatch_to_ready_ms"].append((rd.start_ns - d.start_ns) / 1e6)
        parts["block_ready_wait_ms"].append((f.start_ns - rd.start_ns) / 1e6)
        parts["finish_ms"].append((f.end_ns - f.start_ns) / 1e6)
    return {k: (statistics.fmean(v) if v else None) for k, v in parts.items()}
