"""The traced slice of a run: torch.profiler over CPU and CUDA, with the
harness's own ranges around the calls it makes, reduced to a summary that
the per-layer readers take their numbers from.

Ranges (record_function, opened by the harness only):
  stream.next  the stream generator's next(): dispatch, fetch, deframe
  output       FrameDecoder.process_burst over one block's bursts
  feed         the live cell's wait for the pipe, inside stream.next
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGES = ("stream.next", "output", "feed")
NAME_CHARS = 100                 # kernel names in the breakdown, cut


class Tracer:
    """Off: every range is a no-op.  On: `start()` opens the profiler,
    `stop()` closes it and reduces its trace (`summary`)."""

    def __init__(self, on: bool, device_type: str):
        self.on = on
        self.device_type = device_type
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def range(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def warm(self) -> None:
        """A short profile during set-up, so the profiler's first start
        (CUPTI's set-up) falls outside the window."""
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            x = torch.ones(1024, device=self.device_type)
            (x * 2).sum().item()

    def start(self) -> None:
        if not self.on or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.monotonic()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def stop(self) -> None:
        if not self.running:
            return
        if self.device_type == "cuda":
            import torch

            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.summary = reduce(events, self.t1 - self.t0)
        self.prof = None


def _union(intervals):
    """Merged [(start, end)] of intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events: list, window_s: float) -> dict:
    """Device busy time, kernel sums by name, and the device's idle gaps
    named by the harness range open on the host at the gap's middle.
    Times in the trace are microseconds on one clock for host and
    device."""
    dev, ranges = [], []
    kernels: dict[str, list] = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += dur * 1e-6
        elif cat == "user_annotation" and name in RANGES:
            ranges.append((ts, ts + dur, name))
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    ranges.sort()
    starts = [r[0] for r in ranges]
    gaps = []
    for (_s0, e0), (s1, _e1) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        # the innermost harness range open at the gap's middle; ranges
        # alternate and nest one deep, so the last few starts suffice
        name, best = "harness", None
        i = bisect.bisect_right(starts, mid)
        for rs, re_, rn in ranges[max(0, i - 4): i]:
            if mid <= re_ and (best is None or re_ - rs < best):
                best, name = re_ - rs, rn
        gaps.append((name, (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy_s, "window_s": window_s,
            "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
            "device_ops": sorted(([k[:NAME_CHARS], v[1]] for k, v in kernels.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
