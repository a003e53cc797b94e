"""Per-stage decode metrics — the framework's observability surface.

The reference has no counters (failures are silently dropped or gated behind
verbose>2, SURVEY.md section 5); here sync attempts, RS corrections, CRC
pass rate and throughput are first-class.  `PipelineMetrics` holds the
counters (`Pipeline.metrics`), `SpanLog` the streaming routes' block spans
(`Pipeline.spans`); either is off while its attribute is None.
"""
from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple


@dataclass
class PipelineMetrics:
    samples_in: int = 0              # wideband samples consumed
    decimated_samples: int = 0       # 84 kHz samples produced
    sync_candidates: int = 0         # raw triggers from the scan
    bursts_attempted: int = 0        # header-accepted bursts
    bursts_rejected_header: int = 0  # len<96 / nbrow>8 rejects
    rs_rows: int = 0
    rs_corrected_rows: int = 0       # rows with count > 0
    rs_corrections: int = 0          # total corrected bytes
    rs_failures: int = 0             # uncorrectable rows
    frames_crc_ok: int = 0
    frames_emitted: int = 0          # after L5 filters
    candidates_overflow: int = 0     # triggers dropped: max_out slots full
    wall_start: float = field(default_factory=time.time)
    # stream time of the fused route's blocks, from each block's first
    # device operation to the end of its result copy, launch gaps included
    # (CUDA events); on the CPU, where submit() runs the program, the host
    # time from dispatch to fetch; the other routes: dispatch to fetch
    device_time_s: float = 0.0
    # the fused live route: host seconds spent waiting for a block's own
    # result after its submit(), before the next read (the pipe goes
    # unread meanwhile), and the blocks it handed out
    live_result_wait_s: float = 0.0
    live_blocks: int = 0
    # bytes of raw capture the fused routes uploaded to the device
    # (dispatch_fused's block.upload), margins and padding included
    h2d_bytes: int = 0

    def observe_bursts(self, bursts) -> None:
        for b in bursts:
            self.bursts_attempted += 1
            for cnt in b.rs_counts:
                self.rs_rows += 1
                if cnt > 0:
                    self.rs_corrected_rows += 1
                    self.rs_corrections += cnt
                elif cnt < 0:
                    self.rs_failures += 1
            self.frames_crc_ok += len(b.frames)

    def snapshot(self) -> dict:
        wall = max(time.time() - self.wall_start, 1e-9)
        return {
            "samples_in": self.samples_in,
            "decimated_samples": self.decimated_samples,
            "sync_candidates": self.sync_candidates,
            "bursts_attempted": self.bursts_attempted,
            "bursts_rejected_header": self.bursts_rejected_header,
            "rs_rows": self.rs_rows,
            "rs_corrected_rows": self.rs_corrected_rows,
            "rs_corrections": self.rs_corrections,
            "rs_failures": self.rs_failures,
            "frames_crc_ok": self.frames_crc_ok,
            "frames_emitted": self.frames_emitted,
            "candidates_overflow": self.candidates_overflow,
            "wall_s": round(wall, 3),
            "device_stream_s": round(self.device_time_s, 3),
            "live_result_wait_s": round(self.live_result_wait_s, 3),
            "live_blocks": self.live_blocks,
            "h2d_bytes": self.h2d_bytes,
            "samples_per_s": round(self.samples_in / wall, 1),
            "crc_pass_per_burst": round(
                self.frames_crc_ok / max(self.bursts_attempted, 1), 4
            ),
        }

    def report(self) -> str:
        return json.dumps(self.snapshot())


SPAN_CAPACITY = 1 << 16          # records a SpanLog keeps; older ones drop


class Span(NamedTuple):
    """One span: its name, the block's sequence number (shared by the
    block's spans), the parent span's name (None at the top), the native
    id of the thread that recorded it, and start and end on
    time.monotonic_ns()."""
    name: str
    block: int
    parent: str | None
    tid: int
    start_ns: int
    end_ns: int


class _Timed:
    """The context manager of SpanLog.span."""
    __slots__ = ("log", "name", "block", "parent", "t0")

    def __init__(self, log, name, block, parent):
        self.log, self.name, self.block, self.parent = log, name, block, parent

    def __enter__(self):
        self.t0 = time.monotonic_ns()

    def __exit__(self, *_exc):
        self.log.add(self.name, self.block, self.t0, time.monotonic_ns(),
                     self.parent)


class SpanLog:
    """Block spans of the streaming routes, kept in memory in a ring of
    `capacity` records (the oldest dropped and counted in `dropped`) and
    read when the run ends (`records()`).  Host clock only: no profiler,
    and no span per burst or per kernel.  Names and sites: pipeline.py,
    PipelinedDecoder.  Thread-safe: the fetch thread records too."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self.blocks = 0                  # sequence numbers handed out
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def new_block(self) -> int:
        """The next block's sequence number."""
        with self._lock:
            self.blocks += 1
            return self.blocks - 1

    def add(self, name: str, block: int, start_ns: int, end_ns: int,
            parent: str | None = None) -> None:
        rec = Span(name, block, parent, threading.get_native_id(),
                   start_ns, end_ns)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    def span(self, name: str, block: int, parent: str | None = None) -> _Timed:
        """`with log.span(name, block):` records the block's time inside."""
        return _Timed(self, name, block, parent)

    def marker(self, block: int, parent: str):
        """A `mark(stage)` hook for device_decode_packed: each call records
        `stage.<stage>` from the previous call (or the marker's creation)
        to now."""
        last = time.monotonic_ns()

        def mark(stage: str) -> None:
            nonlocal last
            t = time.monotonic_ns()
            self.add("stage." + stage, block, last, t, parent)
            last = t
        return mark

    def records(self) -> list[Span]:
        with self._lock:
            return list(self._ring)


NO_SPAN = contextlib.nullcontext()


def timed(log: SpanLog | None, name: str, block: int,
          parent: str | None = None):
    """log.span(...), or a no-op while spans are off (log None)."""
    return NO_SPAN if log is None else log.span(name, block, parent)
