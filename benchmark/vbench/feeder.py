"""Open-loop feeder of the live cell: a process of its own that writes a
capture into a pipe as rtl_sdr would, in 64 KiB writes on a fixed
sample-rate schedule that does not slow when the reader slows.  It knows
bytes only: the capture's native samples (cu8 bytes, f32real float32) and
a rate in bytes a second, the format's bytes a sample times fs.

    python3 feeder.py CAPTURE FD RATE_BYTES_PER_S TOTAL_WRITES

It reads the capture into memory, prints "ready", then reads the schedule's
origin (a CLOCK_MONOTONIC time, shared with the harness) from stdin.  Write
j (0-based) holds bytes [j * 64 KiB, (j + 1) * 64 KiB) of the capture
repeated end to end, as often as the feed needs, and is due when its last byte has
been captured: origin + (j + 1) * 64 KiB / rate.  A write waits for its due
time, never longer; one that a full pipe blocked goes out late, and the
next ones are due as before.  At the end (or when the reader closes the
pipe) it prints one JSON line: the writes made and how late each went out
(p50, p95, max in ms).
"""
from __future__ import annotations

import json
import os
import sys
import time

WRITE_BYTES = 65_536             # rtl_sdr's buffer (rtl.c:302)


def main(argv: list[str]) -> int:
    path, fd, rate, total = argv[0], int(argv[1]), float(argv[2]), int(argv[3])
    with open(path, "rb") as fh:
        data = fh.read()
    size = len(data)
    view = memoryview(data + data[:WRITE_BYTES])     # a write may wrap
    print("ready", flush=True)
    origin = float(sys.stdin.readline())
    period = WRITE_BYTES / rate
    late = []
    made = 0
    try:
        for j in range(total):
            due = origin + (j + 1) * period
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            late.append(time.monotonic() - due)
            lo = j * WRITE_BYTES % size
            chunk = view[lo: lo + WRITE_BYTES]
            while chunk:
                chunk = chunk[os.write(fd, chunk):]
            made += 1
    except BrokenPipeError:
        pass
    finally:
        try:
            os.close(fd)
        except OSError:
            pass
    late.sort()

    def q(p):
        return 1e3 * late[min(len(late) - 1, int(p * len(late)))] if late else 0.0

    print(json.dumps({"writes": made, "late_p50_ms": q(0.5),
                      "late_p95_ms": q(0.95), "late_max_ms": q(1.0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
