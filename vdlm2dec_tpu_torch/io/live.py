"""Live/streaming input: read IQ blocks from a pipe or growing file.

The reference links librtlsdr/libairspy directly; this decoder instead
consumes the standard SDR tool pipelines:

    rtl_sdr -f 136900000 -s 2000000 -g 45 - | vdlm2t 136.975 --iq - ...
    airspy_rx -r /dev/stdout -f 136.8 -a 6000000 ... | vdlm2t ... --iq -

Blocks are sized to the decode pipeline's streaming core; partial tails are
carried between reads.  The fused live route reads through RawReader
instead, each read sized to the end of the segment it completes.
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np

from .sdr import RTL_DC_OFFSET

_BYTES_PER_SAMPLE = {"cu8": 2, "cs16": 4, "cf32": 8, "f32real": 4}


def stream_blocks(
    source, fmt: str, samples_per_block: int
) -> Iterator[np.ndarray]:
    """Yield fixed-size sample blocks from a binary stream.

    source: file-like with .read(n) (use sys.stdin.buffer for '-'), or a
    path.  The final partial block is zero-padded and yielded last.
    """
    own = False
    if isinstance(source, str):
        if source == "-":
            fh = sys.stdin.buffer
        else:
            fh = open(source, "rb")
            own = True
    else:
        fh = source
    bps = _BYTES_PER_SAMPLE[fmt]
    want = samples_per_block * bps
    carry = b""
    try:
        while True:
            chunk = fh.read(want - len(carry))
            if not chunk:
                break
            carry += chunk
            if len(carry) < want:
                continue
            yield _convert(carry, fmt)
            carry = b""
        if carry:
            carry += b"\x00" * (want - len(carry))
            yield _convert(carry, fmt)
    finally:
        if own:
            fh.close()


def _convert(buf: bytes, fmt: str) -> np.ndarray:
    if fmt == "cu8":
        raw = np.frombuffer(buf, dtype=np.uint8).astype(np.float32) - RTL_DC_OFFSET
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "cs16":
        raw = np.frombuffer(buf, dtype=np.int16).astype(np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "cf32":
        raw = np.frombuffer(buf, dtype=np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "f32real":
        return np.frombuffer(buf, dtype=np.float32).copy()
    raise ValueError(fmt)


_RAW_DTYPE = {"cu8": np.uint8, "cs16": np.int16, "cf32": np.float32,
              "f32real": np.float32}
_ITEMS_PER_SAMPLE = {"cu8": 2, "cs16": 2, "cf32": 2, "f32real": 1}


def stream_raw_blocks(source, fmt: str, samples_per_block: int,
                      counter: list | None = None) -> Iterator[np.ndarray]:
    """Fused fast path: yield fixed-size NATIVE-dtype raw blocks (the
    device does the format conversion).  The final partial block is padded
    with the format's neutral value (127 for cu8, 0 otherwise).  counter
    (optional [int]) is SET to the running number of REAL items read, so
    callers can distinguish stream data from padding."""
    if isinstance(source, str):
        fh = sys.stdin.buffer if source == "-" else open(source, "rb")
    else:
        fh = source
    dt = np.dtype(_RAW_DTYPE[fmt])
    want = samples_per_block * _ITEMS_PER_SAMPLE[fmt] * dt.itemsize
    pad = (np.full(1, 127, dt) if fmt == "cu8"
           else np.zeros(1, dt)).tobytes()
    carry = b""
    total_bytes = 0
    while True:
        chunk = fh.read(want - len(carry))
        if not chunk:
            break
        carry += chunk
        if counter is not None:
            # cumulative-bytes delta: per-chunk floor division would drop
            # a partial item at every read boundary
            total_bytes += len(chunk)
            counter[0] = total_bytes // dt.itemsize
        if len(carry) < want:
            continue
        yield np.frombuffer(carry, dtype=dt)
        carry = b""
    if carry:
        carry = carry[: len(carry) - len(carry) % dt.itemsize]
        carry += pad * ((want - len(carry)) // dt.itemsize)
        yield np.frombuffer(carry, dtype=dt)


def stream_raw_u8(source, samples_per_block: int) -> Iterator[np.ndarray]:
    """cu8 fast path: yield raw interleaved uint8 blocks (device converts)."""
    yield from stream_raw_blocks(source, "cu8", samples_per_block)


class RawReader:
    """Native-dtype raw items of a stream, in reads whose size the caller
    picks at each call (the fused live route asks for what its next
    segment lacks).  read(n) returns n items, or fewer only at the end of
    the stream, where a trailing partial item is dropped; `eof` is then
    set.  `nbytes` counts the bytes read and `items` the whole items among
    them, so callers can tell stream data from padding.  source: "-"
    (stdin), a path, or a binary file object."""

    def __init__(self, source, fmt: str):
        self._own = isinstance(source, str) and source != "-"
        if isinstance(source, str):
            source = sys.stdin.buffer if source == "-" else open(source, "rb")
        self._fh = source
        self.dtype = np.dtype(_RAW_DTYPE[fmt])
        self.nbytes = 0
        self.eof = False

    @property
    def items(self) -> int:
        return self.nbytes // self.dtype.itemsize

    def read(self, n: int) -> np.ndarray:
        want = n * self.dtype.itemsize
        parts, got = [], 0
        while got < want:
            chunk = self._fh.read(want - got)
            if not chunk:
                self.eof = True
                break
            parts.append(chunk)
            got += len(chunk)
        self.nbytes += got
        buf = b"".join(parts)
        return np.frombuffer(buf, dtype=self.dtype,
                             count=got // self.dtype.itemsize)

    def close(self) -> None:
        if self._own:
            self._fh.close()
