"""SDR front-end logic and capture-file input.

The reference has no file input (initFile/runFileSample are dead
declarations, vdlm2.h:110-111); this module supplies it, plus the
center-frequency auto-choice semantics of the RTL front end (chooseFc,
rtl.c:123-160) and the airspy fs/4 arrangement (air.c:44-70,182-185).

Supported capture formats:
  cu8      interleaved unsigned 8-bit I/Q (rtl_sdr output); converted with
           the reference's empirical DC offset 127.37 (rtl.c:287-289)
  cs16     interleaved signed 16-bit I/Q
  cf32     interleaved float32 I/Q
  f32real  float32 real samples (airspy FLOAT32_REAL)
"""
from __future__ import annotations

import numpy as np

from ..constants import FREQ_MAX, FREQ_MIN, STEPRATE

RTL_DC_OFFSET = 127.37


def validate_freqs(freqs_hz: list[int]) -> list[int]:
    """Keep only frequencies inside the aviation band (rtl.c:222)."""
    return [f for f in freqs_hz if FREQ_MIN <= f <= FREQ_MAX]


def choose_fc(freqs_hz: list[int], fs: int = 2_000_000) -> int:
    """Center-frequency choice with the reference's constraints
    (chooseFc, rtl.c:123-160): every channel within the usable span, at
    least 2 channel-steps away from DC, and no two channels mirror-imaged
    about Fc.  Scans downward from max(F)+2*STEP like the reference.
    """
    fd = sorted(freqs_hz)
    if fd[-1] - fd[0] > fs - 4 * STEPRATE:
        raise ValueError("Frequencies too far apart")
    for fc in range(fd[-1] + 2 * STEPRATE, fd[0] - 2 * STEPRATE, -1):
        ok = True
        for n, f in enumerate(fd):
            if abs(fc - f) > fs // 2 - 2 * STEPRATE:
                ok = False
                break
            if abs(fc - f) < 2 * STEPRATE:
                ok = False
                break
            if n > 0 and fc - fd[n - 1] == f - fc:
                ok = False
                break
        if ok:
            return fc
    raise ValueError("No usable center frequency")


# R820T tuner gain steps in tenths of dB (librtlsdr's
# rtlsdr_get_tuner_gains for the R820T/R820T2 — what the reference's
# nearest_gain snap runs against on the usual dongle, rtl.c:162-184)
R820T_GAINS = (0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207,
               229, 254, 280, 297, 328, 338, 364, 372, 386, 402, 421,
               434, 439, 445, 480, 496)

# R820T2 IF-filter corner tables (air.c:44-45): achievable high-pass and
# low-pass corner frequencies in Hz
R820T_HF = (1953050, 1980748, 2001344, 2032592, 2060291, 2087988)
R820T_LF = (525548, 656935, 795424, 898403, 1186034, 1502073, 1715133,
            1853622)


def airspy_r2_if_filter(bw: int) -> tuple[int, int, int, int, int] | None:
    """R820T2 IF-filter selection for the Airspy R2 at 5 Msps
    (air.c:53-66): the widest high-pass corner i that still passes bw, the
    narrowest low-pass corner j that does not, and the resulting center-
    frequency offset that places the span mid-filter.  Returns
    (i, j, fc_offset, reg10, reg11); None when the span cannot fit (the
    reference returns Fc=0 -> 'Frequencies too far apart')."""
    for i in range(7, -1, -1):
        if R820T_HF[5] - R820T_LF[i] >= bw:
            break
    else:
        return None
    for j in range(5, -1, -1):
        if R820T_HF[j] - R820T_LF[i] <= bw:
            break
    else:
        j = -1
    j += 1
    j = min(j, 5)            # the reference would read past the table here
    off = (R820T_HF[j] + R820T_LF[i]) // 2 - 5_000_000 // 4
    return i, j, off, 0xB0 | (15 - j), 0xE0 | (15 - i)


def choose_fc_airspy(freqs_hz: list[int], fs: int) -> int:
    """Airspy center choice (air.c:47-70): center of the span rounded to
    the 25 kHz raster; at 5 Msps (R2) shifted by the R820T2 IF-filter
    centering offset so the whole span sits inside the analog filter."""
    lo, hi = min(freqs_hz), max(freqs_hz)
    off = 0
    if fs == 5_000_000:
        sel = airspy_r2_if_filter(hi - lo + 2 * STEPRATE)
        if sel is None:
            raise ValueError("Frequencies too far apart")
        off = sel[2]
    return ((lo + hi) // 2 + off + STEPRATE // 2) // STEPRATE * STEPRATE


def nearest_gain(target_tenths: int, gains: list[int]) -> int:
    """Snap a requested gain (tenths of dB) to the tuner's supported list
    (nearest_gain, rtl.c:162-184; first-wins on ties like the reference)."""
    if not gains:
        return 0
    close = gains[0]
    for g in gains:
        if abs(target_tenths - g) < abs(target_tenths - close):
            close = g
    return close


def match_device(spec: str, serials: list[str]) -> int:
    """Device-selection string matching (verbose_device_search,
    rtl.c:47-121): raw index, then exact serial, then prefix, then suffix
    match; -1 when nothing matches."""
    import re

    # strtol(s, &s2, 0) semantics incl. octal/hex prefixes, full consume
    m = re.fullmatch(r"[+-]?(0[xX][0-9a-fA-F]+|0[0-7]*|[1-9][0-9]*)", spec)
    if m:
        idx = int(spec, 0) if not re.fullmatch(r"[+-]?0[0-7]+", spec) \
            else int(spec, 8)
        if 0 <= idx < len(serials):
            return idx
    for i, s in enumerate(serials):
        if spec == s:
            return i
    for i, s in enumerate(serials):
        if s.startswith(spec):
            return i
    for i, s in enumerate(serials):
        if s.endswith(spec):
            return i
    return -1


def read_capture(path: str, fmt: str, count: int = -1, offset: int = 0) -> np.ndarray:
    """Read a capture file into complex64 (or float32 for f32real)."""
    if fmt == "cu8":
        raw = np.fromfile(path, dtype=np.uint8, count=count * 2 if count > 0 else -1,
                          offset=offset * 2)
        raw = raw[: len(raw) // 2 * 2].astype(np.float32) - RTL_DC_OFFSET
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "cs16":
        raw = np.fromfile(path, dtype=np.int16, count=count * 2 if count > 0 else -1,
                          offset=offset * 4)
        raw = raw[: len(raw) // 2 * 2].astype(np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "cf32":
        raw = np.fromfile(path, dtype=np.float32, count=count * 2 if count > 0 else -1,
                          offset=offset * 8)
        raw = raw[: len(raw) // 2 * 2]
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "f32real":
        return np.fromfile(path, dtype=np.float32, count=count, offset=offset * 4)
    raise ValueError(f"unknown capture format {fmt!r}")


class CaptureReader:
    """Constant-memory random access to a capture file.

    np.memmap slicing + on-the-fly conversion to complex64 (float32 for
    f32real): the streaming pipeline reads one block (+halo margins) at a
    time, so decoding a multi-GB capture never materializes it in RAM.
    Out-of-range reads zero-fill, matching the zero-history behaviour of
    the scalar chain at stream edges.
    """

    _ITEM = {
        "cu8": (np.uint8, 2),
        "cs16": (np.int16, 2),
        "cf32": (np.float32, 2),
        "f32real": (np.float32, 1),
    }

    def __init__(self, path: str, fmt: str):
        if fmt not in self._ITEM:
            raise ValueError(f"unknown capture format {fmt!r}")
        dt, per = self._ITEM[fmt]
        self.fmt = fmt
        self._per = per
        raw = np.memmap(path, dtype=dt, mode="r")
        self._raw = raw[: len(raw) // per * per]
        self.n_samples = len(self._raw) // per

    def __len__(self) -> int:
        return self.n_samples

    @property
    def raw(self) -> np.ndarray:
        """Native-dtype memmap (trimmed to whole samples) — feed this to
        the fused device-ingest path (pipeline.stream_wideband_u8)."""
        return self._raw

    def read(self, start: int, n: int) -> np.ndarray:
        """Samples [start, start+n); regions outside the capture are zero."""
        s_lo, s_hi = max(start, 0), min(start + n, self.n_samples)
        seg = np.asarray(self._raw[s_lo * self._per : s_hi * self._per])
        if self.fmt == "cu8":
            f = seg.astype(np.float32) - RTL_DC_OFFSET
            x = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
        elif self.fmt == "cs16":
            f = seg.astype(np.float32)
            x = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
        elif self.fmt == "cf32":
            x = (seg[0::2] + 1j * seg[1::2]).astype(np.complex64)
        else:
            x = seg.astype(np.float32)
        if s_lo == start and s_hi == start + n:
            return x
        out = np.zeros(n, dtype=x.dtype)
        if s_hi > s_lo:
            out[s_lo - start : s_lo - start + len(x)] = x
        return out


def write_capture(path: str, x: np.ndarray, fmt: str) -> None:
    """Inverse of read_capture, for generating test/bench fixtures."""
    if fmt == "cu8":
        inter = np.empty(2 * len(x), dtype=np.float32)
        inter[0::2] = np.real(x) + RTL_DC_OFFSET
        inter[1::2] = np.imag(x) + RTL_DC_OFFSET
        np.clip(np.round(inter), 0, 255).astype(np.uint8).tofile(path)
    elif fmt == "cs16":
        inter = np.empty(2 * len(x), dtype=np.float32)
        inter[0::2] = np.real(x)
        inter[1::2] = np.imag(x)
        np.clip(np.round(inter), -32768, 32767).astype(np.int16).tofile(path)
    elif fmt == "cf32":
        inter = np.empty(2 * len(x), dtype=np.float32)
        inter[0::2] = np.real(x)
        inter[1::2] = np.imag(x)
        inter.tofile(path)
    elif fmt == "f32real":
        np.asarray(x, dtype=np.float32).tofile(path)
    else:
        raise ValueError(f"unknown capture format {fmt!r}")
