"""The plain reference of what the decoder must print, and the comparison
that decides `correct`.

A capture is synthesized from known frames, so the decoded output is known
before any decode: every burst comes back as one JSON line, on its own
channel, at its own time, with the fields that vdlm2dec's -J output gives
its frame (buildjsonobj out.c:219-253, addacarsjson outacars.c:152-212,
buildxidjson outxid.c:226-241).  `expected` renders those fields from the
generator's own record of each frame; it imports nothing of the program.

`Judge` matches the program's lines to the bursts: a line belongs to the
burst whose air span, on the line's channel, holds the line's timestamp
(time base 0: the timestamp is the sync trigger's sample over 84 kHz).

`sync_slope_hz` is the soft half of the comparison: the frequency offset
that the reference's sync fit (d8psk.c:232-333) reads at a burst's
trigger, worked out again in float64 from the capture's samples, to be held
against the offset the program yielded for that burst (its `ppm`).

`front` is the reference's receiver front in float64, the one place that
reads a capture's format: cu8 bytes less rtl_sdr's DC offset, or the
Airspy's real float32 samples with a zero imaginary part (air.c's Cbuff);
each channel is then mixed relative to Fc, or to F0 = Fc + fs/4 for the
real samples (protocol.mix_center_hz; air.c:182-185).

`unsyncable` names the bursts that vdlm2dec's own sync rule cannot catch:
where the sync error, worked out again in float64 from the capture's
samples, dips under the threshold and rises again less than one sync window
before the burst's true sync point (a trigger on the noise in front of
the burst, or on its first symbols), the decoder leaves sync search there
and is blind to the burst's preamble.  Such a burst is not owed; a line
that comes back for it must still be right.
"""
from __future__ import annotations

import bisect
import json
import math
from collections import defaultdict

import numpy as np

from .protocol import MFLT, RAW_FMT, SYNC_PHASES, mix_center_hz

DEMOD_RATE = 84_000
APP = {"name": "vdlm2dec", "ver": "2.3"}
STEPRATE = 25_000                  # the LO table's raster (vdlm2.h:33)
DC_OFFSET = float(np.float32(127.37))   # rtl_sdr's cu8 zero, a C float (rtl.c)
TAP0 = MFLT[0::4]                  # branch 0 of the matched filter, 17 taps
NBPH = 17                          # sync symbols (vdlm2.h:54)
SYMBOL_RATE = 10_500
SYNC_THRESHOLD = 4.0               # residual error under which sync fires (d8psk.c:292)
SYNC_WINDOW = 137                  # samples a trigger keeps the decoder out of sync search
# a premature dip counts where it lies under the threshold plus this much:
# the program sums in float32, so a dip at the threshold may fire there
# and not here
THRESHOLD_SLACK = 0.05
# a burst's true sync point: the 17th sync symbol's matched-filter peak
# lies 16 symbols and the 17-tap branch's half after the burst's first
# sample, plus its timing fraction; its residual reads far under 1
TRUE_SYNC = (120, 170)
TRUE_SYNC_ERR = 1.0


def freq_key(freq_hz: float) -> float:
    """The "freq" field as a number: "%3.3f" MHz cut to 7 characters."""
    return float(("%3.3f" % (freq_hz / 1e6))[:7])


def expected(burst, freq_hz: float, station: str) -> dict:
    """The JSON object (without "timestamp") vdlm2dec prints for a burst."""
    f = burst.fields
    out = {"station_id": station, "freq": freq_key(freq_hz),
           "hex": "%06X" % f["icao"], "icao": f["icao"]}
    if burst.kind == "acars":
        out.update(toaddr=f["ground"], app=APP, mode="2", label=f["label"],
                   block_id=f["bid"], ack="!", tail=f["reg_field"].lstrip("."),
                   flight=f["flight"], msgno=f["msgno"], text=f["text"])
    else:
        out.update(toaddr=0xFFFFFF, app=APP, dsta=f["dsta"],
                   lat=float(("%3.1f" % f["lat"])[:9]),
                   lon=float(("%4.1f" % f["lon"])[:9]),
                   epu=6, alt=1000 * f["alt_kft"])
    return out


class Judge:
    """Bursts of one capture, looked up by (channel, sample at 84 kHz).
    A stream that repeats the capture (a live feed in a loop) passes
    `period`, the capture's length at 84 kHz."""

    def __init__(self, bursts, freqs_hz, station: str, period: int):
        self.bursts = bursts
        self.period = period
        self.chan_of = {freq_key(f): ci for ci, f in enumerate(freqs_hz)}
        by_chan = defaultdict(list)
        for i, b in enumerate(bursts):
            by_chan[b.chan].append(i)
        self.idx = {c: sorted(v, key=lambda i: bursts[i].start)
                    for c, v in by_chan.items()}
        self.starts = {c: [bursts[i].start for i in v] for c, v in self.idx.items()}
        self.want = [expected(b, freqs_hz[b.chan], station) for b in bursts]

    def locate(self, line: str):
        """(burst index, repeat, content ok) of a line, or None when it
        belongs to no burst."""
        try:
            obj = json.loads(line)
            ci = self.chan_of[obj["freq"]]
            t0 = int(round(float(obj.pop("timestamp")) * DEMOD_RATE))
        except (ValueError, KeyError, TypeError):
            return None
        rep, s = divmod(t0, self.period)
        starts = self.starts.get(ci)
        if not starts:
            return None
        k = bisect.bisect_right(starts, s) - 1
        if k < 0:
            return None
        i = self.idx[ci][k]
        if s >= self.bursts[i].end:
            return None
        return i, rep, obj == self.want[i]


def tally(judge: Judge, lines, due, excused=()) -> dict:
    """Compare lines [(stream, text)] with the bursts due [(stream, burst
    index, repeat)].  A due burst fails when no line of its stream comes
    back for it, when its line is wrong, or when two come back; a line
    that belongs to no due burst of its stream is extra.  A burst in
    `excused` (indices) is not owed, but a line that comes back for it
    and is wrong counts as wrong."""
    due_set = set(due)
    seen = defaultdict(list)
    extra = 0
    for stream, text in lines:
        hit = judge.locate(text)
        if hit is None:
            extra += 1
            continue
        i, rep, ok = hit
        seen[(stream, i, rep)].append(ok)
    missed = wrong = 0
    bad = []
    for key in sorted(due_set):
        got = seen.get(key)
        if not got:
            missed += 1
        elif len(got) > 1 or not got[0]:
            wrong += 1
        else:
            continue
        bad.append((key, len(got or ())))
    # lines for bursts outside the due set (the block decoded after the
    # window, for instance) are neither counted nor extra, unless doubled
    for key, got in seen.items():
        if key not in due_set and len(got) > 1:
            extra += len(got) - 1
        if key not in due_set and key[1] in excused and not all(got):
            wrong += 1
            bad.append((key, len(got)))
    return {"attempted": len(due_set), "missed": missed, "wrong": wrong,
            "extra": extra, "failures": bad[:10]}


def front(raw: np.ndarray, fmt: str, n: np.ndarray) -> np.ndarray:
    """Samples n of the stream (the capture repeated end to end, as the
    live feed repeats it) in float64: cu8 bytes less the DC offset as
    re + j im; f32real samples widened, a real stream (imaginary part 0)."""
    n_raw = len(raw) // RAW_FMT[fmt][0]
    if fmt == "cu8":
        k = 2 * (n % n_raw)
        return (raw[k] - DC_OFFSET) + 1j * (raw[k + 1] - DC_OFFSET)
    return raw[n % n_raw].astype(np.float64)


def _decimate(raw: np.ndarray, fmt: str, fs: int, f_offset: float, m_lo: int,
              m_hi: int) -> np.ndarray:
    """84 kHz samples m_lo..m_hi-1 of the channel at f_offset from the
    mixer's centre, in float64: the front, the wrapped LO table,
    integrate and dump 21 / sdrclk (an 84 kHz sample m sums the inputs n
    with floor(21 n / sdrclk) = m, sdrclk = fs / 4000; d8psk.c:353-381)."""
    sdrclk = fs // 4000
    tbl = fs // STEPRATE
    m = np.arange(m_lo, m_hi)
    lo = -(-m * sdrclk // 21)
    hi = -(-(m + 1) * sdrclk // 21)
    n = np.arange(lo[0], hi[-1])
    lo_tbl = np.exp(-2j * math.pi * f_offset / fs * np.arange(tbl))
    cs = np.concatenate([[0.0], np.cumsum(front(raw, fmt, n) * lo_tbl[n % tbl])])
    return (cs[hi - lo[0]] - cs[lo - lo[0]]) / (hi - lo)


def sync_slope_hz(raw: np.ndarray, fmt: str, fs: int, f_offset: float, t0s) -> np.ndarray:
    """The frequency offset (Hz) of the sync fit at each trigger t0 (84 kHz
    samples from the stream's start) on the channel at f_offset from the
    mixer's centre, in float64, from the capture's samples (`_decimate`):
    branch 0 of the matched filter; the phases of the 17 symbols that end
    at t0 - 2, less the sync word, unwrapped step by step; the slope of
    their least-squares line (d8psk.c:219-230, 262-290)."""
    span = 8 * (NBPH - 1) + len(TAP0)          # 84 kHz samples the fit reads
    lever = np.arange(NBPH) - (NBPH - 1) // 2
    out = np.empty(len(t0s))
    for j, t0 in enumerate(t0s):
        y = _decimate(raw, fmt, fs, f_offset, int(t0) - 2 - span + 1, int(t0) - 1)
        f0 = np.array([np.dot(TAP0, y[8 * s: 8 * s + len(TAP0)]) for s in range(NBPH)])
        a = np.angle(f0) - SYNC_PHASES
        d = np.diff(a)
        cum = np.concatenate([[0.0], np.cumsum(np.where(d > math.pi, -2 * math.pi,
                                                        np.where(d < -math.pi, 2 * math.pi, 0.0)))])
        pr = a - a[0] + cum
        fr = float(np.dot(lever, pr)) / float(np.dot(lever, lever))
        out[j] = SYMBOL_RATE * fr / (2 * math.pi)
    return out


def slope_gaps(raw: np.ndarray, fmt: str, fs: int, fc_hz: float, freqs_hz, soft,
               n_max: int, seed: int) -> np.ndarray:
    """|program's offset - reference's| (Hz) over a sample, drawn from the
    seed, of the bursts with a frame that the window yielded.  soft: (N, 3)
    rows of (channel, t0, offset in Hz as the program gave it)."""
    soft = np.asarray(soft, dtype=np.float64).reshape(-1, 3)
    soft = soft[soft[:, 1] >= 400]         # the fit's history lies in the stream
    if len(soft) == 0:
        return np.zeros(0)
    rng = np.random.default_rng([seed % (1 << 62), 11])
    pick = np.sort(rng.choice(len(soft), size=min(n_max, len(soft)), replace=False))
    soft = soft[pick]
    gaps = np.empty(len(soft))
    f0 = mix_center_hz(fmt, fs, fc_hz)
    for ci in np.unique(soft[:, 0]).astype(int):
        rows = soft[:, 0] == ci
        ref = sync_slope_hz(raw, fmt, fs, freqs_hz[ci] - f0, soft[rows, 1].astype(np.int64))
        gaps[rows] = np.abs(soft[rows, 2] - ref)
    return gaps


def sync_errors(raw: np.ndarray, fmt: str, fs: int, f_offset: float, t_lo: int, t_hi: int):
    """(t, error) of the sync fit at every odd t in [t_lo, t_hi) on the
    channel at f_offset from the mixer's centre, in float64 (demodD8psk's
    WSYNC branch, d8psk.c:232-333): the phases of branch 0 of the matched
    filter at the 17 symbols that end at t, less the sync word, unwrapped
    step by step, less their mean and least-squares line; the sum of
    squared residuals."""
    t = np.arange(t_lo | 1, t_hi, 2)
    first = int(t[0]) - 8 * (NBPH - 1) - len(TAP0) + 1
    y = _decimate(raw, fmt, fs, f_offset, first, int(t[-1]) + 1)
    win = np.lib.stride_tricks.sliding_window_view(y, len(TAP0))
    ph = np.angle(win @ TAP0)                     # phase of the window ending at first+16+i
    end = t - first - len(TAP0) + 1               # index of the window ending at t
    a = ph[end[:, None] - 8 * (NBPH - 1 - np.arange(NBPH))[None, :]] - SYNC_PHASES
    d = np.diff(a, axis=1)
    step = np.where(d > math.pi, -2 * math.pi, np.where(d < -math.pi, 2 * math.pi, 0.0))
    pr = a + np.concatenate([np.zeros((len(t), 1)), np.cumsum(step, axis=1)], axis=1)
    pr = pr - pr.mean(axis=1, keepdims=True)
    lever = np.arange(NBPH) - (NBPH - 1) // 2
    fr = pr @ lever / float(lever @ lever)
    err = ((pr - fr[:, None] * lever[None, :]) ** 2).sum(axis=1)
    return t, err


def owed(t: np.ndarray, err: np.ndarray, start: int) -> bool:
    """Whether the sync rule catches the burst that starts at `start`, from
    the error at odd t around it: a trigger fires at t where the error at
    t - 2 lies under the threshold and the error rises at t; one that
    fires less than a sync window before the burst's true sync point
    keeps the decoder from it.  A burst with no clear sync point is not
    owed either."""
    e1, e0 = err[:-1], err[1:]
    tt = t[1:]
    rise = e0 > e1
    lo, hi = start + TRUE_SYNC[0], start + TRUE_SYNC[1]
    at = (tt >= lo) & (tt <= hi) & rise & (e1 < SYNC_THRESHOLD)
    if not at.any():
        return False
    i = np.flatnonzero(at)[np.argmin(e1[at])]
    if e1[i] >= TRUE_SYNC_ERR:
        return False
    early = rise & (e1 < SYNC_THRESHOLD + THRESHOLD_SLACK) & (tt < tt[i]) & (tt > tt[i] - SYNC_WINDOW)
    return not early.any()


def unsyncable(raw: np.ndarray, fmt: str, fs: int, fc_hz: float, freqs_hz, bursts) -> list:
    """Indices of the bursts that the sync rule cannot catch (`owed`)."""
    f0 = mix_center_hz(fmt, fs, fc_hz)
    out = []
    for i, b in enumerate(bursts):
        t, err = sync_errors(raw, fmt, fs, freqs_hz[b.chan] - f0,
                             b.start + TRUE_SYNC[0] - SYNC_WINDOW - 4, b.start + TRUE_SYNC[1] + 4)
        if not owed(t, err, b.start):
            out.append(i)
    return out
