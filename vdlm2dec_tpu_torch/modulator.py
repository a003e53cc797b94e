"""VDL Mode 2 burst modulator: synthesises IQ test/bench signals.

The reference has no transmit path; this is the inverse chain built from the
same protocol constants (sync phases d8psk.h:20-26, Gray map, scrambler,
header code, RS, HDLC).  Used by tests (golden round-trips, SNR sweeps) and
by the stimulus to generate wideband multi-channel IQ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .constants import (
    D8PSK_BITS,
    D8PSK_CENTERS_EIGHTHS,
    DEMOD_RATE,
    KEYSTREAM,
    RS_K,
    SPS,
    SYNC_PHASES,
)
from .golden.codec import (
    build_burst_bitstream,
    burst_geometry,
    header_encode,
    rs_encode_row,
    transmitted_cells,
)

TWO_PI = 2.0 * math.pi

# map 3 Gray bits -> differential phase (rad).  D8PSK_BITS row k corresponds
# to center D8PSK_CENTERS_EIGHTHS[k] * pi/8.
_BITS_TO_PHASE = {}
for _k in range(8):
    _BITS_TO_PHASE[tuple(int(b) for b in D8PSK_BITS[_k])] = (
        float(D8PSK_CENTERS_EIGHTHS[_k]) * math.pi / 8.0
    )


def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    """Scrambled channel bits -> differential phases, 3 bits/symbol.

    Trailing partial symbols are padded with zeros (the receiver discards
    surplus bits after the burst completes).
    """
    bits = np.asarray(bits, dtype=np.int64)
    pad = (-len(bits)) % 3
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.int64)])
    trip = bits.reshape(-1, 3)
    return np.array([_BITS_TO_PHASE[tuple(t)] for t in trip])


@dataclass
class BurstPlan:
    """Everything needed to synthesise one burst."""
    symbol_phases: np.ndarray      # absolute phases incl. 17 sync symbols
    length_bits: int
    nbrow: int
    nlbyte: int
    block: np.ndarray              # (nbrow, 255) the RS-encoded block


def make_burst(frames: list[np.ndarray], length_bits: int | None = None) -> BurstPlan:
    """Build the absolute symbol-phase sequence for a burst carrying frames.

    frames: list of AVLC frame *contents* (bytes between flags, without FCS).
    """
    # choose payload size: smallest that holds the HDLC bitstream.
    # A transmitter must avoid nlbyte in {0, 1, 2}:
    #   nlbyte==0 (len%1992==0): the receiver allocates an extra row whose
    #     data is never unstuffed (d8psk.c:94-95 quirk);
    #   nlbyte<=2: the FEC phase drops the last row entirely
    #     (d8psk.c:153-155) while set_eras still erases its parity region
    #     (vdlm2.c:64-82), so a 1-2 byte last row is scribbled over by RS
    #     and cannot survive.  Pad with flag bytes to nlbyte >= 3.
    probe = build_burst_bitstream(frames)
    nbytes = (len(probe) + 7) // 8
    nbytes = max(nbytes, 12)        # receiver rejects len < 96 bits
    r = nbytes % RS_K
    if r < 3:
        nbytes += 3 - r
    if length_bits is None:
        length_bits = nbytes * 8
    geom = burst_geometry(length_bits)
    if geom is None:
        raise ValueError(f"invalid burst length {length_bits}")
    nbrow, nlbyte = geom

    # lay out HDLC bits row-major into (nbrow, 249), pad with flags
    cap_bytes = RS_K * (nbrow - 1) + (nlbyte if nlbyte else RS_K)
    bits = build_burst_bitstream(frames, pad_to=cap_bytes * 8)
    data = np.zeros((nbrow, RS_K), dtype=np.uint8)
    bi = 0
    for r in range(nbrow):
        by = nlbyte if (r == nbrow - 1 and nlbyte) else RS_K
        for i in range(by):
            v = 0
            for n in range(8):
                v |= bits[bi] << n
                bi += 1
            data[r, i] = v

    # RS encode each row (last row encoded over its zero-padded 249 bytes)
    block = np.zeros((nbrow, 255), dtype=np.uint8)
    block[:, :RS_K] = data
    for r in range(nbrow):
        block[r, RS_K:] = rs_encode_row(data[r])

    # transmitted byte order: column-major with last-row truncation
    cells = transmitted_cells(nbrow, nlbyte)
    tx_bytes = np.array([block[r, c] for (r, c) in cells], dtype=np.uint8)

    # channel bits: header + data, LSB-first, scrambled
    hdr = header_encode(length_bits)
    data_bits = np.unpackbits(tx_bytes[:, None], axis=1, bitorder="little").ravel()
    chan = np.concatenate([hdr, data_bits]).astype(np.uint8)
    chan ^= KEYSTREAM[: len(chan)]

    # differential phase modulation, reference phase = last sync symbol
    dphases = bits_to_symbols(chan)
    phases = np.empty(len(SYNC_PHASES) + len(dphases))
    phases[: len(SYNC_PHASES)] = SYNC_PHASES
    acc = SYNC_PHASES[-1]
    for i, d in enumerate(dphases):
        acc += d
        phases[len(SYNC_PHASES) + i] = acc
    return BurstPlan(phases, length_bits, nbrow, nlbyte, block)


def raised_cosine_pulse(sps: int, alpha: float = 0.6, span: int = 6) -> np.ndarray:
    """Raised-cosine pulse (VDL-M2 uses alpha=0.6), span symbols each side."""
    t = np.arange(-span * sps, span * sps + 1) / sps
    denom = 1.0 - (2.0 * alpha * t) ** 2
    p = np.sinc(t) * np.where(
        np.abs(denom) < 1e-9,
        math.pi / 4.0,
        np.cos(math.pi * alpha * t) / np.where(np.abs(denom) < 1e-9, 1.0, denom),
    )
    return p


def synthesize_baseband(
    plan: BurstPlan,
    rate: int = DEMOD_RATE,
    start: int = 64,
    total: int | None = None,
    cfo_hz: float = 0.0,
    phase0: float = 0.0,
    timing_frac: float = 0.0,
    amplitude: float = 1.0,
) -> np.ndarray:
    """Linear-modulated D8PSK at `rate` (default 84 kHz, 8 samples/symbol).

    start: sample index of the first sync symbol's center.
    timing_frac: fractional-sample timing offset (0..1).
    """
    assert rate == DEMOD_RATE, "synthesize at 84 kHz; use upsample_to_wideband"
    nsym = len(plan.symbol_phases)
    if total is None:
        total = int(start + nsym * SPS + 16 * SPS)
    sig = np.zeros(total, dtype=np.complex128)
    pulse = raised_cosine_pulse(SPS)
    span = (len(pulse) - 1) // 2
    t = np.arange(total)
    for k, ph in enumerate(plan.symbol_phases):
        center = start + k * SPS + timing_frac
        lo = max(int(math.floor(center)) - span, 0)
        hi = min(int(math.ceil(center)) + span, total - 1)
        idx = np.arange(lo, hi + 1)
        pos = (idx - center) + span          # fractional index into pulse
        ok = (pos >= 0) & (pos <= len(pulse) - 1)
        pi0 = np.clip(np.floor(pos).astype(int), 0, len(pulse) - 2)
        frac = pos - pi0
        pv = np.where(ok, pulse[pi0] * (1 - frac) + pulse[pi0 + 1] * frac, 0.0)
        sig[idx] += pv * np.exp(1j * ph)
    if cfo_hz or phase0:
        sig *= np.exp(1j * (TWO_PI * cfo_hz / rate * t + phase0))
    return amplitude * sig


def upsample_to_wideband(
    bb: np.ndarray,
    fs: int,
    f_offset: float,
    total: int | None = None,
) -> np.ndarray:
    """Place an 84 kHz baseband burst at +f_offset in an fs-rate wideband.

    Linear interpolation of the baseband onto the fs grid, then mixing up.
    Good enough for test/bench stimulus (the channelizer's 25 kHz filter
    removes interpolation images far from the channel).
    """
    ratio = fs / DEMOD_RATE
    n = int(len(bb) * ratio) if total is None else total
    tt = np.arange(n) / ratio
    i0 = np.clip(np.floor(tt).astype(int), 0, len(bb) - 2)
    frac = tt - i0
    up = bb[i0] * (1 - frac) + bb[i0 + 1] * frac
    return up * np.exp(1j * TWO_PI * f_offset / fs * np.arange(n))


def awgn(sig: np.ndarray, snr_db: float, rng: np.random.Generator) -> np.ndarray:
    """Add complex AWGN at the given SNR relative to the burst's mean power."""
    p = np.mean(np.abs(sig[np.abs(sig) > 1e-6]) ** 2) if np.any(np.abs(sig) > 1e-6) else 1.0
    nvar = p / (10 ** (snr_db / 10.0))
    noise = rng.normal(size=len(sig)) + 1j * rng.normal(size=len(sig))
    return sig + noise * math.sqrt(nvar / 2.0)
