"""Golden sample-at-a-time DSP chain: mixer/decimator + D8PSK demod.

Scalar Python replica of the reference's per-channel signal path
(rcv_thread + demodD8psk + putbit, d8psk.c): the oracle that the batched
PyTorch stages are held against.  Slow by design.  numpy only; the same
code as the JAX package's golden/dsp.py, which
tests/test_torch_selfcontained.py holds it equal to.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    D8DWN,
    GRAY_TABLES,
    HEADER_BITS,
    MBUFLEN,
    MFLT,
    NBPH,
    RS_K,
    RS_ROOTS,
    SYNC_PHASES,
    SYNC_THRESHOLD,
)
from .codec import Scrambler, burst_geometry, fec_geometry, header_decode_soft

TWO_PI = 2.0 * math.pi


def mix_and_decimate(
    x: np.ndarray,
    f_offset: float,
    fs: int,
    sdrclk: int,
    lo_table_wrap: bool = True,
) -> np.ndarray:
    """Reference mixer + integrate-and-dump decimator (d8psk.c:353-381).

    x: wideband complex input at rate fs.  f_offset: channel offset Hz
    (Fr - Fc).  Output: complex stream at fs*21/sdrclk (= 84 kHz for all
    supported rates).

    lo_table_wrap=True replicates the reference's LO table of length
    fs/STEPRATE that phase-wraps (exact only when f_offset is a multiple of
    25 kHz); False uses a continuous-phase LO.
    """
    from ..constants import STEPRATE

    n = len(x)
    if lo_table_wrap:
        tbl = fs // STEPRATE
        wf = np.exp(-1j * TWO_PI * f_offset / fs * np.arange(tbl))
        lo = wf[np.arange(n) % tbl]
    else:
        lo = np.exp(-1j * TWO_PI * f_offset / fs * np.arange(n))
    mixed = np.asarray(x, dtype=np.complex128) * lo

    out = []
    acc = 0.0 + 0.0j
    nf = 0
    clk = 0
    for i in range(n):
        acc += mixed[i]
        nf += 1
        clk += 21
        if clk >= sdrclk:
            clk %= sdrclk
            out.append(acc / nf)
            acc = 0.0 + 0.0j
            nf = 0
    return np.array(out, dtype=np.complex128)


@dataclass
class GoldenBurst:
    """One demodulated burst, pre-FEC."""
    start_index: int            # decimated-sample index of the sync trigger
    length_bits: int
    nbrow: int
    nlbyte: int
    block: np.ndarray           # (nbrow, 255) uint8 with zero padding applied
    freq_offset: float          # df, rad/symbol
    timing: float               # of, quarter-sample units
    header_metric: float


@dataclass
class GoldenChannel:
    """Scalar replica of channel_t state + demodD8psk/putbit."""
    inbuff: np.ndarray = field(default_factory=lambda: np.zeros(MBUFLEN, dtype=np.complex128))
    ink: int = 0
    ph: np.ndarray = field(default_factory=lambda: np.zeros(NBPH * D8DWN))
    phidx: int = 0
    clk: int = 0
    df: float = 0.0
    p2err: float = 0.0
    perr: float = 100.0
    pfr: float = 0.0
    p1: float = 0.0
    state: str = "WSYNC"
    sample_count: int = 0

    def __post_init__(self):
        self.scrambler = Scrambler()
        self.nbits = 0
        self.bits = 0
        self.nbyte = 0
        self.nrow = 0
        self.nbrow = 0
        self.nlbyte = 0
        self.header_soft: list[float] = []
        self.block = np.zeros((9, 255), dtype=np.uint8)
        self.cur: GoldenBurst | None = None
        self.bursts: list[GoldenBurst] = []
        self.sync_errs: list[tuple[int, float, float]] = []  # (t, err, fr)

    # -- polyphase matched filter (filteredphase, d8psk.c:219-230) ----------
    def filtered_phase(self) -> float:
        s = 0.0 + 0.0j
        i = self.clk
        k = self.ink
        while i < len(MFLT):
            s += self.inbuff[k] * MFLT[i]
            i += 4
            k = (k + 1) % MBUFLEN
        return math.atan2(s.imag, s.real)

    # -- one decimated input sample (demodD8psk, d8psk.c:232-333) -----------
    def push(self, e: complex) -> None:
        self.inbuff[self.ink] = e
        self.ink = (self.ink + 1) % MBUFLEN
        self.clk += 4
        t = self.sample_count
        self.sample_count += 1

        if self.state == "WSYNC":
            if self.clk < 8:
                return
            self.clk -= 8
            p = self.filtered_phase()
            self.phidx = (self.phidx + 1) % (NBPH * D8DWN)
            self.ph[self.phidx] = p

            pu = 0.0
            pr = np.zeros(NBPH)
            pr[0] = self.ph[(self.phidx + D8DWN) % (NBPH * D8DWN)] - SYNC_PHASES[0]
            pv = pr[0]
            m = pr[0]
            for l in range(1, NBPH):
                pc = self.ph[(self.phidx + (l + 1) * D8DWN) % (NBPH * D8DWN)] - SYNC_PHASES[l]
                pd = pc - pv
                pv = pc
                if pd > math.pi:
                    pu -= TWO_PI
                elif pd < -math.pi:
                    pu += TWO_PI
                pr[l] = pc + pu
                m += pr[l]
            m /= NBPH
            fr = 0.0
            for l in range(NBPH):
                pr[l] -= m
                fr += pr[l] * (l - (NBPH - 1) // 2)
            fr /= 408.0
            err = 0.0
            for l in range(NBPH):
                e2 = pr[l] - (l - (NBPH - 1) // 2) * fr
                err += e2 * e2
            self.sync_errs.append((t, err, fr))

            if self.perr < SYNC_THRESHOLD and err > self.perr:
                of = 4.0 * (self.p2err - 4.0 * self.perr + 3.0 * err) / (
                    self.p2err - 2.0 * self.perr + err
                )
                self.state = "GETHEAD"
                self.nbits = 0
                self.scrambler = Scrambler()
                self.header_soft = []
                self.df = self.pfr
                self.clk = int(round(of))
                self.p1 = self.filtered_phase()
                self.cur = GoldenBurst(
                    start_index=t, length_bits=0, nbrow=0, nlbyte=0,
                    block=None, freq_offset=self.df, timing=of, header_metric=0.0,
                )
                self.perr = self.p2err = 500.0
            else:
                self.p2err = self.perr
                self.perr = err
                self.pfr = fr
        else:
            if self.clk < 32:
                return
            self.clk -= 32
            p = self.filtered_phase()
            d = (p - self.p1) - self.df
            if d > math.pi:
                d -= TWO_PI
            if d < -math.pi:
                d += TWO_PI
            self.put_gray(d)
            self.p1 = p

    # -- putgreycode (d8psk.c:211-217) --------------------------------------
    def put_gray(self, v: float) -> None:
        i = int(round(128.0 * v / math.pi + 128.0))
        for b in range(3):
            self.put_bit(float(GRAY_TABLES[b, i]))

    # -- putbit (d8psk.c:67-209) --------------------------------------------
    def put_bit(self, sv: float) -> None:
        v = self.scrambler.descramble_soft(sv)
        if self.state == "WSYNC":
            return
        if self.state == "GETHEAD":
            if self.nbits < 3:
                v = 0.0
            self.header_soft.append(v)
            self.nbits += 1
            if self.nbits < HEADER_BITS:
                return
            length, metric = header_decode_soft(np.array(self.header_soft))
            geom = burst_geometry(length)
            if geom is None:
                self.state = "WSYNC"
                self.cur = None
                return
            self.nbrow, self.nlbyte = geom
            self.cur.length_bits = length
            self.cur.nbrow, self.cur.nlbyte = geom
            self.cur.header_metric = metric
            self.block = np.zeros((9, 255), dtype=np.uint8)
            self.state = "GETDATA"
            self.nrow = self.nbyte = 0
            self.nbits = 0
            self.bits = 0
            return
        if self.state == "GETDATA":
            if v > 0.5:
                self.bits |= 1 << self.nbits
            self.nbits += 1
            if self.nbits < 8:
                return
            self.block[self.nrow, self.nbyte] = self.bits
            self.nbits = 0
            self.bits = 0
            self.nrow += 1
            if self.nrow == self.nbrow:
                self.nrow = 0
                self.nbyte += 1
            if self.nlbyte:
                while (
                    self.nrow == self.nbrow - 1
                    and self.nbyte >= self.nlbyte
                    and self.nbyte < RS_K
                ):
                    self.block[self.nrow, self.nbyte] = 0
                    self.nrow = 0
                    self.nbyte += 1
            if self.nbyte == RS_K:
                self.state = "GETFEC"
                self.nrow = self.nbyte = 0
                self.nbrow, self.nlbyte = fec_geometry(self.nbrow, self.nlbyte)
            return
        if self.state == "GETFEC":
            if v > 0.5:
                self.bits |= 1 << self.nbits
            self.nbits += 1
            if self.nbits < 8:
                return
            self.block[self.nrow, self.nbyte + RS_K] = self.bits
            self.nbits = 0
            self.bits = 0
            self.nrow += 1
            if self.nrow == self.nbrow:
                self.nrow = 0
                self.nbyte += 1
            if self.nlbyte:
                while (
                    self.nrow == self.nbrow - 1
                    and self.nbyte >= self.nlbyte
                    and self.nbyte < RS_ROOTS
                ):
                    self.block[self.nrow, self.nbyte + RS_K] = 0
                    self.nrow = 0
                    self.nbyte += 1
            if self.nbyte == RS_ROOTS:
                # burst complete; note geometry stored pre-FEC-reclass
                self.cur.block = self.block[: self.cur.nbrow].copy()
                self.bursts.append(self.cur)
                self.cur = None
                self.state = "WSYNC"
            return

    def run(self, samples: np.ndarray) -> list[GoldenBurst]:
        for e in samples:
            self.push(complex(e))
        return self.bursts
