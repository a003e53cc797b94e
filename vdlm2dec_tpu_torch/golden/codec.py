"""Golden bit-level codecs: header code, RS(255,249), CRC, HDLC, scrambler.

Scalar NumPy/Python implementations pinning reference semantics:
  - header trellis decode:  viterbi.c:23-96 + d8psk.c:77-116
  - RS decode:              rs.c:81-291 (syndromes, erasure-initialised
                            Berlekamp-Massey, Chien, Forney)
  - HDLC unstuff + framing: vdlm2.c:84-161 (including the sticky-OR flag-hunt
                            quirk before the first flag)
  - frame CRC:              vdlm2.c:39-62
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    CRC_GOOD,
    CRC_INIT,
    GF_A0,
    GF_EXP,
    GF_LOG,
    HEADER_BITS,
    HEADER_H,
    HEADER_STATES,
    KEYSTREAM,
    MAX_ROWS,
    ROW_DATA_BITS,
    RS_FCR,
    RS_GEN_POLY,
    RS_K,
    RS_N,
    RS_ROOTS,
    crc_update,
    erasure_positions,
    gf_mul,
    reversebits,
)

# ----------------------------------------------------------------------------
# Scrambler
# ----------------------------------------------------------------------------


class Scrambler:
    """x^15 + x + 1 LFSR, bit = s0 ^ s14 (d8psk.c:54-65)."""

    def __init__(self, seed: int = 0x4D4B):
        self.s = seed

    def next_bit(self) -> int:
        b = (self.s ^ (self.s >> 14)) & 1
        self.s = ((self.s << 1) | b) & 0xFFFFFFFF
        return b

    def descramble_soft(self, v: float) -> float:
        return 1.0 - v if self.next_bit() else v


# ----------------------------------------------------------------------------
# (25,20) header code
# ----------------------------------------------------------------------------


def header_encode(length_bits: int) -> np.ndarray:
    """Encode a 17-bit burst length into the 25 transmitted header bits.

    Codeword layout (transmission order b0..b24): b0-b2 reserved zeros,
    b3..b19 = length LSB-first, b20..b24 = parity such that the XOR of
    HEADER_H columns over set bits is zero.
    """
    assert 0 <= length_bits < (1 << 17)
    bits = np.zeros(HEADER_BITS, dtype=np.uint8)
    for k in range(17):
        bits[3 + k] = (length_bits >> k) & 1
    syn = 0
    for n in range(20):
        if bits[n]:
            syn ^= int(HEADER_H[n])
    # parity columns H[20..24] are 0b10000 .. 0b00001
    for j in range(5):
        bits[20 + j] = (syn >> (4 - j)) & 1
    return bits


def header_decode_soft(soft: np.ndarray) -> tuple[int, float]:
    """ML decode of 25 soft bits (P(bit=1)); returns (length_bits, metric).

    Mirrors viterbi_init/viterbi_add/viterbi_end + the post-processing of
    d8psk.c:88-92 (first 3 soft values are forced to 0 by the caller there;
    we do it here).
    """
    soft = np.asarray(soft, dtype=np.float64).copy()
    soft[:3] = 0.0
    pb = np.zeros((HEADER_BITS + 1, HEADER_STATES))
    bk = np.zeros((HEADER_BITS + 1, HEADER_STATES), dtype=np.int64)
    bb = np.zeros((HEADER_BITS + 1, HEADER_STATES), dtype=np.int64)
    pb[0, 0] = 1.0
    for n in range(HEADER_BITS):
        v = soft[n]
        for s in range(HEADER_STATES):
            p = pb[n, s]
            if p == 0.0:
                continue
            ns = s ^ int(HEADER_H[n])
            np1 = p * v
            if np1 > pb[n + 1, ns]:
                pb[n + 1, ns] = np1
                bk[n + 1, ns] = s
                bb[n + 1, ns] = 1
            np0 = p * (1.0 - v)
            if np0 > pb[n + 1, s]:
                pb[n + 1, s] = np0
                bk[n + 1, s] = s
                bb[n + 1, s] = 0
    # traceback from state 0
    s = 0
    bits = 0
    b = 1
    for n in range(HEADER_BITS, 0, -1):
        if bb[n, s]:
            bits |= b
        s = int(bk[n, s])
        b <<= 1
    bits >>= 5                      # drop parity
    length = reversebits(bits, 17)
    return length, float(pb[HEADER_BITS, 0])


def burst_geometry(length_bits: int) -> tuple[int, int] | None:
    """(nbrow, nlbyte) from the decoded header length, or None if rejected.

    d8psk.c:94-107: nbrow = len/1992 + 1, nlbyte = (len%1992 + 7)/8;
    reject len < 96 or nbrow > 8.
    """
    nbrow = length_bits // ROW_DATA_BITS + 1
    nlbyte = (length_bits % ROW_DATA_BITS + 7) // 8
    if length_bits < 12 * 8 or nbrow > MAX_ROWS:
        return None
    return nbrow, nlbyte


def fec_geometry(nbrow: int, nlbyte: int) -> tuple[int, int]:
    """Reclassified (nbrow, nlbyte) for the FEC phase (d8psk.c:153-162).

    nlbyte<=2: last row carries no RS parity (row dropped for FEC);
    <=30: 2 parity bytes; <=67: 4; else all 6.
    """
    if nlbyte <= 2:
        return nbrow - 1, 0
    if nlbyte <= 30:
        return nbrow, 2
    if nlbyte <= 67:
        return nbrow, 4
    return nbrow, 0


def transmitted_cells(nbrow: int, nlbyte: int) -> list[tuple[int, int]]:
    """Ordered (row, col) cells that consume transmitted bytes.

    Column-major with last-row skipping, replicating the GETDATA/GETFEC fill
    of d8psk.c:117-205.  Data columns 0..248 then FEC columns 249..254 with
    the reclassified geometry.
    """
    cells: list[tuple[int, int]] = []
    for col in range(RS_K):
        for row in range(nbrow):
            if nlbyte and row == nbrow - 1 and col >= nlbyte:
                continue
            cells.append((row, col))
    fec_rows, fec_nl = fec_geometry(nbrow, nlbyte)
    for col in range(RS_ROOTS):
        for row in range(fec_rows):
            if fec_nl and row == fec_rows - 1 and col >= fec_nl:
                continue
            cells.append((row, col + RS_K))
    return cells


# ----------------------------------------------------------------------------
# RS(255,249)
# ----------------------------------------------------------------------------


def rs_encode_row(data249: np.ndarray) -> np.ndarray:
    """Systematic RS encode: 249 data bytes -> 6 parity bytes.

    Codeword layout matches the decoder's indexing: data[0] is the
    highest-degree coefficient, parity occupies positions 249..254.
    """
    assert len(data249) == RS_K
    # polynomial long division of data(x) * x^6 by g(x)
    rem = np.zeros(RS_ROOTS, dtype=np.int64)  # rem[0] = highest degree
    g = RS_GEN_POLY[::-1]  # high-degree first, g[0] == 1
    for byte in data249:
        feedback = int(rem[0]) ^ int(byte)
        rem[:-1] = rem[1:]
        rem[-1] = 0
        if feedback:
            for j in range(RS_ROOTS):
                rem[j] ^= gf_mul(feedback, int(g[j + 1]))
    return rem.astype(np.uint8)


def rs_decode_row(data: np.ndarray, eras_pos: list[int]) -> tuple[np.ndarray, int]:
    """Decode one 255-byte row in place semantics; returns (data, count).

    count: number of corrected positions, 0 for clean, -1 for uncorrectable
    (data returned unmodified in that case) — mirrors rs() (rs.c:81-291).
    """
    data = np.array(data, dtype=np.int64, copy=True)
    assert len(data) == RS_N
    no_eras = len(eras_pos)

    # syndromes
    s = np.zeros(RS_ROOTS, dtype=np.int64)
    for i in range(RS_ROOTS):
        acc = int(data[0])
        for j in range(1, RS_N):
            if acc == 0:
                acc = int(data[j])
            else:
                acc = int(data[j]) ^ int(GF_EXP[(int(GF_LOG[acc]) + RS_FCR + i) % 255])
        s[i] = acc
    if not s.any():
        return data.astype(np.uint8), 0
    s_log = np.array([GF_LOG[v] for v in s], dtype=np.int64)

    # erasure-initialised lambda
    lam = np.zeros(RS_ROOTS + 1, dtype=np.int64)
    lam[0] = 1
    if no_eras > 0:
        lam[1] = GF_EXP[(RS_N - 1 - eras_pos[0]) % 255]
        for i in range(1, no_eras):
            u = (RS_N - 1 - eras_pos[i]) % 255
            for j in range(i + 1, 0, -1):
                t = int(GF_LOG[lam[j - 1]])
                if t != GF_A0:
                    lam[j] ^= int(GF_EXP[(u + t) % 255])
    b = np.array([GF_LOG[v] for v in lam], dtype=np.int64)

    # Berlekamp-Massey
    el = no_eras
    for r in range(no_eras + 1, RS_ROOTS + 1):
        discr = 0
        for i in range(r):
            if lam[i] != 0 and s_log[r - i - 1] != GF_A0:
                discr ^= int(GF_EXP[(int(GF_LOG[lam[i]]) + int(s_log[r - i - 1])) % 255])
        if discr == 0:
            b[1:] = b[:-1].copy()
            b[0] = GF_A0
        else:
            dlog = int(GF_LOG[discr])
            t = np.zeros(RS_ROOTS + 1, dtype=np.int64)
            t[0] = lam[0]
            for i in range(RS_ROOTS):
                if b[i] != GF_A0:
                    t[i + 1] = lam[i + 1] ^ int(GF_EXP[(dlog + int(b[i])) % 255])
                else:
                    t[i + 1] = lam[i + 1]
            if 2 * el <= r + no_eras - 1:
                el = r + no_eras - el
                b = np.array(
                    [GF_A0 if v == 0 else (int(GF_LOG[v]) - dlog + 255) % 255 for v in lam],
                    dtype=np.int64,
                )
            else:
                b[1:] = b[:-1].copy()
                b[0] = GF_A0
            lam = t

    lam_log = np.array([GF_LOG[v] for v in lam], dtype=np.int64)
    deg_lambda = 0
    for i in range(RS_ROOTS + 1):
        if lam_log[i] != GF_A0:
            deg_lambda = i

    # Chien search
    reg = lam_log.copy()
    roots: list[int] = []
    locs: list[int] = []
    k = 0
    for i in range(1, RS_N + 1):
        q = 1
        for j in range(deg_lambda, 0, -1):
            if reg[j] != GF_A0:
                reg[j] = (reg[j] + j) % 255
                q ^= int(GF_EXP[reg[j]])
        if q == 0:
            roots.append(i)
            locs.append(k)
            if len(roots) == deg_lambda:
                break
        k = (k + 1) % 255
    if deg_lambda != len(roots):
        return data.astype(np.uint8), -1

    # omega = s * lambda mod x^6
    omega_log = np.full(RS_ROOTS + 1, GF_A0, dtype=np.int64)
    deg_omega = 0
    for i in range(RS_ROOTS):
        tmp = 0
        for j in range(min(deg_lambda, i), -1, -1):
            if s_log[i - j] != GF_A0 and lam_log[j] != GF_A0:
                tmp ^= int(GF_EXP[(int(s_log[i - j]) + int(lam_log[j])) % 255])
        if tmp != 0:
            deg_omega = i
        omega_log[i] = GF_LOG[tmp]

    # Forney
    for j in range(len(roots) - 1, -1, -1):
        num1 = 0
        for i in range(deg_omega, -1, -1):
            if omega_log[i] != GF_A0:
                num1 ^= int(GF_EXP[(int(omega_log[i]) + i * roots[j]) % 255])
        num2 = int(GF_EXP[(roots[j] * (RS_FCR - 1) + RS_N) % 255])
        den = 0
        start = min(deg_lambda, RS_ROOTS - 1) & ~1
        for i in range(start, -1, -2):
            if lam_log[i + 1] != GF_A0:
                den ^= int(GF_EXP[(int(lam_log[i + 1]) + i * roots[j]) % 255])
        if den == 0:
            return np.array(data, dtype=np.uint8), -1
        if num1 != 0:
            mag = int(
                GF_EXP[
                    (int(GF_LOG[num1]) + int(GF_LOG[num2]) + 255 - int(GF_LOG[den])) % 255
                ]
            )
            data[locs[j]] ^= mag
    return data.astype(np.uint8), len(roots)


# ----------------------------------------------------------------------------
# HDLC: frame CRC, bit stuffing (encode) and the reference unstuffer
# ----------------------------------------------------------------------------


def frame_crc_ok(frame: np.ndarray) -> bool:
    """check_frame CRC (vdlm2.c:39-62): frame includes both 0x7e flags."""
    l = len(frame)
    if l < 13:
        return False
    crc = CRC_INIT
    for i in range(1, l - 1):
        crc = crc_update(crc, int(frame[i]))
    return crc == CRC_GOOD


def frame_fcs(content: np.ndarray) -> int:
    """FCS to append to frame content so the residual check passes."""
    crc = CRC_INIT
    for b in content:
        crc = crc_update(crc, int(b))
    return crc ^ 0xFFFF


def bit_stuff(content_with_fcs: np.ndarray) -> list[int]:
    """Bits (LSB-first per byte) with a 0 inserted after five 1s."""
    out: list[int] = []
    ones = 0
    for byte in content_with_fcs:
        for n in range(8):
            bit = (int(byte) >> n) & 1
            out.append(bit)
            if bit:
                ones += 1
                if ones == 5:
                    out.append(0)
                    ones = 0
            else:
                ones = 0
    return out


FLAG_BITS = [0, 1, 1, 1, 1, 1, 1, 0]


def build_burst_bitstream(frames: list[np.ndarray], pad_to: int | None = None) -> list[int]:
    """HDLC bitstream: flag + stuffed(frame+fcs) + flag [+ flags...]."""
    bits: list[int] = list(FLAG_BITS)
    for content in frames:
        fcs = frame_fcs(content)
        payload = np.concatenate([content, [fcs & 0xFF, fcs >> 8]]).astype(np.uint8)
        bits.extend(bit_stuff(payload))
        bits.extend(FLAG_BITS)
    if pad_to is not None:
        while len(bits) < pad_to:
            bits.extend(FLAG_BITS)
        bits = bits[:pad_to]
    return bits


@dataclass
class Unstuffer:
    """The reference's exact bit-unstuff + flag-scan state machine.

    Replicates vdlm2.c:120-152 including the quirk that in flag-hunt mode
    (k == 0) completed non-flag bytes are never cleared, so later bits OR
    into the stale byte.
    """
    frames: list[np.ndarray] = field(default_factory=list)
    k: int = 0
    s: int = 0
    t: int = 0
    buf: list[int] = field(default_factory=lambda: [0])

    def push_byte(self, byte: int) -> None:
        for n in range(8):
            if byte & (1 << n):
                self.buf[self.k] |= 1 << self.s
                self.t += 1
            else:
                if self.t == 5:
                    self.t = 0
                    continue
                self.t = 0
            self.s += 1
            if self.s == 8:
                self.s = 0
                if self.buf[self.k] == 0x7E:
                    if self.k == 0:
                        self.k += 1
                        self._setcur(0)
                    elif self.k == 1:
                        self.buf[1] = 0
                    else:
                        self.frames.append(np.array(self.buf[: self.k + 1], dtype=np.uint8))
                        self.k += 1
                        self._setcur(0)
                elif self.k > 0:
                    self.k += 1
                    self._setcur(0)

    def _setcur(self, v: int) -> None:
        while len(self.buf) <= self.k:
            self.buf.append(0)
        self.buf[self.k] = v


def deframe_block(
    block: np.ndarray, nbrow: int, nlbyte: int
) -> tuple[list[np.ndarray], list[int]]:
    """Full L4: per-row RS + unstuff + flag scan over a (65,255) burst block.

    Returns (crc_valid_frames, rs_counts) where frames include both flags
    (what check_frame would have accepted).  Mirrors blk_thread
    (vdlm2.c:84-161): the RS result is *ignored* — rows always proceed to
    unstuffing.
    """
    un = Unstuffer()
    rs_counts: list[int] = []
    for r in range(nbrow):
        by = nlbyte if r == nbrow - 1 else RS_K
        eras = erasure_positions(by) if r == nbrow - 1 else []
        row, cnt = rs_decode_row(block[r], eras)
        rs_counts.append(cnt)
        for i in range(by):
            un.push_byte(int(row[i]))
    good = [f for f in un.frames if frame_crc_ok(f)]
    return good, rs_counts


def scramble_bits(bits: list[int] | np.ndarray) -> np.ndarray:
    """XOR a hard bit sequence with the burst keystream (header + data)."""
    bits = np.asarray(bits, dtype=np.uint8)
    return bits ^ KEYSTREAM[: len(bits)]
