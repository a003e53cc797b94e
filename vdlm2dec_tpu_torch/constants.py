"""Protocol constants for the VDL Mode 2 decode framework.

Everything here is a *protocol-level* constant (sync word, pulse shape,
soft-decision tables, field tables, CRC polynomial).  Wherever the value can
be derived from a published formula we generate it at import time instead of
embedding literal tables; derivations are cross-checked against the reference
decoder's committed tables in tests.

Reference provenance (semantics only; file:line of the reference decoder's
C sources):
  - sync word phases:        d8psk.h:20-26
  - matched-filter pulse:    d8psk.h:28-45 (empirical 65-tap table, 4x
                             fractional-timing resolution over the 84 kHz
                             symbol-domain stream)
  - Gray soft tables:        generated from a von Mises phase-noise model,
                             kappa=10 (generator ggrey.c:60-103)
  - (25,20) header code:     viterbi.c:29-35
  - RS(255,249) GF(2^8):     rs.c:17-79 (primitive poly 0x187, FCR=120)
  - CRC-CCITT (PPP FCS16):   crc.c / vdlm2.c:29-30
  - scrambler:               x^15 + x + 1, seed 0x4D4B (d8psk.c:54-65,299)
"""
from __future__ import annotations

import math

import numpy as np

# ----------------------------------------------------------------------------
# Rates and sizes
# ----------------------------------------------------------------------------
STEPRATE = 25_000           # VDL channel raster, Hz (vdlm2.h:33)
SYMBOL_RATE = 10_500        # D8PSK symbols/s
DEMOD_RATE = 84_000         # decimated complex rate fed to the demod,
                            # = 8 samples/symbol (d8psk.c:374-377 invariant)
SPS = 8                     # samples per symbol at DEMOD_RATE
MFLTLEN = 65                # pulse filter taps at 4x DEMOD_RATE (vdlm2.h:37)
MBUFLEN = 17                # demod ring length in DEMOD_RATE samples
NBPH = 17                   # sync correlation window, symbols (vdlm2.h:54)
D8DWN = 4                   # phase-history downsample stride (vdlm2.h:55)
SYNC_THRESHOLD = 4.0        # residual-error threshold (d8psk.c:292)

MAXNBCHANNELS = 8           # reference CLI limit (vdlm2.h:26); ours is soft
RS_N = 255
RS_K = 249
RS_ROOTS = 6
RS_FCR = 120
MAX_ROWS = 8                # burst rows (d8psk.c:103)
ROW_DATA_BYTES = RS_K       # 249 data bytes per RS row
ROW_DATA_BITS = ROW_DATA_BYTES * 8  # 1992
HEADER_BITS = 25
SCRAMBLER_SEED = 0x4D4B

FREQ_MIN = 118_000_000      # valid VHF aviation band (rtl.c:222)
FREQ_MAX = 138_000_000

# Maximum channel bits a burst can consume after the header:
# 8 rows x 255 cols x 8 bits (data 249 cols + 6 FEC cols).
MAX_BURST_DATA_BITS = MAX_ROWS * RS_N * 8          # 16320
MAX_BURST_BITS = HEADER_BITS + MAX_BURST_DATA_BITS  # 16345
MAX_BURST_SYMBOLS = -(-MAX_BURST_BITS // 3)         # 5449

# ----------------------------------------------------------------------------
# Sync word: 17 absolute D8PSK phases (units of pi/8), d8psk.h:20-26
# ----------------------------------------------------------------------------
_SW_EIGHTHS = np.array(
    [2, 3, 10, 15, 8, 9, 12, 9, 2, 5, 4, 9, 4, 1, -4, -5, 2], dtype=np.float64
)
SYNC_PHASES = _SW_EIGHTHS * (math.pi / 8.0)

# ----------------------------------------------------------------------------
# Pulse / matched filter: 65 taps at 4x the 84 kHz stream (d8psk.h:28-45).
# This is an empirical interoperability table, kept verbatim.
# ----------------------------------------------------------------------------
MFLT = np.array([
    -0.0063474526, -0.0147744088, -0.0251715417, -0.0372531112,
    -0.0505438764, -0.0643762574, -0.0778990609, -0.0900984580,
    -0.0998311862, -0.1058691815, -0.1069540690, -0.1018592183,
    -0.0894564364, -0.0687838818, -0.0391114778, 0.0000000000,
    0.0486498533, 0.1065617468, 0.1730641128, 0.2470886715,
    0.3271881497, 0.4115732615, 0.4981679546, 0.5846808858,
    0.6686901328, 0.7477373336, 0.8194268281, 0.8815249907,
    0.9320548266, 0.9693810568, 0.9922813460, 1.0000000000,
    0.9922813460, 0.9693810568, 0.9320548266, 0.8815249907,
    0.8194268281, 0.7477373336, 0.6686901328, 0.5846808858,
    0.4981679546, 0.4115732615, 0.3271881497, 0.2470886715,
    0.1730641128, 0.1065617468, 0.0486498533, 0.0000000000,
    -0.0391114778, -0.0687838818, -0.0894564364, -0.1018592183,
    -0.1069540690, -0.1058691815, -0.0998311862, -0.0900984580,
    -0.0778990609, -0.0643762574, -0.0505438764, -0.0372531112,
    -0.0251715417, -0.0147744088, -0.0063474526,
    # the reference declares mflt[65] but initialises only 63 entries; C
    # zero-fills the remainder (d8psk.h:28-45 + vdlm2.h:37)
    0.0, 0.0,
], dtype=np.float64)
assert len(MFLT) == MFLTLEN


def polyphase_taps() -> np.ndarray:
    """(4, 17) polyphase decomposition of MFLT.

    Phase p uses taps MFLT[p::4]; phases 1..3 have 16 taps and are
    zero-padded at the end (matches the i < MFLTLEN loop bound of
    filteredphase, d8psk.c:219-230).
    """
    out = np.zeros((4, MBUFLEN), dtype=np.float64)
    for p in range(4):
        taps = MFLT[p::4]
        out[p, : len(taps)] = taps
    return out


POLYPHASE = polyphase_taps()

# ----------------------------------------------------------------------------
# Gray soft-decision tables, generated from the von Mises model (ggrey.c).
#
# The 8 differential phases sit at odd multiples of pi/8.  For a measured
# differential phase v (index i = round(128*v/pi + 128), i in [0, 256]):
#   bit 0 = 1 for the 4 negative-phase symbols
#   bit 1 = 1 for |phase| > pi/2 symbols
#   bit 2 = 1 for the middle-magnitude symbols (+-3pi/8, +-5pi/8)
# P(bit=1 | v) = sum of von Mises densities (kappa=10) at that bit's symbol
# centers divided by the sum over all 8 centers.  Values are rounded to six
# decimals to match the tables the reference decoder ships.
# ----------------------------------------------------------------------------
GRAY_KAPPA = 10.0

# center phase (units of pi/8) -> (bit0, bit1, bit2); Gray mapping
D8PSK_CENTERS_EIGHTHS = np.array([1, 3, 5, 7, -1, -3, -5, -7], dtype=np.float64)
D8PSK_BITS = np.array([
    [0, 0, 0],   # +pi/8
    [0, 0, 1],   # +3pi/8
    [0, 1, 1],   # +5pi/8
    [0, 1, 0],   # +7pi/8
    [1, 0, 0],   # -pi/8
    [1, 0, 1],   # -3pi/8
    [1, 1, 1],   # -5pi/8
    [1, 1, 0],   # -7pi/8
], dtype=np.int32)


def _von_mises(x: np.ndarray, kappa: float) -> np.ndarray:
    # i0 is fine here; ggrey.c uses an Abramowitz&Stegun polynomial i0 but the
    # constant cancels in the ratio below anyway.
    return np.exp(kappa * np.cos(x))


def generate_gray_tables() -> np.ndarray:
    """(3, 257) tables of P(bit_k = 1 | phase index)."""
    i = np.arange(-128, 129, dtype=np.float64)
    v = i * math.pi / 128.0                       # measured phase
    centers = D8PSK_CENTERS_EIGHTHS * math.pi / 8.0
    dens = _von_mises(centers[None, :] - v[:, None], GRAY_KAPPA)  # (257, 8)
    total = dens.sum(axis=1)
    tables = np.empty((3, 257), dtype=np.float64)
    for b in range(3):
        mask = D8PSK_BITS[:, b] == 1
        tables[b] = dens[:, mask].sum(axis=1) / total
    return np.round(tables, 6)


GRAY_TABLES = generate_gray_tables()

# ----------------------------------------------------------------------------
# (25,20) header block code (viterbi.c:29-35).
# Column n of the parity-check matrix, as a 5-bit integer.  Bits 0-2 of the
# codeword are reserved (always 0), bits 3-19 carry the burst length LSB
# first, bits 20-24 are parity (unit columns).
# ----------------------------------------------------------------------------
HEADER_H = np.array([
    0b00110, 0b00111, 0b01001, 0b01010, 0b01011,
    0b01100, 0b01110, 0b01111, 0b10001, 0b10011,
    0b10101, 0b10110, 0b11000, 0b11001, 0b11010,
    0b11011, 0b11100, 0b11101, 0b11110, 0b11111,
    0b10000, 0b01000, 0b00100, 0b00010, 0b00001,
], dtype=np.int32)
HEADER_STATES = 32

# ----------------------------------------------------------------------------
# GF(2^8) for RS(255,249): primitive polynomial x^8+x^7+x^2+x+1 (0x187),
# first consecutive root alpha^120, primitive element alpha (PRIM=1).
# Tables generated, not copied (values verified against rs.c in tests).
# ----------------------------------------------------------------------------
GF_POLY = 0x187


def generate_gf_tables() -> tuple[np.ndarray, np.ndarray]:
    alpha_to = np.zeros(256, dtype=np.int64)   # alpha_to[255] = 0 sentinel
    index_of = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        alpha_to[i] = x
        index_of[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    alpha_to[255] = 0
    index_of[0] = 255          # A0 sentinel: log(0)
    return alpha_to, index_of


GF_EXP, GF_LOG = generate_gf_tables()
GF_A0 = 255


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] + GF_LOG[b]) % 255])


def rs_generator_poly() -> np.ndarray:
    """Generator polynomial of RS(255,249): prod_{i=0..5} (x - alpha^(FCR+i)).

    Returned low-degree-first, length 7, g[6] = 1.
    """
    g = np.zeros(RS_ROOTS + 1, dtype=np.int64)
    g[0] = 1
    deg = 0
    for i in range(RS_ROOTS):
        root = int(GF_EXP[(RS_FCR + i) % 255])
        # multiply g by (x + root)  (GF(2): minus == plus)
        ng = np.zeros_like(g)
        for j in range(deg + 1):
            ng[j + 1] ^= g[j]
            ng[j] ^= gf_mul(int(g[j]), root)
        g = ng
        deg += 1
    return g


RS_GEN_POLY = rs_generator_poly()

# ----------------------------------------------------------------------------
# CRC-CCITT (PPP FCS-16, reflected, poly 0x8408).  Table generated; verified
# against crc.c in tests.  Frame check: init 0xffff, residual 0xf0b8
# (vdlm2.c:29-30).  ACARS inner CRC: init 0, residual 0 (outacars.c:222-231).
# ----------------------------------------------------------------------------
CRC_INIT = 0xFFFF
CRC_GOOD = 0xF0B8
CRC_POLY_REFLECTED = 0x8408


def generate_crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for b in range(256):
        v = b
        for _ in range(8):
            v = (v >> 1) ^ CRC_POLY_REFLECTED if (v & 1) else (v >> 1)
        table[b] = v
    return table


CRC_TABLE = generate_crc_table()


def crc_update(crc: int, byte: int) -> int:
    """One step of the reference's update_crc macro (crc.h:3)."""
    return ((crc >> 8) ^ int(CRC_TABLE[(crc ^ byte) & 0xFF])) & 0xFFFF


# ----------------------------------------------------------------------------
# Scrambler keystream: x^15 + x + 1, seed 0x4D4B at every sync (d8psk.c:54-65).
# The whole per-burst keystream is a constant; precompute it once.
# ----------------------------------------------------------------------------

def generate_keystream(n: int, seed: int = SCRAMBLER_SEED) -> np.ndarray:
    out = np.empty(n, dtype=np.uint8)
    s = seed
    for i in range(n):
        b = (s ^ (s >> 14)) & 1
        s = ((s << 1) | b) & 0xFFFFFFFF
        out[i] = b
    return out


# 3 bits/symbol: the demod consumes whole symbols, so the keystream must
# cover 3 * MAX_BURST_SYMBOLS bits (the trailing partial symbol included)
KEYSTREAM = generate_keystream(3 * MAX_BURST_SYMBOLS)

# ----------------------------------------------------------------------------
# Erasure patterns for shortened last rows (vdlm2.c:64-82): nlbyte<=30 ->
# positions 251..254 erased; nlbyte<=67 -> 253..254; else none.
# ----------------------------------------------------------------------------

def erasure_positions(last_row_bytes: int) -> list[int]:
    if last_row_bytes <= 30:
        return [251, 252, 253, 254]
    if last_row_bytes <= 67:
        return [253, 254]
    return []


def reversebits(bits: int, n: int) -> int:
    """Bit-reverse the low n bits (d8psk.c:39-52)."""
    out = 0
    for _ in range(n):
        out = (out << 1) | (bits & 1)
        bits >>= 1
    return out
