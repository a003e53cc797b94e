"""The VDL Mode 2 transmit-side protocol the traffic generator needs: the
sync word, the Gray map, the (25,20) header code, RS(255,249) over
GF(2^8), the frame FCS and the scrambler keystream; and the capture formats
a configuration may name.

Frozen copies of the port's constants.py and golden/codec.py (those two
modules are the port's own copies of the reference decoder's tables:
d8psk.h, viterbi.c, rs.c, crc.c, vdlm2.c), cut to what a transmitter
uses and to the receive filter of the reference's sync fit, so that the
benchmark imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np

DEMOD_RATE = 84_000         # decimated complex rate fed to the demod, Hz
SPS = 8                     # samples per symbol at DEMOD_RATE
RS_N = 255
RS_K = 249
RS_ROOTS = 6
RS_FCR = 120
MAX_ROWS = 8                # burst rows (d8psk.c:103)
ROW_DATA_BITS = RS_K * 8    # 1992
HEADER_BITS = 25
SCRAMBLER_SEED = 0x4D4B
MAX_BURST_SYMBOLS = -(-(HEADER_BITS + MAX_ROWS * RS_N * 8) // 3)   # 5449

# ----------------------------------------------------------------------------
# Capture formats a configuration may name under "format": the raw array's
# items per sample and the neutral pad value beyond the capture (the port's
# _tables.RAW_FMT for these formats), and the raw array's dtype.
#   cu8      rtl_sdr: interleaved unsigned bytes around 127.37 (rtl.c)
#   f32real  Airspy FLOAT32_REAL: real float32 samples, channels mixed
#            relative to F0 = Fc + fs/4 (air.c:130-141, 182-185)
# ----------------------------------------------------------------------------
RAW_FMT = {
    "cu8": (2, 127),
    "f32real": (1, 0.0),
}
RAW_DTYPE = {"cu8": np.uint8, "f32real": np.float32}


def capture_format(cfg: dict) -> str:
    """The configuration's capture format, checked: "cu8" or "f32real"."""
    fmt = cfg.get("format")
    if fmt not in RAW_FMT:
        raise ValueError(f"configuration key 'format' is {fmt!r}; "
                         f"the benchmark takes one of {sorted(RAW_FMT)}")
    return fmt


def bytes_per_sample(fmt: str) -> int:
    return RAW_FMT[fmt][0] * np.dtype(RAW_DTYPE[fmt]).itemsize


def mix_center_hz(fmt: str, fs: int, fc_hz: float) -> float:
    """The frequency each channel is mixed relative to: Fc, or F0 = Fc + fs/4
    for the Airspy's real samples (air.c:182-185)."""
    return fc_hz + fs / 4 if fmt == "f32real" else fc_hz


# ----------------------------------------------------------------------------
# Sync word: 17 absolute D8PSK phases (units of pi/8), d8psk.h:20-26
# ----------------------------------------------------------------------------
_SW_EIGHTHS = np.array(
    [2, 3, 10, 15, 8, 9, 12, 9, 2, 5, 4, 9, 4, 1, -4, -5, 2], dtype=np.float64
)
SYNC_PHASES = _SW_EIGHTHS * (math.pi / 8.0)

# ----------------------------------------------------------------------------
# Pulse / matched filter: 65 taps at 4x the 84 kHz stream (d8psk.h:28-45;
# the reference declares mflt[65] and gives 63, C zero-fills the rest).
# The receive side's sync fit (reference.sync_slope_hz) uses branch 0,
# MFLT[0::4].
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
    -0.0251715417, -0.0147744088, -0.0063474526, 0.0, 0.0,
], dtype=np.float64)

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


def reversebits(bits: int, n: int) -> int:
    """Bit-reverse the low n bits (d8psk.c:39-52)."""
    out = 0
    for _ in range(n):
        out = (out << 1) | (bits & 1)
        bits >>= 1
    return out


# ---------------------------------------------------------------- golden/codec.py

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


def frame_fcs(content: np.ndarray) -> int:
    """FCS to append to frame content so the residual check passes."""
    crc = CRC_INIT
    for b in content:
        crc = crc_update(crc, int(b))
    return crc ^ 0xFFFF
