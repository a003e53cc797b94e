"""Numpy-only tables and host helpers of the decode path.

The JAX package builds these tables inside its channelizer, demod, header,
assembly, RS and pipeline modules.  This package rebuilds them here, in
plain numpy, from its own `constants`; `tests/test_torch_tables.py` holds
every table equal to its JAX original.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .constants import (
    GF_A0,
    GF_EXP,
    GF_LOG,
    GRAY_TABLES,
    HEADER_H,
    HEADER_STATES,
    KEYSTREAM,
    MAX_BURST_SYMBOLS,
    MAX_ROWS,
    MBUFLEN,
    MFLT,
    POLYPHASE,
    RS_FCR,
    RS_K,
    RS_N,
    RS_ROOTS,
    STEPRATE,
    SYNC_PHASES,
)

TWO_PI = 2.0 * math.pi

# left history a block needs: filter ring + sync window + hysteresis
HALO_LEFT = 160

# ---------------------------------------------------------------- channelizer


def period_for(sdrclk: int) -> tuple[int, int]:
    """(input samples, output samples) of one decimation period."""
    p_in = 4 * sdrclk
    p_out = p_in * 21 // sdrclk          # = 84
    assert p_in * 21 % sdrclk == 0
    return p_in, p_out


def aggregation_matrix(sdrclk: int) -> np.ndarray:
    """(P_in, 84) float32 integrate-and-dump: A[n, m] = 1/len_m if input
    n feeds output m, i.e. floor(21 n / sdrclk) == m (d8psk.c:353-381)."""
    p_in, p_out = period_for(sdrclk)
    owner = (21 * np.arange(p_in)) // sdrclk
    a = np.zeros((p_in, p_out), dtype=np.float64)
    for m in range(p_out):
        idx = np.nonzero(owner == m)[0]
        a[idx, m] = 1.0 / len(idx)
    return a.astype(np.float32)


def fir_aggregation_matrix(sdrclk: int, fs: int, n_taps: int = 531,
                           cutoff_hz: float = 12_500.0,
                           beta: float = 8.0) -> tuple[np.ndarray, int]:
    """FIR alternative to the boxcar integrate-and-dump: the (P_in +
    2 pad, 84) float32 Kaiser-windowed-sinc decimation matrix and pad.
    Output m keeps the boxcar window's center as its instant; the taps
    spill pad samples into the neighbouring periods."""
    p_in, p_out = period_for(sdrclk)
    owner = (21 * np.arange(p_in)) // sdrclk
    centers = np.array(
        [np.nonzero(owner == m)[0].mean() for m in range(p_out)])
    pad = (n_taps - 1) // 2
    n = np.arange(-pad, pad + 1)
    x = 2.0 * cutoff_hz / fs * n
    h = (2.0 * cutoff_hz / fs) * np.sinc(x)
    h *= np.kaiser(n_taps, beta)
    h /= h.sum()
    a = np.zeros((p_in + 2 * pad, p_out), dtype=np.float64)
    grid = np.arange(p_in + 2 * pad) - pad       # raw index within period
    for m in range(p_out):
        rel = grid - centers[m]
        ok = np.abs(rel) <= pad
        idx = np.round(rel[ok]).astype(int) + pad
        a[ok, m] = h[idx]
    return a.astype(np.float32), pad


def lo_tables(f_offsets, fs: int, sdrclk: int,
              wrap: bool) -> tuple[np.ndarray, int]:
    """Per-channel base LO over one period, (C, P_in) complex64, and the
    reference's LO table length fs/25 kHz.  wrap=True replicates the
    reference's phase-wrapping table; wrap=False is a continuous LO."""
    p_in, _ = period_for(sdrclk)
    tbl = fs // STEPRATE
    assert p_in % tbl == 0 or not wrap
    n = np.arange(p_in)
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    idx = n % tbl if wrap else n
    lo = np.exp(-1j * TWO_PI * fo / fs * idx)
    return lo.astype(np.complex64), tbl


def period_phases(f_offsets, fs: int, sdrclk: int, wrap: bool,
                  n_periods: int, start_period: int = 0) -> np.ndarray:
    """(C, B) complex64 LO phase at each period start: exactly 1 with the
    wrapped table, exp(-j 2 pi fo P_in / fs) per period otherwise."""
    p_in, _ = period_for(sdrclk)
    if wrap:
        return np.ones((len(f_offsets), n_periods), dtype=np.complex64)
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    p = np.arange(start_period, start_period + n_periods)[None, :]
    ang = -TWO_PI * fo * (p_in / fs) * p
    return np.exp(1j * ang).astype(np.complex64)


def _near_sqrt_factors(n: int) -> tuple[int, int]:
    """n = a*b with a <= b and b-a minimal (FFT radix split)."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def pfb_tables(f_offsets, fs: int, sdrclk: int):
    """Factorized-DFT filterbank tables: all tbl = fs/25 kHz raster bins
    as DFT_a -> twiddle -> DFT_b with tbl = a*b.  Returns (a, b, dft_a
    (a, a, 2), twiddle (a, b, 2), dft_b (b, b, 2), bins (C, 2) int32
    [k1, k2]) with k = k1 + a*k2 = fo/25 kHz mod tbl."""
    tbl = fs // STEPRATE
    a, b = _near_sqrt_factors(tbl)
    for fo in f_offsets:
        k = fo / STEPRATE
        assert abs(k - round(k)) < 1e-9, (
            f"pfb channelizer needs raster-aligned offsets, got {fo}")
    bins = np.array([int(round(fo / STEPRATE)) % tbl for fo in f_offsets],
                    dtype=np.int64)
    k1, k2 = bins % a, bins // a
    r1 = np.arange(a)
    r2 = np.arange(b)
    dft_a = np.exp(-2j * np.pi * np.outer(r1, r1) / a)        # [k1, r1]
    tw = np.exp(-2j * np.pi * np.outer(r1, r2) / tbl)         # [k1, r2]
    dft_b = np.exp(-2j * np.pi * np.outer(r2, r2) / b)        # [k2, r2]

    def planes(m):
        return np.stack([m.real, m.imag], axis=-1).astype(np.float32)

    return (a, b, planes(dft_a), planes(tw), planes(dft_b),
            np.stack([k1, k2], axis=1).astype(np.int32))


def dft_qr_tables(f_offsets, fs: int, sdrclk: int,
                  split: bool) -> tuple[np.ndarray, np.ndarray]:
    """Residue-space channelizer tables: (w (C, tbl) complex64, a2 (Q, tbl,
    p_out) float32) with

        z[b, r, m] = sum_q x[b, q, r] * a2[q, r, m]
        y[c, b, m] = sum_r w[c, r] * z[b, r, m]

    the same products as the wrapped-LO mix + integrate-and-dump.
    split=True permutes the residue axis to the split-phase cu8 plane
    layout [even samples | odd samples] (ops.ingest.raw_to_planes_split)."""
    p_in, p_out = period_for(sdrclk)
    tbl = fs // STEPRATE
    assert p_in % tbl == 0
    q_n = p_in // tbl
    owner = (21 * np.arange(p_in)) // sdrclk
    invlen = 1.0 / np.bincount(owner, minlength=p_out)
    n = np.arange(p_in)
    a2 = np.zeros((q_n, tbl, p_out), dtype=np.float64)
    a2[n // tbl, n % tbl, owner] = invlen[owner]
    fo = np.asarray(f_offsets, dtype=np.float64)[:, None]
    w = np.exp(-1j * TWO_PI * fo / fs * np.arange(tbl)[None, :])
    if split:
        assert tbl % 2 == 0
        rho = np.concatenate([2 * np.arange(tbl // 2),
                              2 * np.arange(tbl // 2) + 1])
        a2 = a2[:, rho, :]
        w = w[:, rho]
    return w.astype(np.complex64), a2.astype(np.float32)


def resolve_chan_impl(f_offsets, fs: int, sdrclk: int, lo_wrap: bool = True,
                      filter_mode: str = "boxcar",
                      use_pallas: bool = False) -> str:
    """"dft" when the residue-space channelizer is exact for the plan
    (25 kHz-raster offsets, wrapped LO, boxcar), else "matmul"."""
    p_in, _ = period_for(sdrclk)
    tbl = fs // STEPRATE
    on_raster = all(
        abs(f - STEPRATE * round(f / STEPRATE)) < 1e-6 for f in f_offsets)
    if (not use_pallas and lo_wrap and filter_mode == "boxcar"
            and fs % STEPRATE == 0 and tbl > 0 and p_in % tbl == 0
            and on_raster):
        return "dft"
    return "matmul"


# ---------------------------------------------------------------- demod

POLY32 = POLYPHASE.astype(np.float32)            # (4, 17) matched filter
GRAY32 = GRAY_TABLES.T.astype(np.float32)        # (257, 3) exact soft bits
SW32 = SYNC_PHASES.astype(np.float32)            # (17,) sync word phases
KS = KEYSTREAM.astype(np.bool_)                  # descrambler keystream
SLOPE_NORM = 408.0                               # sum_l (l-8)^2

# trigger-time taps for clk0 in 0..12: row c = MFLT[c::4], zero-padded
EXT_TAPS = np.zeros((13, MBUFLEN), dtype=np.float32)
for _c in range(13):
    _t = MFLT[_c::4]
    EXT_TAPS[_c, : len(_t)] = _t


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> nearest bfloat16 (ties to even), returned as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = bits.astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32)


def gray_soft_table() -> np.ndarray:
    """(257, 3) float32 soft bits exactly as the JAX demod's lookup returns
    them: the table is split into two bfloat16 parts (hi + residual) and
    summed in float32, which differs from GRAY_TABLES by up to ~1e-5."""
    g = GRAY_TABLES.T.astype(np.float32)
    hi = _bf16_round(g)
    lo = _bf16_round(g - hi)
    return (hi + lo).astype(np.float32)


GRAY_SOFT = gray_soft_table()

# ---------------------------------------------------------------- header

# state s receives its bit-1 path from s ^ H[n]
PERM = np.stack([np.arange(HEADER_STATES) ^ int(h) for h in HEADER_H])

# ---------------------------------------------------------------- assembly

MAX_TX_BYTES = MAX_ROWS * RS_N            # 2040
N_GEOM = (MAX_ROWS + 1) * 250             # nbrow 0..8, nlbyte 0..249


def inverse_fill_tables() -> tuple[np.ndarray, np.ndarray]:
    """(G, 8, 255) int16 map (row, col) -> transmitted byte index (-1 for
    zero-padded cells) and (G,) int32 consumed-byte counts, g =
    nbrow*250 + nlbyte (d8psk.c:117-205 fill order)."""
    inv = np.full((N_GEOM, MAX_ROWS, RS_N), -1, dtype=np.int16)
    counts = np.zeros(N_GEOM, dtype=np.int32)
    for nbrow in range(1, MAX_ROWS + 1):
        for nlbyte in range(250):
            g = nbrow * 250 + nlbyte
            mask_d = np.ones((RS_K, nbrow), dtype=bool)
            if nlbyte:
                mask_d[nlbyte:, nbrow - 1] = False
            # FEC reclassification of the shortened last row (d8psk.c:153-162)
            fec_rows = nbrow - 1 if nlbyte <= 2 else nbrow
            fec_nl = (0 if nlbyte <= 2 else 2 if nlbyte <= 30
                      else 4 if nlbyte <= 67 else 0)
            mask_f = np.zeros((RS_ROOTS, MAX_ROWS), dtype=bool)
            if fec_rows > 0:
                mask_f[:, :fec_rows] = True
                if fec_nl:
                    mask_f[fec_nl:, fec_rows - 1] = False
            flat = np.concatenate([mask_d.ravel(), mask_f.ravel()])
            k = np.cumsum(flat) - 1
            counts[g] = flat.sum()
            kd = k[: RS_K * nbrow].reshape(RS_K, nbrow)
            inv[g, :nbrow, :RS_K] = np.where(mask_d, kd, -1).T
            kf = k[RS_K * nbrow:].reshape(RS_ROOTS, MAX_ROWS)
            inv[g, :, RS_K:] = np.where(mask_f, kf, -1).T
    return inv, counts


# ---------------------------------------------------------------- RS(255,249)

EXPN = GF_EXP.astype(np.int32)     # exp table, [255] = 0
LOGN = GF_LOG.astype(np.int32)     # log table, log(0) = 255 (A0)


def gf_mul_table() -> np.ndarray:
    """(256*256,) GF(2^8) product table, index a*256 + b."""
    a = np.arange(256)
    t = EXPN[(LOGN[a][:, None] + LOGN[a][None, :]) % 255]
    t[0, :] = 0
    t[:, 0] = 0
    return t.reshape(-1).astype(np.int32)


def _gf_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return gf_mul_table()[np.asarray(a) * 256 + np.asarray(b)]


def erasure_init() -> tuple[np.ndarray, np.ndarray]:
    """(3, 7) erasure-locator polynomials and (3,) erasure counts per
    class: 0 none, 1 = {253, 254}, 2 = {251..254} (vdlm2.c:64-82)."""
    lam_init = np.zeros((3, RS_ROOTS + 1), dtype=np.int32)
    for cls, eras in enumerate([[], [253, 254], [251, 252, 253, 254]]):
        lam = np.zeros(RS_ROOTS + 1, dtype=np.int64)
        lam[0] = 1
        if eras:
            lam[1] = EXPN[(RS_N - 1 - eras[0]) % 255]
            for i in range(1, len(eras)):
                u = (RS_N - 1 - eras[i]) % 255
                for jj in range(i + 1, 0, -1):
                    t = LOGN[lam[jj - 1]]
                    if t != GF_A0:
                        lam[jj] ^= EXPN[(u + t) % 255]
        lam_init[cls] = lam
    return lam_init, np.array([0, 2, 4], dtype=np.int32)


def rs_position_tables() -> dict[str, np.ndarray]:
    """Per-position GF constants of the syndrome, Chien and Forney sums
    (rs.c:81-291), for a decoder that multiplies through gf_mul_table:

      syn   (6, 255)  alpha^{(FCR+i)(254-j)}: s_i = XOR_j d_j * syn[i, j]
      chien (6, 255)  alpha^{d q1}, d = 1..6, q1 = q+1
      omega (6, 255)  alpha^{d q1} * alpha^{q1 (FCR-1) + N}, d = 0..5
      den   (3, 255)  alpha^{d q1}, d = 0, 2, 4
      inv   (256,)    GF inverse with inv[0] = 0
    """
    q1 = np.arange(1, RS_N + 1)
    j = np.arange(RS_N)
    syn = EXPN[((RS_FCR + np.arange(RS_ROOTS))[:, None]
                * (RS_N - 1 - j)[None, :]) % 255]
    num2 = EXPN[(q1 * (RS_FCR - 1) + RS_N) % 255]

    def powers(degrees):
        return np.stack([EXPN[(d * q1) % 255] for d in degrees])

    inv = np.zeros(256, dtype=np.int32)
    inv[1:] = EXPN[(255 - LOGN[np.arange(1, 256)]) % 255]
    return {
        "syn": syn.astype(np.int32),
        "chien": powers(range(1, RS_ROOTS + 1)).astype(np.int32),
        "omega": _gf_mul_np(powers(range(RS_ROOTS)), num2[None, :]
                            ).astype(np.int32),
        "den": powers([0, 2, 4]).astype(np.int32),
        "inv": inv,
    }


# ---------------------------------------------------------------- pipeline

# raw array items per sample, and the neutral pad value beyond the capture
RAW_FMT = {
    "cu8": (2, 127),
    "cs16": (2, 0),
    "cf32": (2, 0.0),
    "f32real": (1, 0.0),
}

# Packed-result layout (one uint8 row per decode slot):
#   [0:2040)    burst block (8 rows x 255 bytes)
#   [2040:2048) rs counts per row, int8 (count+1 so -1 fits unsigned)
#   [2048:2096) 12 int32 little-endian meta words:
#               chan, t0, length, nbrow, nlbyte, consumed, live,
#               of_bits, df_bits, then block-wide stats carried in row 0
#               only: n_sync_valid, n_header_reject, n_overflow
PACKED_ROW_BYTES = 2040 + 8 + 48


@dataclass
class DecodedBurst:
    """A CRC-pending decoded burst (post-FEC), plus its valid frames."""
    channel: int
    t0: int                      # decimated-sample index of sync trigger
    time_s: float                # t0 / 84 kHz relative to stream start
    freq_hz: float               # RF channel frequency
    ppm: float                   # per-burst frequency-offset estimate
    length_bits: int
    nbrow: int
    nlbyte: int
    block: np.ndarray            # (nbrow, 255) RS-corrected
    rs_counts: list[int]
    frames: list[np.ndarray] = field(default_factory=list)  # incl. flags


@dataclass
class PipelineConfig:
    """The JAX package's PipelineConfig, field for field, so one config
    drives both packages.  mesh is a parallel.sharding.Mesh: it shards
    decode_channels and decode_wideband over its devices."""
    freqs_hz: list[float]                  # RF channel frequencies
    fs: int = 2_000_000                    # wideband input rate
    fc_hz: float | None = None             # center frequency (None: auto)
    real_input: bool = False               # airspy-style real capture
    lo_wrap: bool = True                   # reference's wrapped LO table
    max_candidates: int = 32               # sync candidates per channel/block
    max_symbols: int = MAX_BURST_SYMBOLS   # burst demod window
    sdrclk: int | None = None
    mesh: object | None = None             # parallel.sharding.Mesh
    use_pallas: bool = False               # dense-channelizer ingest kernel
    max_out: int | None = None             # decode slots per block (None: auto)
    filter_mode: str = "boxcar"            # "boxcar" | "fir"
    chan_impl: str = "auto"                # "auto" | "matmul" | "dft" | "pfb"
    compute: str = "f32"                   # "f32" | "bf16"
    sync_impl: str = "stream"              # "stream" | "fused" | "xla"

    def resolved_sdrclk(self) -> int:
        return self.sdrclk if self.sdrclk is not None else self.fs // 4000


def right_margin(max_symbols: int) -> int:
    """Decimated samples after a streaming block's core: one max burst
    window, so that a burst triggered at the core's end decodes whole."""
    return 24 + 8 * max_symbols


def stream_geometry(p_in: int, p_out: int, fs: int, max_symbols: int,
                    block_seconds: float, align: int = 1
                    ) -> tuple[int, int, int, int]:
    """(lmarg_p, rmarg_p, core_p, total_p): streaming block geometry in
    channelizer periods.  The left margin covers HALO_LEFT decimated
    samples, the right one a max burst window; total_p is rounded up to
    align, absorbed into the right margin."""
    lmarg_p = -(-HALO_LEFT // p_out)
    rmarg_p = -(-right_margin(max_symbols) // p_out)
    core_p = max(1, int(block_seconds * fs) // p_in)
    total_p = lmarg_p + core_p + rmarg_p
    total_p += (-total_p) % align
    rmarg_p = total_p - lmarg_p - core_p
    return lmarg_p, rmarg_p, core_p, total_p


def burst_span_samples(consumed_bits: int, of: float) -> int:
    """Decimated samples from trigger to last consumed symbol."""
    clk0 = int(np.clip(np.floor(of + 0.5), 0, 12))
    s1 = (32 - clk0 + 3) // 4
    nsym = -(-(25 + consumed_bits) // 3)
    return s1 + 8 * (nsym - 1)


def packed_stats(buf: np.ndarray) -> dict:
    """Block-wide stage counters from a packed buffer."""
    meta = np.ascontiguousarray(np.asarray(buf)[:, 2048:]).view(np.int32)
    return {
        "sync_candidates": int(meta[:, 9].sum()),
        "bursts_rejected_header": int(meta[:, 10].sum()),
        "candidates_overflow": int(meta[:, 11].sum()),
    }


def unpack_results(buf: np.ndarray) -> list[dict]:
    """Packed rows -> candidate dicts of the live rows."""
    out = []
    for row in np.ascontiguousarray(np.asarray(buf)):
        meta = row[2048:2096].copy().view(np.int32)
        if not int(meta[6]):
            continue
        out.append(dict(
            chan=int(meta[0]),
            t0=int(meta[1]),
            length=int(meta[2]),
            nbrow=int(meta[3]),
            nlbyte=int(meta[4]),
            consumed=int(meta[5]),
            of=float(meta[7:8].view(np.float32)[0]),
            df=float(meta[8:9].view(np.float32)[0]),
            block=row[:2040].reshape(8, 255),
            rs_counts=row[2040:2048].copy().view(np.int8).astype(np.int32) - 1,
        ))
    return out
