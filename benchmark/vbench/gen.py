"""The benchmark's traffic generator: a seeded wideband capture of VDL2
bursts on a channel plan, in the configuration's capture format, and the
truth of every burst in it.

One general generator reads every traffic mix (a file of parameters under
benchmark/traffic/).  Its arithmetic is that of the port's stimulus,
modulator and framegen modules, rewritten so that a capture costs seconds:
burst symbols are made on the host, in a few vectorized steps per burst;
pulse shaping, the per-burst impairments, upsampling, mixing, noise and
the format's quantisation run in torch on the given device, in fixed-order
arithmetic (gathers, no atomics), so one seed gives the same bytes.

Work does not depend on the seed: a fixed shape seed in the mix draws each
channel's list of bursts (kind, text length, gap after it) and the run's
seed only permutes that list and draws contents, addresses and
impairments.  Every seed thus carries the same number of bursts of the
same sizes, in another order.

Formats (protocol.RAW_FMT; the configuration's "format" key):
  cu8      each channel mixed to f - fc; complex noise; rounded to bytes
           around rtl_sdr's zero, 127.37, as interleaved uint8
  f32real  each channel mixed to f - F0, F0 = fc + fs/4 (air.c:182-185);
           the real part doubled, so that after the receiver's mixer and
           dump a channel carries the level its cu8 capture would (the
           other half is the mirror image at the negated offset); real
           noise; rounded to the Airspy's 12-bit grid, clipped to
           [-2048, 2047] and scaled by 1/2048, as float32
Levels and noise are in LSBs of the format's own quantiser, so one mix
means the same signal-to-quantisation ratio on either format.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .protocol import (
    D8PSK_BITS,
    D8PSK_CENTERS_EIGHTHS,
    DEMOD_RATE,
    GF_EXP,
    GF_LOG,
    KEYSTREAM,
    RAW_FMT,
    RS_GEN_POLY,
    RS_K,
    RS_ROOTS,
    SPS,
    SYNC_PHASES,
    burst_geometry,
    capture_format,
    crc_update,
    frame_fcs,
    header_encode,
    mix_center_hz,
    reversebits,
)

TWO_PI = 2.0 * math.pi
RTL_DC_OFFSET = 127.37           # rtl_sdr's cu8 zero (the port's io.sdr)
AIRSPY_FULL_SCALE = 2048         # the Airspy's 12-bit samples as float32 (air.c)
AIRCRAFT = 1 << 24               # AVLC address types (out.c:437-469)
GROUND_D = 5 << 24
ALL_STATIONS = 7 << 24
SEED_MOD = 1 << 62               # seeds of any size map into both RNGs

# ACARS text: upper-case letters, digits, space and punctuation.  No
# character of it holds five consecutive one bits, so text never stuffs,
# and no text starts with "/", so no ARINC 622 application applies.
TEXT_CHARS = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,-:+", np.uint8)
# downlink labels that carry free text: none of them has an OOOI or
# position parser in vdlm2dec (label.c), so a line depends on its frame only
LABELS = ["5Z", "SA", "_d", "80", "B6", "RA", "4T", "Q0", "12", "83"]
AIRLINES = ["AF", "BA", "LH", "KL", "IB", "AZ", "UA", "DL", "EK", "QR"]
AIRPORTS = ["LFPG", "EGLL", "EDDF", "EHAM", "LEMD", "LIRF", "KJFK", "KATL",
            "OMDB", "OTHH", "LFPO", "EDDM"]
LETTERS = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)

# 3 Gray bits (b0, b1, b2) -> differential phase, as an index b0*4+b1*2+b2
_PHASE_LUT = np.zeros(8)
for _k in range(8):
    _b = [int(v) for v in D8PSK_BITS[_k]]
    _PHASE_LUT[_b[0] * 4 + _b[1] * 2 + _b[2]] = (
        float(D8PSK_CENTERS_EIGHTHS[_k]) * math.pi / 8.0)

# bytes of an ACARS downlink frame besides its text: AVLC header 9, marker
# 3, mode 1, reg 7, ack 1, label 2, bid 1, STX 1, msgno 4, fid 6, ETX 1,
# CRC 2, DEL 1
ACARS_FIXED_BYTES = 39
# an XID frame: AVLC header 9, format 4, destination 6, position 6
XID_BYTES = 25
TAPS = 13                        # symbols that reach one sample (97-tap pulse)
# samples a burst may run over its unstuffed length: its header, marker,
# CRC and addresses stuff up to a few bytes, at 8 / 3 symbols a byte
STUFF_MARGIN = 192


@dataclass
class Burst:
    chan: int                    # channel index in the plan
    start: int                   # first sample at 84 kHz (capture-relative)
    length: int                  # samples at 84 kHz
    kind: str                    # "acars" | "xid"
    fields: dict = field(default_factory=dict)   # what the frame carries
    imp: tuple = ()              # (cfo Hz, phase, timing fraction, amplitude)

    @property
    def end(self) -> int:
        return self.start + self.length


@dataclass
class Capture:
    raw: np.ndarray              # the format's native array (protocol.RAW_DTYPE)
    fs: int
    fc_hz: float
    freqs_hz: list
    seconds: float
    bursts: list                 # Burst, in (chan, start) order
    fmt: str                     # protocol.RAW_FMT's key

    @property
    def samples(self) -> int:
        return len(self.raw) // RAW_FMT[self.fmt][0]


def channel_plan(cfg: dict) -> list[int]:
    """RF frequencies (Hz) of a configuration's channels."""
    return [int(cfg["base_hz"]) + int(cfg["spacing_hz"]) * i
            for i in range(int(cfg["channels"]))]


def active_channels(cfg: dict, traffic: dict) -> list[int]:
    every = int(traffic.get("active_every", 1))
    return [ci for ci in range(int(cfg["channels"])) if ci % every == 0]


# ------------------------------------------------------------- frame content

def encode_icaoaddr(addr: int) -> bytes:
    """AVLC address octets of a 27-bit (type + ICAO) address."""
    b0 = reversebits((addr >> 21) & 0x3F, 6) << 2
    b1 = reversebits((addr >> 14) & 0x7F, 7) << 1
    b2 = reversebits((addr >> 7) & 0x7F, 7) << 1
    b3 = (reversebits(addr & 0x7F, 7) << 1) | 1
    return bytes([b0, b1, b2, b3])


def avlc_header(from_addr: int, to_addr: int, link_ctrl: int) -> bytes:
    return encode_icaoaddr(to_addr) + encode_icaoaddr(from_addr) + bytes([link_ctrl])


def acars_frame(f: dict) -> bytes:
    body = ("2" + f["reg_field"] + "\x15" + f["label"] + f["bid"] + "\x02"
            + f["msgno"] + f["flight"] + f["text"] + "\x03").encode("latin-1")
    crc = 0
    for b in body:
        crc = crc_update(crc, b)
    payload = body + bytes([crc & 0xFF, crc >> 8, 0x7F])
    return (avlc_header(AIRCRAFT | f["icao"], GROUND_D | f["ground"], 0x03)
            + b"\xff\xff\x01" + payload)


def xid_frame(f: dict) -> bytes:
    lat_raw = int(round(f["lat"] * 160)) & 0xFFFF
    lon_raw = int(round(f["lon"] * 160)) & 0xFFFF
    pos = bytes([(lat_raw >> 8) & 0xFF,
                 (lat_raw & 0xF0) | ((lon_raw >> 12) & 0x0F),
                 (lon_raw >> 4) & 0xFF, f["alt_kft"]])
    grp = bytes([0x83, 4]) + f["dsta"].encode() + bytes([0x84, 4]) + pos
    body = bytes([0x82, 0xF0, len(grp) >> 8, len(grp) & 0xFF]) + grp
    return avlc_header(AIRCRAFT | f["icao"], ALL_STATIONS | 0xFFFFFF, 0xBF) + body


# ------------------------------------------------------------ burst symbols

def _stuffed_bits(content: bytes) -> np.ndarray:
    """flag + bit-stuffed (content + FCS) + flag, LSB first."""
    fcs = frame_fcs(np.frombuffer(content, np.uint8))
    payload = np.frombuffer(content + bytes([fcs & 0xFF, fcs >> 8]), np.uint8)
    bits = np.unpackbits(payload, bitorder="little")
    out = []
    ones = 0
    for b in bits.tolist():
        out.append(b)
        if b:
            ones += 1
            if ones == 5:
                out.append(0)
                ones = 0
        else:
            ones = 0
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    return np.array(flag + out + flag, dtype=np.uint8)


def _geometry(n_bits: int) -> tuple[int, int, int]:
    """(length_bits, nbrow, nlbyte) of a burst whose HDLC stream has n_bits
    (the modulator's rule: at least 12 bytes, and a last row of 3 bytes or
    more)."""
    nbytes = max((n_bits + 7) // 8, 12)
    r = nbytes % RS_K
    if r < 3:
        nbytes += 3 - r
    length_bits = nbytes * 8
    nbrow, nlbyte = burst_geometry(length_bits)
    return length_bits, nbrow, nlbyte


def _rs_parity(rows: np.ndarray) -> np.ndarray:
    """(R, 249) data rows -> (R, 6) RS(255,249) parity, all rows at once
    (the LFSR division of the golden rs_encode_row)."""
    g = np.asarray(RS_GEN_POLY[::-1], dtype=np.int64)[1:]      # g[1..6]
    log_g = GF_LOG[g]
    rem = np.zeros((rows.shape[0], RS_ROOTS), dtype=np.int64)
    for i in range(RS_K):
        fb = rem[:, 0] ^ rows[:, i].astype(np.int64)
        rem[:, :-1] = rem[:, 1:]
        rem[:, -1] = 0
        nz = fb != 0
        prod = GF_EXP[(GF_LOG[fb[nz]][:, None] + log_g[None, :]) % 255]
        rem[nz] ^= prod
    return rem.astype(np.uint8)


def _cell_order(nbrow: int, nlbyte: int) -> np.ndarray:
    """Flat (row * 255 + col) indices of the transmitted cells: column
    major, last row truncated, then the reclassified FEC columns."""
    cols = np.arange(RS_K)[:, None]
    rows = np.arange(nbrow)[None, :]
    keep = ~((nlbyte > 0) & (rows == nbrow - 1) & (cols >= nlbyte))
    data = (rows * 255 + cols)[keep]
    if nlbyte <= 2:
        fec_rows, fec_nl = nbrow - 1, 0
    elif nlbyte <= 30:
        fec_rows, fec_nl = nbrow, 2
    elif nlbyte <= 67:
        fec_rows, fec_nl = nbrow, 4
    else:
        fec_rows, fec_nl = nbrow, 0
    cols = np.arange(RS_ROOTS)[:, None]
    rows = np.arange(fec_rows)[None, :]
    keep = ~((fec_nl > 0) & (rows == fec_rows - 1) & (cols >= fec_nl))
    fec = (rows * 255 + cols + RS_K)[keep]
    return np.concatenate([data, fec])


def burst_phases(frames: list[bytes]) -> list[np.ndarray]:
    """Absolute symbol phases (17 sync symbols first) of one burst per
    frame, as modulator.make_burst builds them."""
    plans = []
    for content in frames:
        bits = _stuffed_bits(content)
        length_bits, nbrow, nlbyte = _geometry(len(bits))
        cap = RS_K * (nbrow - 1) + (nlbyte if nlbyte else RS_K)
        flag = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)
        reps = -(-(cap * 8 - len(bits)) // 8) if cap * 8 > len(bits) else 0
        full = np.concatenate([bits, np.tile(flag, reps)])[: cap * 8]
        data = np.zeros(nbrow * RS_K, dtype=np.uint8)
        packed = np.packbits(full, bitorder="little")
        # rows filled in order; the last row holds nlbyte bytes
        data[: len(packed)] = packed
        plans.append((length_bits, nbrow, nlbyte, data.reshape(nbrow, RS_K)))
    parity = _rs_parity(np.concatenate([p[3] for p in plans]))
    out = []
    r0 = 0
    for length_bits, nbrow, nlbyte, data in plans:
        block = np.zeros((nbrow, 255), dtype=np.uint8)
        block[:, :RS_K] = data
        block[:, RS_K:] = parity[r0: r0 + nbrow]
        r0 += nbrow
        tx = block.reshape(-1)[_cell_order(nbrow, nlbyte)]
        hdr = header_encode(length_bits)
        chan = np.concatenate([hdr, np.unpackbits(tx, bitorder="little")])
        chan = chan ^ KEYSTREAM[: len(chan)]
        pad = (-len(chan)) % 3
        trip = np.concatenate([chan, np.zeros(pad, np.uint8)]).reshape(-1, 3)
        d = _PHASE_LUT[trip[:, 0] * 4 + trip[:, 1] * 2 + trip[:, 2]]
        ph = np.concatenate([SYNC_PHASES, SYNC_PHASES[-1] + np.cumsum(d)])
        out.append(np.mod(ph, TWO_PI))
    return out


def raised_cosine_pulse(sps: int = SPS, alpha: float = 0.6, span: int = 6) -> np.ndarray:
    t = np.arange(-span * sps, span * sps + 1) / sps
    denom = 1.0 - (2.0 * alpha * t) ** 2
    return np.sinc(t) * np.where(
        np.abs(denom) < 1e-9, math.pi / 4.0,
        np.cos(math.pi * alpha * t) / np.where(np.abs(denom) < 1e-9, 1.0, denom))


# ---------------------------------------------------------------- the plan

def _burst_list(traffic: dict, n_samples: int, shape_rng, n_active: int):
    """Per active channel: (first start, [(kind, text_len, gap), ...]) drawn
    from the shape seed, filled up to the capture's end by each burst's
    nominal length (its exact length without stuffing, plus a margin).
    The run's seed permutes the list, so the gap that the last burst no
    longer needs may be any of them: one longest gap is kept in reserve,
    and no order runs past the end."""
    plans = []
    for _ in range(n_active):
        pos = int(shape_rng.integers(500, 500 + int(traffic["gap_max"])))
        start = pos
        items = []
        while True:
            kind = "xid" if shape_rng.random() < float(traffic["xid_share"]) else "acars"
            tl = int(shape_rng.integers(int(traffic["text_min"]),
                                        int(traffic["text_max"]) + 1))
            gap = int(shape_rng.integers(int(traffic["gap_min"]),
                                         int(traffic["gap_max"])))
            nominal = _nominal_len(kind, tl) + STUFF_MARGIN
            if pos + nominal + 16 + int(traffic["gap_max"]) > n_samples:
                break
            items.append((kind, tl, gap))
            pos += nominal + gap
        plans.append((start, items))
    return plans


def _nominal_len(kind: str, text_len: int) -> int:
    """84 kHz samples of a burst with no bit stuffing."""
    n_bytes = (ACARS_FIXED_BYTES + text_len) if kind == "acars" else XID_BYTES
    _length_bits, nbrow, nlbyte = _geometry(16 + 8 * (n_bytes + 2))
    nsym = 17 + -(-(25 + 8 * len(_cell_order(nbrow, nlbyte))) // 3)
    return nsym * SPS + 16 * SPS


def _fields(kind: str, text_len: int, rng, fleet: np.ndarray, ground: np.ndarray,
            regs: list, serial: int) -> dict:
    a = int(rng.integers(0, len(fleet)))
    f = {"icao": int(fleet[a])}
    if kind == "xid":
        f.update(dsta=AIRPORTS[a % len(AIRPORTS)],
                 lat=round(float(rng.uniform(-60.0, 70.0)), 1),
                 lon=round(float(rng.uniform(-120.0, 120.0)), 1),
                 alt_kft=int(rng.integers(1, 42)))
        return f
    text = TEXT_CHARS[rng.integers(0, len(TEXT_CHARS), text_len)].tobytes().decode()
    f.update(ground=int(ground[int(rng.integers(0, len(ground)))]),
             reg_field=regs[a].rjust(7, "."),
             label=LABELS[int(rng.integers(0, len(LABELS)))],
             bid=str(int(rng.integers(1, 10))),
             msgno="M%02d%s" % (serial % 100, chr(65 + (serial // 100) % 26)),
             flight=AIRLINES[a % len(AIRLINES)] + "%04d" % (a * 37 % 10000),
             text=text)
    return f


def _fleet(rng, n: int):
    """n distinct aircraft: 24-bit addresses (never 0 or all ones) and
    registrations in the N-number and F-/D- forms."""
    icao = rng.choice(np.arange(1, (1 << 24) - 1), size=n, replace=False)
    regs = []
    for i in range(n):
        if i % 3 == 0:
            regs.append("N%03d%s" % (rng.integers(100, 1000),
                                     LETTERS[rng.integers(0, 26, 2)].tobytes().decode()))
        else:
            regs.append(("F-G" if i % 3 == 1 else "D-A")
                        + LETTERS[rng.integers(0, 26, 3)].tobytes().decode())
    ground = rng.choice(np.arange(1, (1 << 24) - 1), size=16, replace=False)
    return icao, regs, ground


# ---------------------------------------------------------------- synthesis

def _shape_channel(phases: list[np.ndarray], starts: list[int], imp: list[tuple],
                   total_bb: int, device) -> torch.Tensor:
    """One channel's 84 kHz baseband (complex64, total_bb): every burst's
    symbols through the 97-tap raised-cosine pulse at its fractional
    timing, with its CFO, phase and level, as synthesize_baseband gives it
    (a gather over the 13 symbols that reach each sample)."""
    pulse = torch.tensor(raised_cosine_pulse(), dtype=torch.float64, device=device)
    span = (len(pulse) - 1) // 2
    bb = torch.zeros(total_bb, dtype=torch.complex64, device=device)
    if not phases:
        return bb
    nsym = np.array([len(p) for p in phases])
    tot = nsym * SPS + 16 * SPS
    sym_off = np.concatenate([[0], np.cumsum(nsym)[:-1]])
    ph = torch.tensor(np.concatenate(phases), dtype=torch.float64, device=device)
    n_b = len(phases)
    bid = torch.repeat_interleave(torch.arange(n_b, device=device),
                                  torch.tensor(tot, device=device))
    first = torch.tensor(np.concatenate([[0], np.cumsum(tot)[:-1]]), device=device)
    n = torch.arange(int(tot.sum()), device=device) - first[bid]    # local index
    frac = torch.tensor([i[2] for i in imp], dtype=torch.float64, device=device)[bid]
    ns = torch.tensor(nsym, device=device)[bid]
    so = torch.tensor(sym_off, device=device)[bid]
    nf = n.to(torch.float64)
    kmin = torch.ceil((nf - span - frac) / SPS).to(torch.int64)
    acc = torch.zeros(len(n), dtype=torch.complex128, device=device)
    for j in range(TAPS):
        k = kmin + j
        pos = nf - (k * SPS + frac) + span
        ok = (k >= 0) & (k < ns) & (pos >= 0) & (pos <= len(pulse) - 1)
        pi0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, len(pulse) - 2)
        fr = pos - pi0
        pv = torch.where(ok, pulse[pi0] * (1 - fr) + pulse[pi0 + 1] * fr,
                         torch.zeros_like(pos))
        phk = ph[torch.clamp(so + k, 0, len(ph) - 1)]
        acc = acc + torch.polar(pv, phk)
    cfo = torch.tensor([i[0] for i in imp], dtype=torch.float64, device=device)[bid]
    ph0 = torch.tensor([i[1] for i in imp], dtype=torch.float64, device=device)[bid]
    amp = torch.tensor([i[3] for i in imp], dtype=torch.float64, device=device)[bid]
    rot = torch.remainder(TWO_PI * cfo / DEMOD_RATE * nf + ph0, TWO_PI)
    sig = acc * torch.polar(amp, rot)
    idx = torch.tensor(starts, device=device)[bid] + n
    bb[idx] = sig.to(torch.complex64)
    return bb


def _upsample_mix(bb: torch.Tensor, fs: int, f_offset: int, wide: torch.Tensor,
                  chunk: int = 1 << 24) -> None:
    """wide += the 84 kHz baseband linearly interpolated onto the fs grid
    and mixed to f_offset (integer arithmetic for index and phase)."""
    total = len(wide)
    last = len(bb) - 2
    for lo in range(0, total, chunk):
        n = torch.arange(lo, min(lo + chunk, total), device=wide.device, dtype=torch.int64)
        num = n * DEMOD_RATE
        i0 = torch.clamp(num // fs, max=last)
        fr = ((num - i0 * fs).to(torch.float64) / fs).clamp(max=1.0).to(torch.float32)
        up = bb[i0] * (1 - fr) + bb[i0 + 1] * fr
        ph = torch.remainder(n * f_offset, fs).to(torch.float64) * (TWO_PI / fs)
        wide[lo: lo + len(n)] += up * torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def make_capture(cfg: dict, traffic: dict, seed: int, device) -> Capture:
    """The capture of a (configuration, traffic mix) pair for one seed."""
    device = torch.device(device)
    fmt = capture_format(cfg)
    fs = int(cfg["fs"])
    fc = int(cfg["fc_hz"])
    # the mixer's centre, in whole Hz for _upsample_mix's integer phase
    f0 = mix_center_hz(fmt, fs, fc)
    if f0 != int(f0):
        raise ValueError(f"the mixer's centre {f0} Hz is not a whole number of Hz")
    f0 = int(f0)
    freqs = channel_plan(cfg)
    seconds = float(traffic["seconds"])
    total_wide = int(fs * seconds)
    total_bb = int(DEMOD_RATE * seconds)
    act = active_channels(cfg, traffic)
    shape_rng = np.random.default_rng(int(traffic["shape_seed"]))
    plans = _burst_list(traffic, total_bb, shape_rng, len(act))
    rng = np.random.default_rng(seed % SEED_MOD)
    fleet, regs, ground = _fleet(rng, int(traffic["aircraft"]))
    imp_cfg = traffic["impairments"]
    bursts: list[Burst] = []
    wide = torch.zeros(total_wide, dtype=torch.complex64, device=device)
    serial = 0
    for ci, (start, items) in zip(act, plans):
        order = rng.permutation(len(items))
        items = [items[i] for i in order]
        fields = []
        for kind, tl, _gap in items:
            fields.append(_fields(kind, tl, rng, fleet, ground, regs, serial))
            serial += 1
        frames = [acars_frame(f) if k == "acars" else xid_frame(f)
                  for (k, _t, _g), f in zip(items, fields)]
        phases = burst_phases(frames)
        imp, starts = [], []
        pos = start
        for (kind, _tl, gap), f, ph in zip(items, fields, phases):
            length = len(ph) * SPS + 16 * SPS
            if pos + length > total_bb:
                raise AssertionError("a burst overran the capture")
            imp.append((float(rng.uniform(-imp_cfg["cfo_hz"], imp_cfg["cfo_hz"])),
                        float(rng.uniform(0.0, TWO_PI)),
                        float(rng.uniform(0.0, 1.0)),
                        float(imp_cfg["amplitude"]
                              * 10 ** (rng.uniform(-imp_cfg["level_spread_db"], 0.0) / 20))))
            starts.append(pos)
            bursts.append(Burst(ci, pos, length, kind, f, imp[-1]))
            pos += length + gap
        bb = _shape_channel(phases, starts, imp, total_bb, device)
        _upsample_mix(bb, fs, freqs[ci] - f0, wide)
        del bb
    g = torch.Generator(device=device)
    g.manual_seed(seed % SEED_MOD)
    noise_lsb = float(imp_cfg["noise"])
    chunk = 1 << 24
    if fmt == "cu8":
        raw = torch.empty(total_wide, 2, dtype=torch.uint8, device=device)
        for lo in range(0, total_wide, chunk):
            w = wide[lo: lo + chunk]
            noise = torch.randn(len(w), 2, generator=g, device=device) * noise_lsb
            x = torch.view_as_real(w) + noise + RTL_DC_OFFSET
            raw[lo: lo + len(w)] = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    else:
        raw = torch.empty(total_wide, dtype=torch.float32, device=device)
        for lo in range(0, total_wide, chunk):
            w = wide[lo: lo + chunk]
            noise = torch.randn(len(w), generator=g, device=device) * noise_lsb
            x = torch.round(2.0 * w.real + noise)
            raw[lo: lo + len(w)] = torch.clamp(
                x, -AIRSPY_FULL_SCALE, AIRSPY_FULL_SCALE - 1) / AIRSPY_FULL_SCALE
    del wide
    host = raw.reshape(-1).cpu().numpy()
    return Capture(host, fs, float(fc), [float(f) for f in freqs], seconds, bursts, fmt)
