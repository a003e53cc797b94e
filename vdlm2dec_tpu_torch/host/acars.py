"""ACARS decoder: inner CRC, field parse, registration fix-up, OOOI labels.

Semantics: outacars.c (CRC+parity strip 222-231, field layout 233-289,
fixreg 44-121) and label.c (label filter 10-39, OOOI parsers 41-266,
DecodeLabel 269-324 — including the reference's unreachable label "17"
branch, replicated for output parity and documented in tests).
"""
from __future__ import annotations

import binascii
from dataclasses import dataclass

import numpy as np

from ..constants import reversebits

# ITU aircraft-registration prefixes (interoperability data, outacars.c:44-75)
REG_PREFIX_1 = ["C", "B", "F", "D", "2", "I", "P", "M", "G", "Z"]
REG_PREFIX_2 = [
    "YA", "ZA", "7T", "C3", "D2", "VP", "V2", "LV", "LQ", "EK", "P4", "VH",
    "OE", "4K", "C6", "S2", "8P", "EW", "OO", "V3", "TY", "VQ", "A5", "CP",
    "T9", "E7", "A2", "PP", "PR", "PT", "PU", "V8", "LZ", "XT", "9U", "XU",
    "TJ", "D4", "TL", "TT", "CC", "HJ", "HK", "D6", "TN", "E5", "9Q", "TI",
    "TU", "9A", "CU", "5B", "OK", "OY", "J2", "J7", "HI", "4W", "HC", "SU",
    "YS", "3C", "E3", "ES", "ET", "DQ", "OH", "TR", "C5", "4L", "9G", "SX",
    "J3", "TG", "3X", "J5", "8R", "HH", "HR", "HA", "TF", "VT", "PK", "EP",
    "YI", "EI", "EJ", "4X", "6Y", "ZJ", "JY", "Z6", "UP", "5Y", "T3", "9K",
    "EX", "YL", "OD", "7P", "A8", "5A", "HB", "LY", "LX", "Z3", "5R", "7Q",
    "9M", "8Q", "TZ", "9H", "V7", "5T", "3B", "XA", "XB", "XC", "V6", "ER",
    "3A", "JU", "4O", "CN", "C9", "XY", "XZ", "V5", "C2", "9N", "PH", "PJ",
    "ZK", "ZL", "ZM", "YN", "5U", "LN", "AP", "SU", "E4", "HP", "P2", "ZP",
    "OB", "RP", "SP", "SN", "CR", "CS", "A7", "YR", "RA", "RF", "V4", "J6",
    "J8", "5W", "T7", "S9", "HZ", "6V", "6W", "YU", "S7", "9L", "9V", "OM",
    "S5", "H4", "6O", "ZS", "ZT", "ZU", "Z8", "EC", "4R", "ST", "PZ", "SE",
    "HB", "YK", "EY", "5H", "HS", "5V", "A3", "9Y", "TS", "TC", "EZ", "T2",
    "5X", "UR", "A6", "4U", "CX", "YJ", "VN", "7O", "9J",
]
REG_PREFIX_3 = ["A9C", "A4O", "9XR", "3DC"]


_PREFIX_SETS = (frozenset(REG_PREFIX_3), frozenset(REG_PREFIX_2),
                frozenset(REG_PREFIX_1))


def fixreg(raw7: bytes | str) -> str:
    """Dot-strip + hyphenate a 7-char registration (outacars.c:77-121)."""
    if isinstance(raw7, (bytes, bytearray, np.ndarray)):
        s = "".join(map(chr, raw7[:7]))
    else:
        s = str(raw7)[:7]
    p = s.lstrip(".")
    if len(p) >= 4:
        # every prefix of REG_PREFIX_<t> is t characters long: the first
        # list (3, then 2, then 1) that holds p's head decides, as the
        # reference's startswith scan over the lists in that order does
        for t, prefixes in zip((3, 2, 1), _PREFIX_SETS):
            if p[:t] in prefixes:
                if len(p) > t and p[t] != "-":
                    return (p[:t] + "-" + p[t:])[:9]
                break
    return p[:8]


@dataclass
class AcarsMessage:
    mode: int = 0
    reg: str = ""
    ack: str = ""
    label: str = ""
    bid: str = ""
    no: str = ""
    fid: str = ""
    bs: int = 0
    be: int = 0
    text: str = ""


@dataclass
class Oooi:
    """OOOI + position record (acars.h:33-45)."""
    da: str = ""
    sa: str = ""
    eta: str = ""
    gout: str = ""
    gin: str = ""
    woff: str = ""
    won: str = ""
    lat: float = 0.0
    lon: float = 0.0
    epu: int = 0
    alt: int = 0


# The ACARS CRC (update_crc, crc.h:3) is CRC-16 with the reflected
# polynomial 0x8408 and init 0.  Over the bit-reversed bytes, CRC-CCITT
# (0x1021, init 0: binascii.crc_hqx) holds the same register bit-reversed,
# so the one is 0 exactly when the other is.
BITREV8 = bytes(reversebits(b, 8) for b in range(256))
PARITY_STRIP = bytes(b & 0x7F for b in range(256))


def _payload_bytes(payload) -> tuple[bytes, int]:
    """The payload as bytes (each value's low 8 bits, which is all the CRC
    reads) and its last value as given (the parse leaves it unmasked)."""
    if isinstance(payload, (bytes, bytearray)):
        data = bytes(payload)
        return data, data[-1] if data else 0
    a = np.asarray(payload)
    if a.dtype != np.uint8:
        a = np.asarray(a, dtype=np.int64)
        return (a & 0xFF).astype(np.uint8).tobytes(), int(a[-1]) if len(a) else 0
    data = a.tobytes()
    return data, data[-1] if data else 0


def _crc_ok(data: bytes) -> bool:
    return binascii.crc_hqx(data[:-1].translate(BITREV8), 0) == 0


def acars_crc_ok(payload: np.ndarray) -> bool:
    """Inner ACARS CRC over payload[:-1] must be zero (outacars.c:222-228)."""
    return _crc_ok(_payload_bytes(payload)[0])


def parse_acars(payload: np.ndarray) -> AcarsMessage | None:
    """Field parse per outacars.c:233-289.  payload = hdata[13 .. l-3]
    (after the ff ff 01 ACARS prefix).  Returns None on CRC failure.
    """
    data, last = _payload_bytes(payload)
    n = len(data)
    if n < 13:
        return None
    if not _crc_ok(data):
        return None
    # parity stripped from all but the last byte (outacars.c:229-231); the
    # last is read only as bs (n == 13) or be, as an integer
    txt = data[: n - 1].translate(PARITY_STRIP).decode("latin-1")

    msg = AcarsMessage()
    msg.mode = ord(txt[0])
    msg.reg = fixreg(txt[1:8])
    msg.ack = "!" if txt[8] == "\x15" else txt[8]
    msg.label = txt[9] + ("d" if txt[10] == "\x7f" else txt[10])
    msg.bid = " " if txt[11] == "\x00" else txt[11]
    msg.bs = ord(txt[12]) if n > 13 else last
    k = 13

    msg.no = ""
    msg.fid = ""
    msg.text = ""
    if msg.bs != 0x03:
        # the fields end where the text does, 4 bytes before the payload's
        # end (CRC, suffix): no, then fid, then the text, each cut there
        end = max(k, n - 4)
        if msg.mode <= ord("Z") and ord(msg.bid) <= ord("9"):
            msg.no = txt[k: min(k + 4, end)]
            k += len(msg.no)
            msg.fid = txt[k: min(k + 6, end)]
            k += len(msg.fid)
        msg.text = txt[k:end]
        k = end
    msg.be = ord(txt[k]) if k < n - 1 else last if k < n else 0
    return msg


# ---------------------------------------------------------------------------
# label filter (-b) and OOOI label parsers
# ---------------------------------------------------------------------------


class LabelFilter:
    """Colon-separated whitelist (label.c:10-39); empty = pass-all."""

    def __init__(self, arg: str | None = None):
        self.labels = [s for s in (arg or "").split(":") if s]

    def __call__(self, label: str) -> bool:
        return not self.labels or label in self.labels


def _convpos(t: str, o: Oooi) -> int:
    """N/S ddddd W/E dddddd position (label.c:41-57)."""
    if len(t) < 13 or t[0] not in "NS" or t[6] not in "WE":
        return 0
    try:
        lat = float(t[1:6]) / 1000.0
        lon = float(t[7:13]) / 1000.0
    except ValueError:
        return 0
    o.lat = -lat if t[0] == "S" else lat
    o.lon = -lon if t[6] == "W" else lon
    o.epu = 1
    return 1


def _q(fields):
    """Build a label-Qx parser from (offset, attr, minlen) field specs."""
    def parse(t: str, o: Oooi) -> int:
        minlen = max(off + 4 for off, _ in fields)
        if len(t) < minlen:
            return 0
        for off, attr in fields:
            setattr(o, attr, t[off : off + 4])
        return 1
    return parse


_Q_PARSERS = {
    # label.c:59-206 — OOOI field layouts per Q-label
    "Q1": _q([(0, "sa"), (4, "gout"), (8, "woff"), (12, "won"), (16, "gin"), (24, "da")]),
    "Q2": _q([(0, "sa"), (4, "eta")]),
    "QA": _q([(0, "sa"), (4, "gout")]),
    "QB": _q([(0, "sa"), (4, "woff")]),
    "QC": _q([(0, "sa"), (4, "won")]),
    "QD": _q([(0, "sa"), (4, "gin")]),
    "QE": _q([(0, "sa"), (4, "gout"), (8, "da")]),
    "QF": _q([(0, "sa"), (4, "woff"), (8, "da")]),
    "QG": _q([(0, "sa"), (4, "gout"), (8, "gin")]),
    "QH": _q([(0, "sa"), (4, "gout")]),
    "QK": _q([(0, "sa"), (4, "won"), (8, "da")]),
    "QL": _q([(0, "da"), (8, "gin"), (13, "sa")]),
    "QM": _q([(0, "da"), (8, "sa")]),
    "QN": _q([(4, "da"), (8, "eta")]),
    "QP": _q([(0, "sa"), (4, "da"), (8, "gout")]),
    "QQ": _q([(0, "sa"), (4, "da"), (8, "woff")]),
    "QR": _q([(0, "sa"), (4, "da"), (8, "won")]),
    "QS": _q([(0, "sa"), (4, "da"), (8, "gin")]),
    "QT": _q([(0, "sa"), (4, "da"), (8, "gout"), (12, "gin")]),
}


def _label_15(t: str, o: Oooi) -> int:
    if len(t) < 26 or not t.startswith("FST01"):
        return 0
    o.sa = t[5:9]
    o.da = t[9:13]
    return _convpos(t[13:], o)


def _label_16(t: str, o: Oooi) -> int:
    if len(t) < 19 or not t.startswith("POSA1"):
        return 0
    return _convpos(t[6:], o)


def _label_17(t: str, o: Oooi) -> int:
    if len(t) < 18 or not t.startswith("ETA "):
        return 0
    o.eta = t[4:8]
    if t[8] != ",":
        return 0
    o.sa = t[9:13]
    if t[13] != ",":
        return 0
    o.da = t[14:18]
    return 1


def _label_20(t: str, o: Oooi) -> int:
    if len(t) < 30 or not t.startswith("RST"):
        return 0
    o.sa = t[22:26]
    o.da = t[26:30]
    return 1


def _label_2z(t: str, o: Oooi) -> int:
    if len(t) < 4:
        return 0
    o.da = t[0:4]
    return 1


def _label_44(t: str, o: Oooi) -> int:
    if len(t) < 48 or not t.startswith("POS0") or t[5] != ",":
        return 0
    if _convpos(t[6:], o) == 0:
        return 0
    if t[23] != ",":
        return 0
    o.da = t[24:28]
    if t[28] != ",":
        return 0
    o.sa = t[29:33]
    if t[43] != ",":
        return 0
    o.eta = t[44:48]
    return 1


def _label_h1(t: str, o: Oooi) -> int:
    if len(t) < 20:
        return 0
    if t[:7] not in ("#M1BPOS", "#M2BPOS", "#M3BPOS"):
        return 0
    return _convpos(t[7:], o)


def decode_label(msg: AcarsMessage) -> tuple[Oooi, int]:
    """DecodeLabel (label.c:269-324).

    Faithfulness note: the reference tests label[1]=='6' twice, so its "17"
    parser runs for label "16" (after the "16" parser) and never for "17";
    replicated on purpose.
    """
    o = Oooi()
    lbl = msg.label
    ov = 0
    if lbl and lbl[0] == "1" and len(lbl) > 1:
        if lbl[1] == "5":
            ov = _label_15(msg.text, o)
        if lbl[1] == "6":
            ov = _label_16(msg.text, o)
        if lbl[1] == "6":                      # reference bug, kept (label.c:281)
            ov = _label_17(msg.text, o)
    elif lbl and lbl[0] == "2" and len(lbl) > 1:
        if lbl[1] == "0":
            ov = _label_20(msg.text, o)
        if lbl[1] == "Z":
            ov = _label_2z(msg.text, o)
    elif lbl == "44":
        ov = _label_44(msg.text, o)
    elif lbl == "H1":
        ov = _label_h1(msg.text, o)
    elif lbl and lbl[0] == "Q" and lbl in _Q_PARSERS:
        ov = _Q_PARSERS[lbl](msg.text, o)
    return o, ov
