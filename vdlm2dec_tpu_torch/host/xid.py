"""XID parameter-group decoder (outxid.c semantics).

Walks XID groups: public group 0x80 skipped, private 0xf0 parsed into the 18
private parameter types (outxid.c:47-224), mirroring position/destination
into the flight record (addfl, outxid.c:243-262).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .avlc import icaoaddr


def getlatlon(p: np.ndarray, off: int) -> tuple[float, float]:
    """Packed 12-bit lat/lon (outxid.c:36-45): int16 arithmetic included."""
    slat = ((int(p[off]) << 8) | (int(p[off + 1]) & 0xF0))
    if slat >= 0x8000:
        slat -= 0x10000
    slon = (((int(p[off + 1]) & 0x0F) << 12) | (int(p[off + 2]) << 4))
    if slon >= 0x8000:
        slon -= 0x10000
    return slat / 160.0, slon / 160.0


@dataclass
class XidInfo:
    """Decoded private parameters relevant to tracking + text lines."""
    lines: list[str] = field(default_factory=list)
    dst_airport: str | None = None
    lat: float | None = None
    lon: float | None = None
    alt: int | None = None


def decode_private_group(p: np.ndarray, glen: int, verbose: int = 1) -> XidInfo:
    """outprivategr (outxid.c:47-224): text lines per parameter."""
    info = XidInfo()
    v = info.lines.append
    i = 0
    while i < glen:
        plen = int(p[i + 1]) if i + 1 < len(p) else 0
        pid = int(p[i])
        try:
            if pid == 0:
                pass
            elif pid == 0x01:
                b = int(p[i + 2])
                s = "Connection management: "
                if b & 1:
                    s += "HO|"
                elif b & 2:
                    s += "LCR|"
                else:
                    s += "LE|"
                s += "GDA|" if b & 4 else "VDA|"
                s += "ESS" if b & 8 else "ESN"
                v(s)
            elif pid == 0x02:
                v(f"Signal quality {int(p[i + 2]):01d}")
            elif pid == 0x03:
                v(f"XID sequencing {int(p[i + 2]) >> 4:1d}:{int(p[i + 2]) & 0x7:1d}")
            elif pid == 0x04:
                b = int(p[i + 2])
                s = "Specific options: "
                s += "GDA:" if b & 1 else "VDA:"
                s += "ESS:" if b & 2 else "ESN:"
                s += "IHS:" if b & 4 else "IHN:"
                s += "BHS:" if b & 8 else "BHN:"
                s += "BCS" if b & 0x10 else "BCN"
                v(s)
            elif pid == 0x05:
                v(f"Expedited subnetwork connection {int(p[i + 2]):02x}")
            elif pid == 0x06:
                v(f"LCR cause {int(p[i + 2]):02x}")
            elif pid == 0x81:
                v(f"Modulation support {int(p[i + 2]):02x}")
            elif pid == 0x82:
                alts = []
                n = 0
                while n < plen:
                    alts.append(f"{icaoaddr(p, i + 2 + n) & 0xFFFFFF:06X}")
                    n += 4
                v("Acceptable alternative ground stations : " + " ".join(alts) + " ")
            elif pid == 0x83:
                da = "".join(chr(int(c)) for c in p[i + 2 : i + 6])
                info.dst_airport = da
                v(f"Destination airport {da}")
            elif pid == 0x84:
                lat, lon = getlatlon(p, i + 2)
                alt = int(p[i + 5]) * 1000
                info.lat, info.lon, info.alt = lat, lon, alt
                s = f"Aircraft Position {lat:5.1f} {lon:6.1f} "
                if alt == 0:
                    s += "alt: <=999"
                elif alt == 255000:
                    s += "alt: >=255000"
                else:
                    s += f"alt: {alt}"
                v(s)
            elif pid == 0xC0:
                outs = []
                n = 0
                while n < plen:
                    mod_ = (int(p[i + 2 + n]) & 0xF0) >> 4
                    freq = ((int(p[i + 2 + n]) & 0x0F) << 8) | int(p[i + 3])
                    addr = icaoaddr(p, i + 4 + n)
                    outs.append(
                        f"{(freq + 10000) / 100.0:03.2f} ({mod_ & 0x0F:01X}) "
                        f"{addr & 0xFFFFFF:06X}"
                    )
                    n += 6
                v("Frequency support : " + " ".join(outs) + " ")
            elif pid == 0xC1:
                ids = []
                n = 0
                while n < plen:
                    ids.append("".join(chr(int(c)) for c in p[i + 2 + n : i + 6 + n]))
                    n += 4
                v("Airport coverage : " + " ".join(ids) + " ")
            elif pid == 0xC3:
                v("Nearest Airport : " + "".join(chr(int(c)) for c in p[i + 2 : i + 6]))
            elif pid == 0xC4:
                adm = (int(p[i + 2]) << 16) | (int(p[i + 3]) << 8) | int(p[i + 4])
                ars = (int(p[i + 5]) << 16) | (int(p[i + 6]) << 8) | int(p[i + 7])
                v(f"ATN router nets : ADM: {adm:06X} ARS : {ars:06X}")
            elif pid == 0xC5:
                mask = icaoaddr(p, i + 2)
                v(f"Station system mask : {mask & 0xFFFFFF:06X}")
            elif pid == 0xC8:
                lat, lon = getlatlon(p, i + 2)
                v(f"Station Position {lat:4.1f} {lon:5.1f}")
            else:
                v(f"unknown private id {pid:02x}")
        except IndexError:
            break
        i += 2 + plen
    return info


@dataclass
class XidResult:
    decoded: bool = False
    info: XidInfo | None = None


def decode_xid(payload: np.ndarray) -> XidResult:
    """outxid group walk (outxid.c:264-302).  payload = hdata[11 .. l-3]."""
    p = np.asarray(payload, dtype=np.int64)
    res = XidResult()
    i = 0
    n = len(p)
    while i < n:
        if i + 2 >= n:
            break
        glen = int(p[i + 1]) * 256 + int(p[i + 2])
        gid = int(p[i])
        if gid == 0x80:
            i += 3 + glen
            continue
        if gid == 0xF0:
            res.decoded = True
            res.info = decode_private_group(p[i + 3 :], glen)
            break
        i += 3 + glen
    return res
