"""AVLC/ACARS/XID frame construction — the inverse of the host decode layer.

Used by the tests and the stimulus to synthesize protocol-correct frames (the reference
has no transmit side).  Field layouts follow the decode semantics of
out.c/outacars.c/outxid.c.
"""
from __future__ import annotations

import numpy as np

from .constants import crc_update
from .host.avlc import encode_icaoaddr

AIRCRAFT = 1 << 24          # address type field values (out.c:437-469)
GROUND_A = 4 << 24
GROUND_D = 5 << 24
ALL_STATIONS = 7 << 24


def avlc_header(
    from_addr: int,
    to_addr: int,
    link_ctrl: int = 0x03,          # U-frame UI
    is_response: int = 0,
    on_ground: int = 0,
) -> np.ndarray:
    """9-byte AVLC header: to(4) + from(4) + link control.

    from_addr/to_addr carry the 3-bit type in bits 24-26 (use AIRCRAFT etc).
    """
    to_b = bytearray(encode_icaoaddr(to_addr))
    if on_ground:
        to_b[0] |= 2
    frm = bytearray(encode_icaoaddr(from_addr))
    frm[0] = (frm[0] & ~2) | (2 if is_response else 0)
    return np.frombuffer(bytes(to_b) + bytes(frm) + bytes([link_ctrl]), dtype=np.uint8)


def acars_payload(
    mode: str = "2",
    reg: str = ".N12345",
    ack: str = "\x15",
    label: str = "Q1",
    bid: str = "1",
    msgno: str = "M01A",
    fid: str = "AF1234",
    text: str = "",
) -> np.ndarray:
    """ACARS payload: fields + ETX + CRC16 + DEL (outacars.c:214-331 layout).

    Characters carry no parity bit (the decoder strips bit 7 and does not
    verify parity).
    """
    body = mode + reg.rjust(7, ".")[:7] + ack + label[:2] + bid
    body += "\x02"                         # STX: text present
    body += msgno[:4] + fid[:6] + text
    body += "\x03"                         # ETX block end
    raw = body.encode("latin-1")
    crc = 0
    for b in raw:
        crc = crc_update(crc, b)
    return np.frombuffer(
        raw + bytes([crc & 0xFF, crc >> 8, 0x7F]), dtype=np.uint8
    )


def acars_frame(
    from_addr: int = AIRCRAFT | 0x3C6544,
    to_addr: int = GROUND_D | 0x10902A,
    **acars_kw,
) -> np.ndarray:
    """Full frame content (flags/FCS added by the HDLC layer): AVLC header +
    ff ff 01 ACARS marker (out.c:566) + payload."""
    hdr = avlc_header(from_addr, to_addr)
    marker = np.array([0xFF, 0xFF, 0x01], dtype=np.uint8)
    return np.concatenate([hdr, marker, acars_payload(**acars_kw)])


def xid_private_params(params: list[tuple[int, bytes]]) -> bytes:
    out = b""
    for pid, val in params:
        out += bytes([pid, len(val)]) + val
    return out


def xid_frame(
    from_addr: int = AIRCRAFT | 0x3C6544,
    to_addr: int = ALL_STATIONS | 0xFFFFFF,
    params: list[tuple[int, bytes]] | None = None,
) -> np.ndarray:
    """XID frame: AVLC header (link ctrl XID) + 0x82 + groups (outxid.c)."""
    if params is None:
        # destination airport + position (48.5N 2.5E, FL350)
        lat_raw = int(48.5 * 160) & 0xFFFF
        lon_raw = int(2.5 * 160) & 0xFFFF
        pos = bytes(
            [
                (lat_raw >> 8) & 0xFF,
                (lat_raw & 0xF0) | ((lon_raw >> 12) & 0x0F),
                (lon_raw >> 4) & 0xFF,
                35,
            ]
        )
        params = [(0x83, b"LFPG"), (0x84, pos)]
    grp = xid_private_params(params)
    hdr = avlc_header(from_addr, to_addr, link_ctrl=0xBF)   # XID U-frame
    body = bytes([0x82, 0xF0, len(grp) >> 8, len(grp) & 0xFF]) + grp
    return np.concatenate([hdr, np.frombuffer(body, dtype=np.uint8)])
