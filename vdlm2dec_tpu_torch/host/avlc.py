"""AVLC frame parsing: addresses, link control, payload dispatch.

Semantics: out.c:426-504 (icaoaddr, outaddr, outlinkctrl) and the dispatch
rules of out() (out.c:517-598).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import reversebits


# per byte value: its address bits, reversed (out.c:426-435): the first
# byte carries 6 (bits 2-7), the other three 7 (bits 1-7)
_REV6 = tuple(reversebits(b >> 2, 6) for b in range(256))
_REV7 = tuple(reversebits(b >> 1, 7) for b in range(256))


def icaoaddr(b: bytes | np.ndarray, off: int = 0) -> int:
    """27-bit VDL address from 4 bytes, per-byte bit-reversed (out.c:426-435)."""
    return (
        (_REV6[int(b[off]) & 0xFF] << 21)
        | (_REV7[int(b[off + 1]) & 0xFF] << 14)
        | (_REV7[int(b[off + 2]) & 0xFF] << 7)
        | _REV7[int(b[off + 3]) & 0xFF]
    )


def encode_icaoaddr(addr: int, low_bits: int = 0) -> bytes:
    """Inverse of icaoaddr, for the modulator/test side.

    low_bits supplies the LSBs of each byte that icaoaddr discards
    (command/response + address-extension bits).
    """
    b0 = (reversebits((addr >> 21) & 0x3F, 6) << 2) | (low_bits & 3)
    b1 = reversebits((addr >> 14) & 0x7F, 7) << 1
    b2 = reversebits((addr >> 7) & 0x7F, 7) << 1
    b3 = (reversebits(addr & 0x7F, 7) << 1) | 1     # end-of-address bit
    return bytes([b0, b1, b2, b3])


ADDR_TYPE_NAMES = {
    0: "T0", 1: "Aircraft", 2: "T2", 3: "T3",
    4: "GroundA", 5: "GroundD", 6: "T6", 7: "All",
}


def format_addr(addr: int) -> str:
    """outaddr text (out.c:437-469)."""
    typ = addr >> 24
    a = addr & 0xFFFFFF
    if typ == 1:
        return f"Aircraft:{a:06X} "
    if typ == 4:
        return f"GroundA:{a:06X} "
    if typ == 5:
        return f"GroundD:{a:06X} "
    if typ == 7:
        return "All "
    return f"T{typ:1d}:{a:06X} "


S_FRAME_NAMES = ["RR", "RNR", "REJ", "SREJ"]

U_FRAME_NAMES = [
    ["UI", "SIM", "0x02", "SARM", "UP", "0x05", "0x06", "SABM",
     "DISC", "0x09", "0x0a", "SARME", "0x0c", "0x0d", "0x0e", "SABME",
     "SNRM", "0x11", "0x12", "RSET", "0x14", "0x15", "0x16", "XID",
     "0x18", "0x19", "0x1a", "SNRME", "TEST", "0x1d", "0x1e", "0x1f"],
    ["UI", "RIM", "0x02", "DM", "0x04", "0x05", "0x06", "0x07",
     "RD", "0x09", "0x0a", "0x0b", "UA", "0x0d", "0x0e", "0x0f",
     "0x10", "FRMR", "0x12", "0x13", "0x14", "0x15", "0x16", "XID",
     "0x18", "0x19", "0x1a", "0x1b", "TEST", "0x1d", "0x1e", "0x1f"],
]


def format_linkctrl(lc: int, rep: int) -> str:
    """outlinkctrl text (out.c:484-504)."""
    if lc & 1:
        if lc & 2:
            name = U_FRAME_NAMES[rep][((lc >> 3) & 0x1C) | ((lc >> 2) & 0x3)]
            return f"Frame-U: {name}\n"
        return f"Frame-S: Nr:{(lc >> 5) & 0x7:01d} {S_FRAME_NAMES[(lc >> 2) & 0x3]}\n"
    return f"Frame-I: Ns:{(lc >> 1) & 0x7:01d} Nr:{(lc >> 5) & 0x7:01d}\n"


@dataclass
class AvlcFrame:
    """Parsed AVLC frame header (frame includes both 0x7e flags)."""
    raw: np.ndarray             # full frame incl. flags
    to_addr: int                # hdata[1..4]
    from_addr: int              # hdata[5..8]
    link_ctrl: int              # hdata[9]
    is_response: int            # (hdata[5] & 2) >> 1
    on_ground: int              # hdata[1] & 2 (meaningful for air source)
    from_air: bool

    @property
    def payload(self) -> np.ndarray:
        """hdata[10 .. l-3] (payload up to FCS)."""
        return self.raw[10:-3]

    @property
    def length(self) -> int:
        return len(self.raw)


def parse_frame(frame: np.ndarray) -> AvlcFrame:
    """Parse header fields (out.c:517-537)."""
    f = np.asarray(frame)
    faddr = icaoaddr(f, 5)
    taddr = icaoaddr(f, 1)
    return AvlcFrame(
        raw=f,
        to_addr=taddr,
        from_addr=faddr,
        link_ctrl=int(f[9]),
        is_response=(int(f[5]) & 2) >> 1,
        on_ground=int(f[1]) & 2,
        from_air=(faddr >> 24) == 1,
    )
