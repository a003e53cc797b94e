"""ARINC-622 ATS application decode: ADS-C (full tag walk) + CPDLC FANS-1/A.

The reference delegates to libacars when pkg-config finds it
(arincpos.c:120-216, CMakeLists.txt:10-21); this is a native, dependency-
free implementation of the same surface:

  * ARINC-622 envelope parse: "/<7-char ground addr>.<IMI>.<7-char
    dot-padded reg><hex payload><4 hex CRC chars>" — the application data
    is HEX characters because the ACARS text channel is 7-bit (the
    reference strips parity before arincdecode, outacars.c:224-227);
    direction from the ACARS block id (digit = downlink, arincpos.c:130-133),
    sublabel/MFI strip for H1 (la_acars_extract_sublabel_and_mfi);
  * ADS-C (IMI ADS): walk EVERY tag group of the message — the reference
    iterates the whole la_list (arincpos.c:153-164) — decoding each known
    group into text lines; the first basic report among tags
    7/9/10/18/19/20 fills oooi (lat/lon/alt/epu, arincpos.c:165-172);
  * CPDLC (IMI AT1): FANS-1/A unaligned-PER decode via host.fans — the
    full DO-258A element set in both directions (81 DMs / 183 UMs); a
    DM48 position report (top element or element sequence) fills oooi
    with lat/lon and, when positive, altitude in any of 8 encodings
    (arincpos.c:47-118, 176-213);
  * ADS-C uplink contract requests (periodic/event/demand/emergency/
    cancel) decoded group-by-group like the downlink tag walk.

ADS-C group layout per ARINC 745-2: coordinates 21-bit two's-complement
with LSB 180/2^20 deg, altitude 16-bit signed in 4 ft units, timestamp
15 bits in 0.125 s units, flight id 8 six-bit ICAO chars.  Group data
lengths follow libacars's adsc.c tag tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import fans


@dataclass
class ArincNode:
    """Decode result (stands in for la_proto_node's formatted tree)."""
    app: str                              # "adsc" | "cpdlc"
    lines: list[str] = field(default_factory=list)
    lat: float | None = None
    lon: float | None = None
    alt: int | None = None


BASIC_REPORT_TAGS = {
    7: "basic report",
    9: "emergency basic report",
    10: "lateral deviation change event",
    18: "vertical rate change event",
    19: "altitude range change event",
    20: "waypoint change event",
}

# downlink tag -> (name, data length in bytes after the tag); None length =
# computed per-message (tag 5: contract number + group count + 2 bytes per
# noncomplying group, ARINC 745-2 noncompliance notification)
DOWNLINK_TAGS = {
    3: ("acknowledgement", 1),
    4: ("negative acknowledgement", 2),
    5: ("noncompliance notification", None),
    6: ("cancel emergency mode", 0),
    7: ("basic report", 10),
    9: ("emergency basic report", 10),
    10: ("lateral deviation change event", 10),
    11: ("flight identification", 6),
    12: ("predicted route", 17),
    13: ("earth reference", 5),
    14: ("air reference", 5),
    15: ("meteorological", 4),
    16: ("airframe identification", 3),
    17: ("intermediate projected intent", 8),
    18: ("vertical rate change event", 10),
    19: ("altitude range change event", 10),
    20: ("waypoint change event", 10),
    22: ("fixed projected intent", 10),
}

COORD_LSB = 180.0 / (1 << 20)


def _s(v: int, bits: int) -> int:
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _bits(data: bytes, start: int, n: int) -> int:
    """Big-endian bit-field extract: n bits starting at bit offset start."""
    v = 0
    for i in range(start, start + n):
        v = (v << 1) | ((data[i >> 3] >> (7 - (i & 7))) & 1)
    return v


def _icao6(v: int) -> str:
    """ICAO 6-bit char set: 0x01-0x1A -> A-Z, else the low 6 bits as-is."""
    return chr(v | 0x40) if v < 0x20 else chr(v)


@dataclass
class BasicReport:
    lat: float
    lon: float
    alt: int
    ts: float                # seconds within the hour, 0.125 s resolution


def parse_basic_report(data: bytes) -> BasicReport:
    """10-byte basic group: lat(21) lon(21) alt(16) ts(15) fom(6) tcas(1)."""
    lat = _s(_bits(data, 0, 21), 21) * COORD_LSB
    lon = _s(_bits(data, 21, 21), 21) * COORD_LSB
    alt = _s(_bits(data, 42, 16), 16) * 4
    ts = _bits(data, 58, 15) * 0.125
    return BasicReport(lat, lon, alt, ts)


def _group_lines(tag: int, name: str, data: bytes) -> list[str]:
    """Decode one ADS-C group's contents into indented text lines."""
    if tag in BASIC_REPORT_TAGS:
        r = parse_basic_report(data)
        return [
            f"  {name}:",
            f"    lat {r.lat:.7f} lon {r.lon:.7f} alt {r.alt} ft"
            f" ts {r.ts:.3f} s",
        ]
    if tag == 3:
        return [f"  {name}: contract request {data[0]}"]
    if tag == 4:
        return [f"  {name}: contract request {data[0]} reason {data[1]}"]
    if tag == 5:
        if not data:
            return [f"  truncated {name}"]
        n_grp = data[1] if len(data) > 1 else 0
        grps = ", ".join(
            f"tag {data[2 + 2 * k]} reason {data[3 + 2 * k]}"
            for k in range(n_grp) if 3 + 2 * k < len(data)
        )
        return [f"  {name}: contract request {data[0]}"
                + (f" ({grps})" if grps else "")]
    if tag == 6:
        return [f"  {name}"]
    if tag == 11:
        fid = "".join(_icao6(_bits(data, 6 * i, 6)) for i in range(8))
        return [f"  flight id: {fid.strip()}"]
    if tag == 12:
        wp1 = parse_basic_report(data[:8] + b"\0\0")
        lat2 = _s(_bits(data, 74, 21), 21) * COORD_LSB
        lon2 = _s(_bits(data, 95, 21), 21) * COORD_LSB
        alt2 = _s(_bits(data, 116, 16), 16) * 4
        return [
            f"  {name}:",
            f"    next: lat {wp1.lat:.7f} lon {wp1.lon:.7f} alt {wp1.alt} ft"
            f" eta {_bits(data, 58, 16)} s",
            f"    next+1: lat {lat2:.7f} lon {lon2:.7f} alt {alt2} ft",
        ]
    if tag == 13:
        track = _bits(data, 0, 12) * (360.0 / 4096.0)
        gs = _bits(data, 12, 13) * 0.5
        vr = _s(_bits(data, 25, 12), 12) * 16
        return [f"  {name}: track {track:.1f} deg gs {gs:.1f} kt"
                f" vr {vr} ft/min"]
    if tag == 14:
        hdg = _bits(data, 0, 12) * (360.0 / 4096.0)
        mach = _bits(data, 12, 13) * 0.0005
        vr = _s(_bits(data, 25, 12), 12) * 16
        return [f"  {name}: heading {hdg:.1f} deg mach {mach:.3f}"
                f" vr {vr} ft/min"]
    if tag == 15:
        wspd = _bits(data, 0, 9) * 0.25
        wdir = _bits(data, 9, 9) * (360.0 / 512.0)
        temp = _s(_bits(data, 18, 12), 12) * 0.25
        return [f"  {name}: wind {wspd:.1f} kt @ {wdir:.1f} deg"
                f" temp {temp:.2f} C"]
    if tag == 16:
        return [f"  airframe id: {data[:3].hex().upper()}"]
    if tag == 17:
        dist = _bits(data, 0, 16) * 0.125
        track = _bits(data, 16, 12) * (360.0 / 4096.0)
        alt = _s(_bits(data, 28, 16), 16) * 4
        eta = _bits(data, 44, 16)
        return [f"  {name}: dist {dist:.1f} nm track {track:.1f} deg"
                f" alt {alt} ft eta {eta} s"]
    if tag == 22:
        r = parse_basic_report(data[:8] + b"\0\0")
        eta = _bits(data, 58, 16)
        return [f"  {name}: lat {r.lat:.7f} lon {r.lon:.7f}"
                f" alt {r.alt} ft eta {eta} s"]
    return [f"  {name}: {data.hex()}"]


def parse_adsc_downlink(payload: bytes) -> ArincNode | None:
    """Walk every tag group of an ADS-C downlink message.

    The position comes from the FIRST basic report among tags
    7/9/10/18/19/20 wherever it sits (the reference walks the whole tag
    list, arincpos.c:153-164); all recognised groups become text lines.
    Returns None when no tag is recognised at all.
    """
    node = ArincNode(app="adsc", lines=["ADS-C message:"])
    i, n = 0, len(payload)
    recognised = 0
    while i < n:
        tag = payload[i]
        entry = DOWNLINK_TAGS.get(tag)
        if entry is None:
            node.lines.append(
                f"  unknown tag {tag}: {payload[i + 1:].hex()}"
            )
            break
        name, length = entry
        if length is None:                     # tag 5: 2 + 2*group-count
            length = (2 + 2 * payload[i + 2]) if i + 2 < n else n - i - 1
        if i + 1 + length > n:
            node.lines.append(f"  truncated {name}")
            break
        data = payload[i + 1 : i + 1 + length]
        recognised += 1
        node.lines.extend(_group_lines(tag, name, data))
        if tag in BASIC_REPORT_TAGS and node.lat is None:
            r = parse_basic_report(data)
            node.lat, node.lon, node.alt = r.lat, r.lon, r.alt
        i += 1 + length
    return node if recognised else None


def _cpdlc_node(msg, prefix: str) -> ArincNode:
    node = ArincNode(app="cpdlc",
                     lines=[f"CPDLC {prefix} message:"])
    hdr = f"  msg id {msg.msg_id}"
    if msg.msg_ref is not None:
        hdr += f" ref {msg.msg_ref}"
    if msg.timestamp is not None:
        hdr += " ts {:02d}:{:02d}:{:02d}".format(*msg.timestamp)
    node.lines.append(hdr)
    tag = "UM" if prefix == "uplink" else "DM"
    for el in msg.elements:
        if isinstance(el, fans.UnsupportedElement):
            node.lines.append(
                f"  {tag}{el.index} (not decoded: {el.reason})")
            continue
        if isinstance(el, fans.Element):
            line = f"  {tag}{el.index} {el.text}"
            if not el.complete:
                line += " (tail not decoded)"
            node.lines.append(line)
            continue
        # DM48 PositionReport
        if el.position is None:
            node.lines.append("  DM48 POSITION REPORT")
        else:
            node.lines.append(
                f"  DM48 POSITION REPORT: lat {el.position.lat:.7f}"
                f" lon {el.position.lon:.7f}"
                f" at {el.hours:02d}:{el.minutes:02d}"
            )
        a = el.altitude
        node.lines.append(
            f"    altitude: {a.encoding}={a.value} ({a.feet} ft)"
        )
        node.lines.extend(f"    {x}" for x in el.extras)
    return node


def parse_cpdlc_downlink(payload: bytes) -> ArincNode | None:
    """FANS-1/A ATCDownlinkMessage -> node (+ DM48 position when present,
    arincpos.c:176-213)."""
    try:
        msg = fans.decode_downlink(payload)
    except ValueError:
        return None
    node = _cpdlc_node(msg, "downlink")
    rpt = fans.find_dm48(msg)
    if rpt is not None:
        node.lat = rpt.position.lat
        node.lon = rpt.position.lon
        node.alt = rpt.altitude.feet
    return node


def parse_cpdlc_uplink(payload: bytes) -> ArincNode | None:
    """FANS-1/A ATCUplinkMessage -> node.  The reference decodes uplinks
    through the same libacars call (arincpos.c:130-143 sets direction and
    decodes either way); no position is extracted from uplinks."""
    try:
        msg = fans.decode_uplink(payload)
    except ValueError:
        return None
    return _cpdlc_node(msg, "uplink")


# -- ADS-C uplink (contract requests) ---------------------------------------
# ARINC 745-2 uses the same one-octet tag framing in both directions with
# direction-dependent meaning; the uplink request tags mirror the downlink
# report tags they solicit (7 periodic / 9 emergency-periodic / 8 event /
# 6 demand, with per-group sub-requests reusing the downlink group tags).
# NOTE: reconstructed layout — neither ARINC 745-2 nor libacars is
# available in this environment to verify the field encodings; the tag
# structure is pinned by the repo's own unit vectors (tests/test_arinc.py)
# and documented in PARITY.md.  The reference prints these via libacars
# (arincpos.c:130-143, direction-agnostic decode).
MODULATED_GROUPS = {
    11: "flight identification",
    12: "predicted route",
    13: "earth reference",
    14: "air reference",
    15: "meteorological",
    16: "airframe identification",
    17: "intermediate projected intent",
    22: "fixed projected intent",
}

EVENT_GROUPS = {
    10: ("lateral deviation change", 1),     # threshold, 1/8 nm units
    18: ("vertical rate change", 1),         # threshold, 64 ft/min units
    19: ("altitude range", 4),               # ceiling/floor, 4 ft units
    20: ("waypoint change", 0),
}


def _interval_seconds(b: int) -> int:
    """Reporting-interval octet: 2-bit scale + 6-bit rate,
    seconds = rate << (2*scale)."""
    return (b & 0x3F) << (2 * (b >> 6))


def _parse_contract_groups(name: str, data: bytes, periodic: bool,
                           lines: list[str]) -> None:
    """Shared body of periodic/demand contract requests: contract number,
    then (periodic only) reporting interval, then modulated group
    requests (group tag + 1-byte modulus)."""
    if not data:
        lines.append(f"  truncated {name}")
        return
    lines.append(f"  {name}: contract {data[0]}")
    i = 1
    if periodic:
        if len(data) < 2:
            lines.append("    (no reporting interval)")
            return
        lines.append(f"    reporting interval:"
                     f" {_interval_seconds(data[1])} s")
        i = 2
    while i < len(data):
        tag = data[i]
        grp = MODULATED_GROUPS.get(tag)
        if grp is None or i + 1 >= len(data):
            lines.append(f"    unknown group request"
                         f" {data[i:].hex()}")
            break
        lines.append(f"    {grp} group: every {data[i + 1]} reports")
        i += 2


def _parse_event_contract(data: bytes, lines: list[str]) -> None:
    if not data:
        lines.append("  truncated event contract request")
        return
    lines.append(f"  event contract request: contract {data[0]}")
    i = 1
    while i < len(data):
        tag = data[i]
        entry = EVENT_GROUPS.get(tag)
        if entry is None:
            lines.append(f"    unknown event {data[i:].hex()}")
            break
        name, length = entry
        body = data[i + 1 : i + 1 + length]
        if len(body) < length:
            lines.append(f"    truncated {name} event")
            break
        if tag == 10:
            lines.append(f"    {name} event:"
                         f" threshold {body[0] * 0.125:.3f} nm")
        elif tag == 18:
            lines.append(f"    {name} event:"
                         f" threshold {body[0] * 64} ft/min")
        elif tag == 19:
            ceil = _s(int.from_bytes(body[0:2], "big"), 16) * 4
            floor = _s(int.from_bytes(body[2:4], "big"), 16) * 4
            lines.append(f"    {name} event:"
                         f" ceiling {ceil} ft floor {floor} ft")
        else:
            lines.append(f"    {name} event")
        i += 1 + length
    return


def parse_adsc_uplink(payload: bytes) -> ArincNode | None:
    """Decode an ADS-C uplink (ground->air contract request) message."""
    node = ArincNode(app="adsc", lines=["ADS-C uplink:"])
    i, n = 0, len(payload)
    recognised = 0
    while i < n:
        tag = payload[i]
        rest = payload[i + 1:]
        if tag == 1:
            node.lines.append("  cancel all contracts")
            i += 1
        elif tag == 2:
            if not rest:
                node.lines.append("  truncated cancel contract")
                break
            node.lines.append(f"  cancel contract {rest[0]}")
            i += 2
        elif tag == 24:
            node.lines.append("  cancel emergency mode")
            i += 1
        elif tag in (6, 7, 9):
            name = {6: "demand contract request",
                    7: "periodic contract request",
                    9: "emergency periodic contract request"}[tag]
            _parse_contract_groups(name, rest, tag in (7, 9), node.lines)
            i = n                           # greedy: consumes the tail
        elif tag == 8:
            _parse_event_contract(rest, node.lines)
            i = n
        else:
            node.lines.append(f"  unknown uplink tag {tag}:"
                              f" {rest.hex()}")
            break
        recognised += 1
    return node if recognised else None


def extract_sublabel_mfi(label: str, text: str) -> tuple[str, str, int]:
    """ARINC-622 sublabel/MFI strip (la_acars_extract_sublabel_and_mfi).

    For label H1 the text begins '#<sublabel>' optionally followed by
    'B<mfi>'; returns (sublabel, mfi, offset into text).
    """
    if label != "H1" or len(text) < 3 or text[0] != "#":
        return "", "", 0
    sub = text[1:3]
    off = 3
    mfi = ""
    if len(text) >= 6 and text[3] == "B":
        mfi = text[4:6]
        # MFI is consumed only for certain apps; keep offset at sublabel
    return sub, mfi, off


CPDLC_IMIS = ("AT1", "CR1", "CC1", "DR1")


def crc16_ccitt(data: bytes, init: int = 0xFFFF) -> int:
    """CRC-16/CCITT-FALSE (poly 0x1021, MSB-first) over the ARINC-622
    IMI + registration + application data."""
    crc = init
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
    return crc


def _unwrap_payload(imi: str, reg: str, hextext: str):
    """Hex payload -> (app data bytes, crc_ok).  None when not valid hex."""
    hexs = "".join(ch for ch in hextext if ch not in " \r\n")
    if len(hexs) < 6 or len(hexs) % 2:
        return None
    try:
        blob = bytes.fromhex(hexs)
    except ValueError:
        return None
    # The 16-bit BCS trailer is appended MSB-first: CRC-16/CCITT-FALSE is
    # a non-reflected MSB-first CRC, and appending it big-endian is the
    # convention that makes crc(message + trailer) == 0 — which is how we
    # verify it (one order only; a little-endian trailer fails).  Policy
    # on mismatch: decode anyway and annotate (the reference's libacars
    # also surfaces the decode with an error flag rather than dropping).
    data = blob[:-2]
    crc_ok = crc16_ccitt((imi + reg).encode("latin-1") + blob) == 0
    return data, crc_ok


def arinc_decode(text: str, label: str, bid: str, oooi) -> ArincNode | None:
    """arincdecode equivalent (arincpos.c:120-216).

    Returns a node for recognised ATS applications and fills oooi with any
    extracted position, else None.  Direction: digit block id = downlink
    (arincpos.c:130-133); uplinks decode through the same apps
    (arincpos.c:143 is direction-agnostic) but position extraction only
    ever reads downlink reports (arincpos.c:146-213).
    """
    if not text:
        return None
    downlink = "0" <= bid <= "9"

    body = text
    if label == "H1":
        _, _, off = extract_sublabel_mfi(label, text)
        body = text[off:]
    if not (body.startswith("/") and len(body) > 19 and body[8] == "."):
        return None
    imi = body[9:12]
    if imi != "ADS" and imi not in CPDLC_IMIS:
        return None
    reg = body[12:19]                  # 7 chars, dot-padded on the left
    unwrapped = _unwrap_payload(imi, reg, body[19:])
    if unwrapped is None:
        return None
    payload, crc_ok = unwrapped

    if imi == "ADS":
        if not downlink:
            node = parse_adsc_uplink(payload)
            if node is not None and not crc_ok:
                node.lines.append("  crc mismatch (decoded anyway)")
            return node
        node = parse_adsc_downlink(payload)
        if node is not None and not crc_ok:
            node.lines.append("  crc mismatch (decoded anyway)")
        if node is not None and node.lat is not None:
            # arincpos.c:165-170: epu flags a valid position; alt is
            # copied unconditionally from the basic report
            oooi.epu = 1
            oooi.lat = node.lat
            oooi.lon = node.lon
            oooi.alt = node.alt
        return node
    if imi in CPDLC_IMIS:
        if imi != "AT1":
            return ArincNode(app="cpdlc", lines=[f"CPDLC {imi} message"])
        if not downlink:
            node = parse_cpdlc_uplink(payload)
            if node is not None and not crc_ok:
                node.lines.append("  crc mismatch (decoded anyway)")
            return node
        node = parse_cpdlc_downlink(payload)
        if node is not None and not crc_ok:
            node.lines.append("  crc mismatch (decoded anyway)")
        if node is not None and node.lat is not None:
            # arincpos.c:111-116: lat/lon always; alt only when positive
            oooi.epu = 1
            oooi.lat = node.lat
            oooi.lon = node.lon
            if node.alt and node.alt > 0:
                oooi.alt = node.alt
        return node
    return None


def format_tree(node: ArincNode | None) -> str:
    if node is None:
        return ""
    return "".join(line + "\n" for line in node.lines)
