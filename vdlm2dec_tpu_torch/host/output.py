"""Output sinks: text log, JSON lines, UDP JSON feed, TCP SBS feed,
route/registration outputs.

Behavioral parity targets:
  text format      out.c:539-554, 373-424 (vout/dumpdata/outundec/printdate)
  JSON object      buildjsonobj out.c:219-253 + addacarsjson outacars.c:152-212
                   + buildxidjson outxid.c:226-241 — field order and the
                   raw-number formatting quirks (freq "%3.3f", lat "%3.3f",
                   lon "%4.3f" truncated to 7 chars, xid lat/lon "%3.1f")
  SBS lines        outsbs out.c:159-192
  net sinks        initNetOutput/Netwrite out.c:56-157 (UDP json, TCP sbs,
                   [IPv6]:port parsing, default port 5555, reconnect)
"""
from __future__ import annotations

import json
import socket
import sys
import time
from dataclasses import dataclass
from datetime import datetime, timezone
from json.encoder import encode_basestring_ascii as _json_str

import numpy as np

from .acars import AcarsMessage, Oooi
from .flights import Flight

APP_NAME = "vdlm2dec"
APP_VER = "2.3"          # behavioral-parity version (VDLM2DEC_VERSION)


def _snprintf_trunc(fmt: str, value: float, size: int = 8) -> str:
    """Replicate snprintf(buf, 8, ...) truncation (convert_tmp[8] quirks,
    outacars.c:155,201-205)."""
    return (fmt % value)[: size - 1]


@dataclass
class OutputConfig:
    verbose: int = 1
    jsonout: bool = False
    routeout: bool = False
    regout: bool = False
    grndmess: bool = False
    emptymess: bool = False
    undecmess: bool = False
    station_id: str = ""
    net_json_addr: str | None = None
    net_sbs_addr: str | None = None
    logfile: object = None          # file-like; default stdout

    def logfd(self):
        return self.logfile if self.logfile is not None else sys.stdout


def parse_netaddr(raw: str) -> tuple[str, str, int]:
    """Address parsing incl. [IPv6]:port, default port 5555 (out.c:76-100).

    Returns (addr, port, family_hint) with family AF_INET6 for [..] form.
    """
    if raw.startswith("["):
        end = raw.find("]")
        if end < 0:
            raise ValueError("Invalid IPV6 address")
        addr = raw[1:end]
        rest = raw[end + 1 :]
        port = rest[1:] if rest.startswith(":") else "5555"
        return addr, port, socket.AF_INET6
    if ":" in raw:
        addr, port = raw.rsplit(":", 1)
        return addr, port, socket.AF_UNSPEC
    return raw, "5555", socket.AF_UNSPEC


class NetSink:
    """Auto-(re)connecting socket sink (Netwrite, out.c:137-157)."""

    def __init__(self, raw_addr: str, dgram: bool):
        self.raw = raw_addr
        self.dgram = dgram
        self.sock: socket.socket | None = None

    def _connect(self) -> None:
        addr, port, fam = parse_netaddr(self.raw)
        typ = socket.SOCK_DGRAM if self.dgram else socket.SOCK_STREAM
        for res in socket.getaddrinfo(addr, port, fam, typ):
            af, st, proto, _, sa = res
            try:
                s = socket.socket(af, st, proto)
                s.connect(sa)
                self.sock = s
                return
            except OSError:
                continue
        self.sock = None

    def write(self, data: bytes) -> int:
        if self.sock is None:
            try:
                self._connect()
            except (OSError, ValueError):
                self.sock = None
        if self.sock is None:
            return -1
        try:
            n = self.sock.send(data)
        except OSError:
            n = -1
        if n != len(data):
            try:
                self.sock.close()
            finally:
                self.sock = None
        return n


def format_date(t: float) -> str:
    """printdate (out.c:506-515): dd/mm/yyyy HH:MM:SS.mmm UTC."""
    dt = datetime.fromtimestamp(int(t), tz=timezone.utc)
    ms = int((t - int(t)) * 1e6) // 1000
    return (
        f"{dt.day:02d}/{dt.month:02d}/{dt.year:04d} "
        f"{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}.{ms:03d}"
    )


def dumpdata(p: np.ndarray) -> str:
    """Hexdump (out.c:386-404)."""
    out = []
    n = len(p)
    for i in range(0, n, 16):
        line = ""
        for k in range(16):
            line += f"{int(p[i + k]):02x} " if i + k < n else "   "
        line += "   |"
        for k in range(16):
            if i + k < n and 0x20 <= int(p[i + k]) <= 0x7E:
                line += chr(int(p[i + k]))
            else:
                line += "."
        line += "|"
        out.append(line)
    return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# JSON building.  cJSON prints numbers with up to 17 significant digits and
# trims; we emit with repr-like compaction.  "Raw" fields (freq, lat, lon)
# are pre-formatted strings inserted without quotes.
# ---------------------------------------------------------------------------


class JsonBuilder:
    """Ordered JSON object with raw-literal support (cJSON_AddRawToObject)."""

    def __init__(self):
        self.items: list[tuple[str, object, bool]] = []

    def add(self, key: str, value, raw: bool = False):
        self.items.append((key, value, raw))

    def render(self) -> str:
        # keys and strings as json.dumps writes them (ASCII, escaped); bool
        # before int, since a bool is an int; floats and the rest through
        # json.dumps
        parts = []
        for key, value, raw in self.items:
            if raw:
                sval = str(value)
            elif value is True:
                sval = "true"
            elif value is False:
                sval = "false"
            elif isinstance(value, str):
                sval = _json_str(value)
            elif isinstance(value, int):
                sval = str(value)
            else:
                sval = json.dumps(value)
            parts.append(_json_str(key) + ":" + sval)
        return "{" + ",".join(parts) + "}"


def build_json_header(
    faddr: int,
    taddr: int,
    fromair: bool,
    isresponse: int,
    isonground: int,
    timestamp: float,
    freq_hz: float,
    station_id: str,
) -> JsonBuilder:
    """buildjsonobj (out.c:219-253)."""
    jb = JsonBuilder()
    jb.add("timestamp", timestamp)
    if station_id:
        jb.add("station_id", station_id)
    jb.add("freq", _snprintf_trunc("%3.3f", freq_hz / 1e6), raw=True)
    if fromair:
        jb.add("hex", f"{faddr & 0xFFFFFF:06X}")
        jb.add("icao", faddr & 0xFFFFFF)
        jb.add("toaddr", taddr & 0xFFFFFF)
    else:
        jb.add("fromaddr", faddr & 0xFFFFFF)
        jb.add("icao", taddr & 0xFFFFFF)
        jb.add("hex", f"{taddr & 0xFFFFFF:06X}")
    if isresponse:
        jb.add("is_response", isresponse)
    if isonground:
        jb.add("is_onground", isonground)
    # cJSON appends the app object at build time, so it precedes the
    # ACARS/XID fields added later (out.c:248-252)
    jb.add("app", APP_JSON, raw=True)
    return jb


def _app_json() -> str:
    app = JsonBuilder()
    app.add("name", APP_NAME)
    app.add("ver", APP_VER)
    return app.render()


APP_JSON = _app_json()


def finish_json(jb: JsonBuilder) -> str:
    return jb.render()


def add_acars_json(jb: JsonBuilder, msg: AcarsMessage, oooi: Oooi | None) -> None:
    """addacarsjson (outacars.c:152-212)."""
    jb.add("mode", chr(msg.mode))
    jb.add("label", msg.label)
    # reference: if(msg->bid) — a zero bid byte was replaced by ' ' during
    # parsing (outacars.c:256-258), so ' ' here means "absent"
    if msg.bid != " ":
        jb.add("block_id", msg.bid)
        # outacars.c:166-171 tests ack==0x15 for a JSON false, but the parse
        # already replaced 0x15 with '!' (outacars.c:244-245), so the false
        # branch is dead and the reference always emits the character
        jb.add("ack", msg.ack)
        jb.add("tail", msg.reg)
        if msg.mode <= ord("Z"):
            jb.add("flight", msg.fid)
            jb.add("msgno", msg.no)
    if msg.text:
        jb.add("text", msg.text)
    if msg.be == 0x17:
        jb.add("end", True)
    if oooi:
        if oooi.sa:
            jb.add("depa", oooi.sa)
        if oooi.da:
            jb.add("dsta", oooi.da)
        if oooi.eta:
            jb.add("eta", oooi.eta)
        if oooi.gout:
            jb.add("gtout", oooi.gout)
        if oooi.gin:
            jb.add("gtin", oooi.gin)
        if oooi.woff:
            jb.add("wloff", oooi.woff)
        if oooi.won:
            jb.add("wlin", oooi.won)
        if oooi.epu:
            jb.add("lat", _snprintf_trunc("%3.3f", oooi.lat), raw=True)
            jb.add("lon", _snprintf_trunc("%4.3f", oooi.lon), raw=True)
            jb.add("epu", oooi.epu)
        if oooi.alt:
            jb.add("alt", oooi.alt)


def add_xid_json(jb: JsonBuilder, fl: Flight) -> None:
    """buildxidjson (outxid.c:226-241)."""
    if fl.oooi.da:
        jb.add("dsta", fl.oooi.da)
    if fl.oooi.epu:
        jb.add("lat", _snprintf_trunc("%3.1f", fl.oooi.lat, 10), raw=True)
        jb.add("lon", _snprintf_trunc("%4.1f", fl.oooi.lon, 10), raw=True)
        jb.add("epu", fl.oooi.epu)
        if fl.oooi.alt:
            jb.add("alt", fl.oooi.alt)


def route_json(fl: Flight, t: float, station_id: str) -> str | None:
    """routejson (out.c:312-357): one-shot flight-route + icao/tail."""
    jb = None
    if fl.rt == 0 and fl.fid and fl.oooi.sa and fl.oooi.da:
        jb = JsonBuilder()
        jb.add("timestamp", t)
        if station_id:
            jb.add("station_id", station_id)
        jb.add("flight", fl.fid)
        jb.add("depa", fl.oooi.sa)
        jb.add("dsta", fl.oooi.da)
        fl.rt = 1
    if fl.gt == 0 and fl.reg:
        if jb is None:
            jb = JsonBuilder()
            jb.add("timestamp", t)
            if station_id:
                jb.add("station_id", station_id)
        jb.add("icao", f"{fl.addr & 0xFFFFFF:06X}")
        jb.add("tail", fl.reg)
        fl.gt = 1
    return jb.render() if jb is not None else None


def airreg_csv(fl: Flight) -> str | None:
    """airreg (out.c:359-371): one-shot 'ICAO,REG' CSV line."""
    if fl.gt == 0 and fl.reg:
        fl.gt = 1
        return f"{fl.addr & 0xFFFFFF:06X},{fl.reg}"
    return None


def sbs_line(fl: Flight, recv_t: float, now: float | None = None) -> str | None:
    """outsbs (out.c:159-192): BaseStation MSG,1 / MSG,3 line."""
    if not fl.reg and fl.oooi.epu == 0:
        return None
    now = time.time() if now is None else now
    rt = datetime.fromtimestamp(int(recv_t), tz=timezone.utc)
    nt = datetime.fromtimestamp(int(now), tz=timezone.utc)
    msgtype = 3 if fl.oooi.epu else 1
    p = f"MSG,{msgtype},1,1,{fl.addr & 0xFFFFFF:06X},1,"
    p += f"{rt.year:04d}/{rt.month:02d}/{rt.day:02d},"
    p += f"{rt.hour:02d}:{rt.minute:02d}:{rt.second:02d}." \
         f"{int((recv_t % 1) * 1000):03d},"
    p += f"{nt.year:04d}/{nt.month:02d}/{nt.day:02d},"
    p += f"{nt.hour:02d}:{nt.minute:02d}:{nt.second:02d}." \
         f"{int((now % 1) * 1000):03d}"
    p += f",{fl.reg}" if fl.reg else ","
    p += f",{fl.oooi.alt}" if fl.oooi.alt else ","
    p += ",,"
    if fl.oooi.epu:
        p += f",{fl.oooi.lat:1.6f},{fl.oooi.lon:1.6f}"
    else:
        p += ",,"
    p += ",,,,,,"
    if fl.gnd:
        p += "-1"
    return p + "\r\n"
