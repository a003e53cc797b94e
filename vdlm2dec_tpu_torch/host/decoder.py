"""Frame dispatcher — the out() equivalent (out.c:517-598).

Takes CRC-valid AVLC frames from the pipeline, applies the message filters,
updates the flight tracker, decodes ACARS/XID payloads and feeds every
configured sink (text log, JSON lines, UDP JSON, TCP SBS, route/reg).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .._tables import DecodedBurst
from . import arinc
from .acars import LabelFilter, decode_label, parse_acars
from .avlc import format_addr, format_linkctrl, parse_frame
from .flights import FlightTracker
from .output import (
    NetSink,
    OutputConfig,
    add_acars_json,
    add_xid_json,
    airreg_csv,
    build_json_header,
    dumpdata,
    finish_json,
    format_date,
    route_json,
    sbs_line,
)
from .xid import decode_xid


@dataclass
class DecoderStats:
    frames: int = 0
    filtered: int = 0
    acars: int = 0
    xid: int = 0
    undecoded: int = 0


class FrameDecoder:
    def __init__(self, cfg: OutputConfig, label_filter: str | None = None,
                 time_base: float | None = None):
        self.cfg = cfg
        self.labels = LabelFilter(label_filter)
        self.flights = FlightTracker()
        self.stats = DecoderStats()
        self.json_sink = NetSink(cfg.net_json_addr, dgram=True) if cfg.net_json_addr else None
        self.sbs_sink = NetSink(cfg.net_sbs_addr, dgram=False) if cfg.net_sbs_addr else None
        # offline captures have no absolute wall clock; time_base anchors
        # burst offsets (the live path passes the capture start time)
        self.time_base = time.time() if time_base is None else time_base

    # -- main entry ---------------------------------------------------------
    def process_burst(self, burst: DecodedBurst) -> list[str]:
        """Process all valid frames of a burst; returns emitted text chunks."""
        out_chunks = []
        for frame in burst.frames:
            chunk = self.process_frame(frame, burst)
            if chunk:
                out_chunks.append(chunk)
        return out_chunks

    def process_frame(self, frame: np.ndarray, burst: DecodedBurst) -> str | None:
        cfg = self.cfg
        self.stats.frames += 1
        fr = parse_frame(frame)
        l = len(frame)
        ts = self.time_base + burst.time_s

        # filters (out.c:529-532)
        if not cfg.grndmess and not fr.from_air:
            self.stats.filtered += 1
            return None
        if not cfg.emptymess and l <= 13:
            self.stats.filtered += 1
            return None
        if (
            not cfg.undecmess
            and fr.from_air
            and ((fr.from_addr & 0xFFFFFF) == 0 or (fr.from_addr & 0xFFFFFF) == 0xFFFFFF)
        ):
            self.stats.filtered += 1
            return None

        fl = None
        if fr.from_air:
            fl = self.flights.add(fr.from_addr, ts)
            fl.gnd = fr.on_ground

        text = []
        if cfg.verbose:
            text.append(
                f"\n[#{burst.channel + 1:1d} (F:{burst.freq_hz / 1e6:3.3f} "
                f"P:{burst.ppm:+05.1f}) "
            )
            text.append(format_date(ts))
            text.append(" --------------------------------\n")
            text.append(f"{'Response' if fr.is_response else 'Command'} from ")
            text.append(format_addr(fr.from_addr))
            text.append(f"({'on ground' if (fl and fl.gnd) else 'airborne'}) to ")
            text.append(format_addr(fr.to_addr))
            text.append("\n")
            text.append(format_linkctrl(fr.link_ctrl, fr.is_response))

        jb = None
        if (cfg.jsonout or cfg.net_json_addr) and not cfg.routeout:
            jb = build_json_header(
                fr.from_addr, fr.to_addr, fr.from_air, fr.is_response,
                1 if (fl and fl.gnd) else 0, ts, burst.freq_hz, cfg.station_id,
            )

        dec = 0
        h = frame
        if l >= 14 and int(h[10]) == 0x82:
            dec |= self._do_xid(h[11 : l - 3], fl, jb, text)
        if l >= 16 and int(h[10]) == 0xFF and int(h[11]) == 0xFF and int(h[12]) == 1:
            dec |= self._do_acars(h[13 : l - 3], fl, jb, text)

        if l > 13 and dec == 0:
            self.stats.undecoded += 1
            if cfg.undecmess:
                if cfg.verbose:
                    text.append("unknown data\n")
                if jb is not None:
                    # outundec writes "%02hhx " at offset 2*i — each write
                    # overwrites the previous space, and the final NUL lands
                    # on the last space (outacars... out.c:406-418): the JSON
                    # "data" field is contiguous hex without separators
                    hexs = "".join(f"{int(b):02x}" for b in h[10 : l - 3])
                    jb.add("data", hexs)
                if cfg.verbose > 1:
                    text.append(dumpdata(h[10 : l - 3]))
            elif jb is not None:
                jb = None

        emitted = []
        if fl is not None:
            if cfg.routeout:
                rj = route_json(fl, ts, cfg.station_id)
                if rj:
                    emitted.append(rj)
            if cfg.regout:
                csv = airreg_csv(fl)
                if csv:
                    emitted.append(csv)
            if self.sbs_sink is not None:
                line = sbs_line(fl, ts)
                if line:
                    self.sbs_sink.write(line.encode())

        if jb is not None:
            js = finish_json(jb) + "\n"
            if cfg.jsonout:
                emitted.append(js.rstrip("\n"))
            if self.json_sink is not None:
                self.json_sink.write(js.encode())

        chunk = None
        if cfg.verbose and (dec or cfg.undecmess):
            chunk = "".join(text)

        out = (chunk or "")
        if emitted:
            out = out + ("\n".join(emitted) + "\n" if emitted else "")
        if chunk or emitted:
            fd = cfg.logfd()
            if chunk:
                fd.write(chunk)
                fd.flush()
            for e in emitted:
                fd.write(e + "\n")
            return out
        return None

    # -- payload decoders ---------------------------------------------------
    def _do_acars(self, payload: np.ndarray, fl, jb, text: list[str]) -> int:
        msg = parse_acars(payload)
        if msg is None:
            if self.cfg.verbose > 1:
                text.append("crc error\n")
            return 0
        if not self.labels(msg.label):
            return 0
        oooi, _ = decode_label(msg)
        lanode = arinc.arinc_decode(msg.text, msg.label, msg.bid, oooi)
        self.stats.acars += 1

        if self.cfg.verbose:
            text.append("ACARS\n")
            if msg.mode < 0x5D:
                text.append(f"Aircraft reg: {msg.reg} Flight id: {msg.fid}\n")
            text.append(f"Mode: {chr(msg.mode):1s} Msg. label: {msg.label}\n")
            text.append(f"Block id: {msg.bid} Ack: {msg.ack}\n")
            text.append(f"Msg. no: {msg.no}\n")
            if msg.text:
                text.append(f"Message :\n{msg.text}\n")
            if msg.be == 0x17:
                text.append("Block End\n")
            if lanode is not None:
                text.append(arinc.format_tree(lanode))

        if fl is not None:
            self.flights.merge_acars(fl, msg, oooi)
        if jb is not None:
            add_acars_json(jb, msg, oooi)
        return 1

    def _do_xid(self, payload: np.ndarray, fl, jb, text: list[str]) -> int:
        res = decode_xid(payload)
        if not res.decoded:
            return 0
        self.stats.xid += 1
        if fl is not None:
            self.flights.merge_xid(fl, res.info)
        if self.cfg.verbose and res.info is not None:
            for line in res.info.lines:
                text.append(line + "\n")
        if jb is not None and fl is not None:
            add_xid_json(jb, fl)
        return 1
