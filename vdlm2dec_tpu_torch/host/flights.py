"""Flight tracker: in-memory MRU list keyed by ICAO address.

Semantics: addFlight (out.c:256-310) — move-to-front on every message,
1800 s expiry sweep, per-message reset of the position/altitude fields,
one-shot route/registration latches (rt/gt, acars.h:56).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .acars import Oooi

EXPIRY_S = 1800


@dataclass
class Flight:
    addr: int
    reg: str = ""
    fid: str = ""
    gnd: int = 0
    ts: float = 0.0            # first seen
    tl: float = 0.0            # last seen
    nbm: int = 0
    rt: int = 0                # route json emitted
    gt: int = 0                # registration emitted
    oooi: Oooi = field(default_factory=Oooi)


class FlightTracker:
    def __init__(self):
        self._flights = []                 # MRU order, head = most recent

    @property
    def _flights(self) -> list[Flight]:
        return self._list

    @_flights.setter
    def _flights(self, flights: list[Flight]) -> None:
        self._list = flights
        # a lower bound of every entry's tl; NaN, unknown: the next add
        # sweeps and sets it
        self._tl_floor = float("nan")

    def add(self, addr: int, now: float) -> Flight:
        flights = self._list
        fl = None
        for i, f in enumerate(flights):
            if f.addr == addr:
                fl = flights.pop(i)
                break
        if fl is None:
            fl = Flight(addr=addr, ts=now)
        fl.tl = now
        fl.oooi.epu = 0
        fl.oooi.alt = 0
        fl.nbm += 1
        flights.insert(0, fl)
        if now < self._tl_floor:
            self._tl_floor = now
        # the sweep keeps the entries with tl >= now - EXPIRY_S; while the
        # floor passes that test, so does every entry, and the list stands
        cut = now - EXPIRY_S
        if not self._tl_floor >= cut:
            self._list = [f for f in flights if f.tl >= cut]
            self._tl_floor = min((f.tl for f in self._list),
                                 default=float("inf"))
        return fl

    def merge_acars(self, fl: Flight, msg, oooi: Oooi) -> None:
        """outacars.c:303-319 field merge."""
        fl.fid = msg.fid[:6]
        fl.reg = msg.reg[:8]
        for attr in ("da", "sa", "eta", "gout", "gin", "woff", "won"):
            v = getattr(oooi, attr)
            if v:
                setattr(fl.oooi, attr, v[:4])
        if oooi.epu:
            fl.oooi.epu = oooi.epu
            fl.oooi.lat = oooi.lat
            fl.oooi.lon = oooi.lon
        fl.oooi.alt = oooi.alt

    def merge_xid(self, fl: Flight, info) -> None:
        """addfl (outxid.c:243-262)."""
        if info is None:
            return
        if info.dst_airport is not None:
            fl.oooi.da = info.dst_airport[:4]
        if info.lat is not None:
            fl.oooi.lat = info.lat
            fl.oooi.lon = info.lon
            if info.lat != 0 or info.lon != 0:
                fl.oooi.epu = 6
            fl.oooi.alt = info.alt or 0

    def __len__(self) -> int:
        return len(self._list)

    def flights(self) -> list[Flight]:
        return list(self._list)
