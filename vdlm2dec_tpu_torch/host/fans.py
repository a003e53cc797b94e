"""FANS-1/A CPDLC ASN.1 unaligned-PER codec (full element set).

The reference decodes CPDLC through libacars's generated ASN.1 modules
(arincpos.c:22-34) and consumes one shape from the decode result: the
DM48 position report — lat/lon (optional tenths of minutes) and altitude
in any of 8 encodings (parse_altitude arincpos.c:47-90; extract_position
arincpos.c:92-118), found either as the message's element id or inside
the element-id sequence (arincpos.c:176-213).  The rest of the decode
tree is printed as text (outacars.c:141-147).

This module is a from-scratch unaligned-PER runtime plus a declarative
schema of the FANS-1/A (DO-258A) message set: all 81 downlink elements
(dM0..dM80) and all 183 uplink elements (uM0..uM182), so the decoder can
walk a multi-element message past any modelled element (unaligned PER
carries no per-element length, so walking requires modelling every type
encountered).  A handful of large structures whose layouts are not
publicly pinned down (FANSRouteClearance, the UM73 predeparture
clearance, the UM91 hold clearance, the UM163 tp4table) are marked
Opaque: their text is labelled and the walk stops there.

Provenance: libacars is not present in this environment and DO-258A is
not distributable, so the field ranges follow the ICAO Doc 9705 ATN
CPDLC ASN.1 (from which the FANS set and it share a DO-219 ancestry)
where DO-258A values are not independently known.  Every range only
affects bit widths; the schema is exercised by round-trip fuzz over
every element type plus hand-computed bit-exact vectors (see
tests/test_fans_full.py).  PARITY.md lists which layouts are
spec-certain vs reconstructed.
"""
from __future__ import annotations

from dataclasses import dataclass, field

M2FT = 3.28084     # meters -> feet (arincpos.c:50)


# -- bit-level PER runtime ----------------------------------------------------
class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                      # bit cursor

    def read(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            raise ValueError("PER decode ran past end of data")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            bit = (byte >> (7 - (self.pos & 7))) & 1
            v = (v << 1) | bit
            self.pos += 1
        return v

    def remaining(self) -> int:
        return 8 * len(self.data) - self.pos


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def bytes(self) -> bytes:
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 1 << (7 - (i & 7))
        return bytes(out)


def _width(lo: int, hi: int) -> int:
    span = hi - lo
    return max(span.bit_length(), 0)


def read_int(r: BitReader, lo: int, hi: int) -> int:
    w = _width(lo, hi)
    v = lo + (r.read(w) if w else 0)
    if v > hi:
        raise ValueError(f"PER integer {v} above range [{lo}, {hi}]")
    return v


def write_int(w: BitWriter, v: int, lo: int, hi: int) -> None:
    if not lo <= v <= hi:
        raise ValueError(f"{v} outside PER range [{lo}, {hi}]")
    bw = _width(lo, hi)
    if bw:
        w.write(v - lo, bw)


# -- schema algebra ------------------------------------------------------------
# Generic decoded representations:
#   Int -> int, Enum -> str, IA5/NumStr -> str, Seq -> dict (absent
#   optionals omitted), SeqOf -> list, Choice -> (alt_name, value),
#   Null -> None.
class Int:
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi


class Enum:
    def __init__(self, *names: str):
        self.names = names


class IA5:
    """IA5String, 7 bits/char in unaligned PER; constrained SIZE(lo..hi)."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi


# PER alphabet for NumericString, sorted by ASCII: space then digits.
_NUMSTR_ALPHABET = " 0123456789"


class NumStr:
    """NumericString SIZE(n..n): 4 bits/char over ' 0123456789'."""

    def __init__(self, n: int):
        self.n = n


OPT = "optional"


class Seq:
    """fields: (name, type) or (name, type, OPT)."""

    def __init__(self, *fields):
        self.fields = tuple(
            (f[0], f[1], len(f) > 2 and f[2] == OPT) for f in fields
        )


class SeqOf:
    def __init__(self, lo: int, hi: int, typ):
        self.lo, self.hi, self.typ = lo, hi, typ


class Choice:
    def __init__(self, *alts):
        self.alts = tuple(alts)          # (name, type)
        self.index = {name: i for i, (name, _t) in enumerate(alts)}


class Null:
    pass


NULL = Null()


class Opaque:
    """A type whose layout is not modelled; decoding stops the walk."""

    def __init__(self, reason: str):
        self.reason = reason


class OpaqueHit(Exception):
    """Raised when decode reaches an Opaque type; carries any prefix
    fields already decoded (so e.g. the position of uM79 'CLEARED TO
    [position] VIA [route clearance]' is still extracted)."""

    def __init__(self, reason: str, partial=None):
        super().__init__(reason)
        self.reason = reason
        self.partial = partial


def decode(r: BitReader, typ):
    if isinstance(typ, Null):
        return None
    if isinstance(typ, Int):
        return read_int(r, typ.lo, typ.hi)
    if isinstance(typ, Enum):
        i = r.read(_width(0, len(typ.names) - 1))
        if i >= len(typ.names):
            raise ValueError(f"PER enum index {i} out of range")
        return typ.names[i]
    if isinstance(typ, IA5):
        n = read_int(r, typ.lo, typ.hi)
        chars = []
        for _ in range(n):
            c = r.read(7)
            if c < 0x20 or c > 0x7E:
                raise ValueError(f"non-printable IA5 char {c:#x}")
            chars.append(chr(c))
        return "".join(chars)
    if isinstance(typ, NumStr):
        out = []
        for _ in range(typ.n):
            i = r.read(4)
            if i >= len(_NUMSTR_ALPHABET):
                raise ValueError(f"NumericString index {i} out of range")
            out.append(_NUMSTR_ALPHABET[i])
        return "".join(out)
    if isinstance(typ, Seq):
        present = {}
        for name, ftyp, opt in typ.fields:
            if opt:
                present[name] = r.read(1)
        out = {}
        for name, ftyp, opt in typ.fields:
            if opt and not present[name]:
                continue
            try:
                out[name] = decode(r, ftyp)
            except OpaqueHit as e:
                raise OpaqueHit(e.reason, out) from None
        return out
    if isinstance(typ, SeqOf):
        n = read_int(r, typ.lo, typ.hi)
        return [decode(r, typ.typ) for _ in range(n)]
    if isinstance(typ, Choice):
        i = read_int(r, 0, len(typ.alts) - 1)
        name, alt = typ.alts[i]
        return (name, decode(r, alt))
    if isinstance(typ, Opaque):
        raise OpaqueHit(typ.reason)
    raise TypeError(f"unknown schema node {typ!r}")


def encode(w: BitWriter, typ, val) -> None:
    if isinstance(typ, Null):
        return
    if isinstance(typ, Int):
        write_int(w, val, typ.lo, typ.hi)
        return
    if isinstance(typ, Enum):
        w.write(typ.names.index(val), _width(0, len(typ.names) - 1))
        return
    if isinstance(typ, IA5):
        if not typ.lo <= len(val) <= typ.hi:
            raise ValueError(f"IA5 length {len(val)} outside "
                             f"[{typ.lo}, {typ.hi}]")
        write_int(w, len(val), typ.lo, typ.hi)
        for c in val:
            w.write(ord(c), 7)
        return
    if isinstance(typ, NumStr):
        assert len(val) == typ.n
        for c in val:
            w.write(_NUMSTR_ALPHABET.index(c), 4)
        return
    if isinstance(typ, Seq):
        for name, ftyp, opt in typ.fields:
            if opt:
                w.write(1 if name in val else 0, 1)
        for name, ftyp, opt in typ.fields:
            if opt and name not in val:
                continue
            encode(w, ftyp, val[name])
        return
    if isinstance(typ, SeqOf):
        write_int(w, len(val), typ.lo, typ.hi)
        for item in val:
            encode(w, typ.typ, item)
        return
    if isinstance(typ, Choice):
        name, inner = val
        i = typ.index[name]
        write_int(w, i, 0, len(typ.alts) - 1)
        encode(w, typ.alts[i][1], inner)
        return
    if isinstance(typ, Opaque):
        raise ValueError(f"cannot encode opaque type: {typ.reason}")
    raise TypeError(f"unknown schema node {typ!r}")


# -- FANS-1/A component types ----------------------------------------------
# FANSAltitude CHOICE order and unit conversions follow the reference's
# switch exactly (parse_altitude, arincpos.c:52-88).
ALTITUDE_CHOICES = (
    ("altitudeQNH", -60, 7000, lambda v: v * 10),
    ("altitudeQNHMeters", -30, 25000, lambda v: round(v * M2FT)),
    ("altitudeQFE", -60, 7000, lambda v: v * 10),
    ("altitudeQFEMeters", -30, 25000, lambda v: round(v * M2FT)),
    ("altitudeGNSSFeet", -600, 70000, lambda v: v),
    ("altitudeGNSSMeters", -200, 22000, lambda v: round(v * M2FT)),
    ("altitudeFlightLevel", 30, 600, lambda v: v * 100),
    ("altitudeFlightLevelMetric", 100, 2500, lambda v: round(v * 10.0 * M2FT)),
)
ALT_INDEX = {name: i for i, (name, *_rest) in enumerate(ALTITUDE_CHOICES)}
ALT_FEET = {name: conv for name, _lo, _hi, conv in ALTITUDE_CHOICES}

ALTITUDE = Choice(*((name, Int(lo, hi))
                    for name, lo, hi, _c in ALTITUDE_CHOICES))

TIME = Seq(("hours", Int(0, 23)), ("minutes", Int(0, 59)))

LATITUDE = Seq(("degrees", Int(0, 90)),
               ("minutes", Int(0, 599), OPT),
               ("direction", Enum("north", "south")))
LONGITUDE = Seq(("degrees", Int(0, 180)),
                ("minutes", Int(0, 599), OPT),
                ("direction", Enum("east", "west")))
LATLON = Seq(("latitude", LATITUDE), ("longitude", LONGITUDE))

DEGREES = Choice(("degreesMagnetic", Int(1, 360)),
                 ("degreesTrue", Int(1, 360)))
DISTANCE = Int(0, 9999)                  # nm (reconstructed range)
PBD = Seq(("fixname", IA5(1, 5)),
          ("latitudeLongitude", LATLON, OPT),
          ("degrees", DEGREES),
          ("distance", DISTANCE))

# FANSPosition CHOICE order per DO-258A: fixname, navaid, airport,
# latitudeLongitude, placeBearingDistance (arincpos.c:95 keys on the
# latitudeLongitude alternative).
POSITION = Choice(("fixName", IA5(1, 5)),
                  ("navaid", IA5(1, 4)),
                  ("airport", IA5(4, 4)),
                  ("latitudeLongitude", LATLON),
                  ("placeBearingDistance", PBD))
POSITION_LATLON = 3
N_POSITION_CHOICES = 5

SPEED = Choice(("speedIndicated", Int(0, 400)),
               ("speedTrue", Int(0, 2000)),
               ("speedGround", Int(-50, 2000)),
               ("speedMach", Int(500, 4000)))       # 0.001 Mach

DISTANCE_OFFSET = Int(1, 99)             # nm
DIRECTION = Enum("left", "right", "eitherSide", "north", "south", "east",
                 "west", "northEast", "northWest", "southEast", "southWest")
FREQUENCY = Choice(("frequencyhf", Int(2850, 28000)),       # kHz
                   ("frequencyvhf", Int(23600, 27398)),     # x5 kHz
                   ("frequencyuhf", Int(9000, 15999)),      # x25 kHz
                   ("frequencysatchannel", NumStr(12)))
BEACON_CODE = SeqOf(4, 4, Int(0, 7))
ALTIMETER = Choice(("altimeterEnglish", Int(2200, 3200)),   # 0.01 inHg
                   ("altimeterMetric", Int(7500, 12500)))   # 0.1 hPa
VERTICAL_RATE = Int(0, 3000)             # ft/min (reconstructed)
TOFROM = Enum("to", "from")
ICAO_FACILITY = IA5(4, 4)
ICAO_UNITNAME = Seq(
    ("facility", Choice(("designation", IA5(4, 4)),
                        ("name", IA5(3, 18)))),
    ("function", Enum("center", "approach", "tower", "final",
                      "groundControl", "clearanceDelivery", "departure",
                      "control", "radio")),
)
ATIS_CODE = IA5(1, 1)
FREE_TEXT = IA5(1, 256)
VERSION = Int(0, 15)
ERROR_INFO = Enum(
    "applicationError", "duplicateMsgIdentificationNumber",
    "unrecognizedMsgReferenceNumber", "endServiceWithPendingMsgs",
    "endServiceWithNoValidResponse", "insufficientMsgStorageCapacity",
    "noAvailableMsgIdentificationNumbers", "commandedTermination",
    "insufficientData", "unexpectedData", "invalidData",
)
CLEARANCE_TYPE = Enum("noneSpecified", "approach", "departure", "further",
                      "startUp", "pushback", "taxi", "takeOff")
REMAINING_FUEL_SOULS = Seq(("remainingFuel", TIME),
                           ("remainingSouls", Int(1, 1024)))
TEMPERATURE = Int(-100, 100)             # deg C
WINDS = Seq(("direction", Int(1, 360)),
            ("speed", Choice(("windSpeedEnglish", Int(0, 255)),
                             ("windSpeedMetric", Int(0, 511)))))
TURBULENCE = Enum("light", "moderate", "severe")
ICING = Enum("reserved", "light", "moderate", "severe")
VERTICAL_CHANGE = Seq(("direction", Enum("up", "down")),
                      ("rate", VERTICAL_RATE))
PROCEDURE_NAME = Seq(("type", Enum("arrival", "approach", "departure")),
                     ("procedure", IA5(1, 20)),
                     ("transition", IA5(1, 5), OPT))

ROUTE_CLEARANCE = Opaque("FANSRouteClearance layout not modelled")
PDC = Opaque("FANSPredepartureClearance layout not modelled")
HOLD_CLEARANCE = Opaque("FANSHoldClearance layout not modelled")
FACILITY_TP4 = Opaque("FANSTp4table layout not modelled")

# FANSPositionReport: 3 mandatory components + 19 OPTIONALs, in DO-258A
# order.  The reference reads only the 3 mandatory fields and ignores
# optionals (extract_position, arincpos.c:92-118).
POSITION_REPORT = Seq(
    ("positioncurrent", POSITION),
    ("timeatpositioncurrent", TIME),
    ("altitude", ALTITUDE),
    ("fixnext", POSITION, OPT),
    ("timeetaatfixnext", TIME, OPT),
    ("fixnextplusone", POSITION, OPT),
    ("timeetaatdestination", TIME, OPT),
    ("remainingfuel", TIME, OPT),
    ("temperature", TEMPERATURE, OPT),
    ("winds", WINDS, OPT),
    ("turbulence", TURBULENCE, OPT),
    ("icing", ICING, OPT),
    ("speed", SPEED, OPT),
    ("speedground", Int(-50, 2000), OPT),
    ("verticalchange", VERTICAL_CHANGE, OPT),
    ("trackangle", DEGREES, OPT),
    ("trueheading", DEGREES, OPT),
    ("distance", DISTANCE, OPT),
    ("supplementaryinformation", FREE_TEXT, OPT),
    ("reportedwaypointposition", POSITION, OPT),
    ("reportedwaypointtime", TIME, OPT),
    ("reportedwaypointaltitude", ALTITUDE, OPT),
)
N_REPORT_OPTIONALS = sum(1 for _n, _t, o in POSITION_REPORT.fields if o)

# Composite element argument types (SEQUENCE of the named components).
ALT_ALT = SeqOf(2, 2, ALTITUDE)
SPEED_SPEED = SeqOf(2, 2, SPEED)
ALT_POS = Seq(("altitude", ALTITUDE), ("position", POSITION))
ALT_TIME = Seq(("altitude", ALTITUDE), ("time", TIME))
TIME_ALT = Seq(("time", TIME), ("altitude", ALTITUDE))
POS_ALT = Seq(("position", POSITION), ("altitude", ALTITUDE))
DOD = Seq(("distanceoffset", DISTANCE_OFFSET), ("direction", DIRECTION))
POS_DOD = Seq(("position", POSITION), ("distanceoffset", DISTANCE_OFFSET),
              ("direction", DIRECTION))
TIME_DOD = Seq(("time", TIME), ("distanceoffset", DISTANCE_OFFSET),
               ("direction", DIRECTION))
POS_RC = Seq(("position", POSITION), ("routeclearance", ROUTE_CLEARANCE))
POS_ALT_ALT = Seq(("position", POSITION), ("altitude1", ALTITUDE),
                  ("altitude2", ALTITUDE))
POS_TIME = Seq(("position", POSITION), ("time", TIME))
POS_TIME_TIME = Seq(("position", POSITION), ("time1", TIME),
                    ("time2", TIME))
POS_SPEED = Seq(("position", POSITION), ("speed", SPEED))
POS_TIME_ALT = Seq(("position", POSITION), ("time", TIME),
                   ("altitude", ALTITUDE))
POS_ALT_SPEED = Seq(("position", POSITION), ("altitude", ALTITUDE),
                    ("speed", SPEED))
TIME_POS_ALT = Seq(("time", TIME), ("position", POSITION),
                   ("altitude", ALTITUDE))
TIME_POS_ALT_SPEED = Seq(("time", TIME), ("position", POSITION),
                         ("altitude", ALTITUDE), ("speed", SPEED))
TIME_POS = Seq(("time", TIME), ("position", POSITION))
POS_POS = Seq(("position1", POSITION), ("position2", POSITION))
DIR_DEG = Seq(("direction", DIRECTION), ("degrees", DEGREES))
POS_DEG = Seq(("position", POSITION), ("degrees", DEGREES))
TIME_SPEED = Seq(("time", TIME), ("speed", SPEED))
ALT_SPEED = Seq(("altitude", ALTITUDE), ("speed", SPEED))
TIME_SPEED_SPEED = Seq(("time", TIME), ("speeds", SPEED_SPEED))
POS_SPEED_SPEED = Seq(("position", POSITION), ("speeds", SPEED_SPEED))
ALT_SPEED_SPEED = Seq(("altitude", ALTITUDE), ("speeds", SPEED_SPEED))
UNITNAME_FREQ = Seq(("unitname", ICAO_UNITNAME), ("frequency", FREQUENCY))
POS_UNITNAME_FREQ = Seq(("position", POSITION),
                        ("unitname", ICAO_UNITNAME),
                        ("frequency", FREQUENCY))
TIME_UNITNAME_FREQ = Seq(("time", TIME), ("unitname", ICAO_UNITNAME),
                         ("frequency", FREQUENCY))
POS_PROC = Seq(("position", POSITION), ("procedure", PROCEDURE_NAME))
TOFROM_POS = Seq(("tofrom", TOFROM), ("position", POSITION))
TIME_DIST_TOFROM_POS = Seq(("time", TIME), ("distance", DISTANCE),
                           ("tofrom", TOFROM), ("position", POSITION))

DM48_INDEX = 48
N_DM_CHOICES = 81
N_UM_CHOICES = 183

# -- element tables ----------------------------------------------------------
# (type, GOLD intent text).  Placeholders {0},{1},.. are filled with the
# formatted top-level components of the argument (Seq fields in order,
# otherwise the single value).  Message intents follow the FANS-1/A
# message tables of the GOLD manual / DO-258A.
DM_TABLE = (
    (NULL, "WILCO"),
    (NULL, "UNABLE"),
    (NULL, "STANDBY"),
    (NULL, "ROGER"),
    (NULL, "AFFIRM"),
    (NULL, "NEGATIVE"),
    (ALTITUDE, "REQUEST {0}"),
    (ALT_ALT, "REQUEST BLOCK {0} TO {1}"),
    (ALTITUDE, "REQUEST CRUISE CLIMB TO {0}"),
    (ALTITUDE, "REQUEST CLIMB TO {0}"),
    (ALTITUDE, "REQUEST DESCENT TO {0}"),
    (ALT_POS, "AT {1} REQUEST CLIMB TO {0}"),
    (ALT_POS, "AT {1} REQUEST DESCENT TO {0}"),
    (ALT_TIME, "AT {1} REQUEST CLIMB TO {0}"),
    (ALT_TIME, "AT {1} REQUEST DESCENT TO {0}"),
    (DOD, "REQUEST OFFSET {0} {1} OF ROUTE"),
    (POS_DOD, "AT {0} REQUEST OFFSET {1} {2} OF ROUTE"),
    (TIME_DOD, "AT {0} REQUEST OFFSET {1} {2} OF ROUTE"),
    (SPEED, "REQUEST {0}"),
    (SPEED_SPEED, "REQUEST {0} TO {1}"),
    (NULL, "REQUEST VOICE CONTACT"),
    (FREQUENCY, "REQUEST VOICE CONTACT {0}"),
    (POSITION, "REQUEST DIRECT TO {0}"),
    (PROCEDURE_NAME, "REQUEST {0}"),
    (ROUTE_CLEARANCE, "REQUEST [route clearance]"),
    (CLEARANCE_TYPE, "REQUEST {0} CLEARANCE"),
    (POS_RC, "REQUEST WEATHER DEVIATION TO {0} VIA [route clearance]"),
    (DOD, "REQUEST WEATHER DEVIATION UP TO {0} {1} OF ROUTE"),
    (ALTITUDE, "LEAVING {0}"),
    (ALTITUDE, "CLIMBING TO {0}"),
    (ALTITUDE, "DESCENDING TO {0}"),
    (POSITION, "PASSING {0}"),
    (ALTITUDE, "PRESENT ALTITUDE {0}"),
    (POSITION, "PRESENT POSITION {0}"),
    (SPEED, "PRESENT SPEED {0}"),
    (DEGREES, "PRESENT HEADING {0}"),
    (DEGREES, "PRESENT GROUND TRACK {0}"),
    (ALTITUDE, "LEVEL {0}"),
    (ALTITUDE, "ASSIGNED ALTITUDE {0}"),
    (SPEED, "ASSIGNED SPEED {0}"),
    (ROUTE_CLEARANCE, "ASSIGNED ROUTE [route clearance]"),
    (NULL, "BACK ON ROUTE"),
    (POSITION, "NEXT WAYPOINT {0}"),
    (TIME, "NEXT WAYPOINT ETA {0}"),
    (POSITION, "ENSUING WAYPOINT {0}"),
    (POSITION, "REPORTED WAYPOINT {0}"),
    (TIME, "REPORTED WAYPOINT {0}"),
    (BEACON_CODE, "SQUAWKING {0}"),
    (POSITION_REPORT, "POSITION REPORT"),
    (SPEED, "WHEN CAN WE EXPECT {0}"),
    (SPEED_SPEED, "WHEN CAN WE EXPECT {0} TO {1}"),
    (NULL, "WHEN CAN WE EXPECT BACK ON ROUTE"),
    (NULL, "WHEN CAN WE EXPECT LOWER ALTITUDE"),
    (NULL, "WHEN CAN WE EXPECT HIGHER ALTITUDE"),
    (NULL, "WHEN CAN WE EXPECT CRUISE CLIMB"),
    (NULL, "PAN PAN PAN"),
    (NULL, "MAYDAY MAYDAY MAYDAY"),
    (REMAINING_FUEL_SOULS,
     "{0} OF FUEL REMAINING AND {1} SOULS ON BOARD"),
    (NULL, "CANCEL EMERGENCY"),
    (POS_RC, "DIVERTING TO {0} VIA [route clearance]"),
    (DOD, "OFFSETTING {0} {1} OF ROUTE"),
    (ALTITUDE, "DESCENDING TO {0}"),
    (ERROR_INFO, "ERROR {0}"),
    (NULL, "NOT CURRENT DATA AUTHORITY"),
    (ICAO_FACILITY, "CURRENT DATA AUTHORITY {0}"),
    (NULL, "DUE TO WEATHER"),
    (NULL, "DUE TO AIRCRAFT PERFORMANCE"),
    (FREE_TEXT, "{0}"),
    (FREE_TEXT, "{0}"),
    (NULL, "REQUEST VMC DESCENT"),
    (DEGREES, "REQUEST HEADING {0}"),
    (DEGREES, "REQUEST GROUND TRACK {0}"),
    (ALTITUDE, "REACHING {0}"),
    (VERSION, "VERSION {0}"),
    (NULL, "MAINTAIN OWN SEPARATION AND VMC"),
    (NULL, "AT PILOTS DISCRETION"),
    (ALT_ALT, "REACHING BLOCK {0} TO {1}"),
    (ALT_ALT, "ASSIGNED BLOCK {0} TO {1}"),
    (TIME_DIST_TOFROM_POS, "AT {0} {1} {2} {3}"),
    (ATIS_CODE, "ATIS {0}"),
    (DOD, "DEVIATING {0} {1} OF ROUTE"),
)
assert len(DM_TABLE) == N_DM_CHOICES

UM_TABLE = (
    (NULL, "UNABLE"),
    (NULL, "STANDBY"),
    (NULL, "REQUEST DEFERRED"),
    (NULL, "ROGER"),
    (NULL, "AFFIRM"),
    (NULL, "NEGATIVE"),
    (ALTITUDE, "EXPECT {0}"),
    (TIME, "EXPECT CLIMB AT {0}"),
    (POSITION, "EXPECT CLIMB AT {0}"),
    (TIME, "EXPECT DESCENT AT {0}"),
    (POSITION, "EXPECT DESCENT AT {0}"),
    (TIME, "EXPECT CRUISE CLIMB AT {0}"),
    (POSITION, "EXPECT CRUISE CLIMB AT {0}"),
    (TIME_ALT, "AT {0} EXPECT CLIMB TO {1}"),
    (POS_ALT, "AT {0} EXPECT CLIMB TO {1}"),
    (TIME_ALT, "AT {0} EXPECT DESCENT TO {1}"),
    (POS_ALT, "AT {0} EXPECT DESCENT TO {1}"),
    (TIME_ALT, "AT {0} EXPECT CRUISE CLIMB TO {1}"),
    (POS_ALT, "AT {0} EXPECT CRUISE CLIMB TO {1}"),
    (ALTITUDE, "MAINTAIN {0}"),
    (ALTITUDE, "CLIMB TO AND MAINTAIN {0}"),
    (TIME_ALT, "AT {0} CLIMB TO AND MAINTAIN {1}"),
    (POS_ALT, "AT {0} CLIMB TO AND MAINTAIN {1}"),
    (ALTITUDE, "DESCEND TO AND MAINTAIN {0}"),
    (TIME_ALT, "AT {0} DESCEND TO AND MAINTAIN {1}"),
    (POS_ALT, "AT {0} DESCEND TO AND MAINTAIN {1}"),
    (ALT_TIME, "CLIMB TO REACH {0} BY {1}"),
    (ALT_POS, "CLIMB TO REACH {0} BY {1}"),
    (ALT_TIME, "DESCEND TO REACH {0} BY {1}"),
    (ALT_POS, "DESCEND TO REACH {0} BY {1}"),
    (ALT_ALT, "MAINTAIN BLOCK {0} TO {1}"),
    (ALT_ALT, "CLIMB TO AND MAINTAIN BLOCK {0} TO {1}"),
    (ALT_ALT, "DESCEND TO AND MAINTAIN BLOCK {0} TO {1}"),
    (ALTITUDE, "CRUISE {0}"),
    (ALTITUDE, "CRUISE CLIMB TO {0}"),
    (ALTITUDE, "CRUISE CLIMB ABOVE {0}"),
    (ALTITUDE, "EXPEDITE CLIMB TO {0}"),
    (ALTITUDE, "EXPEDITE DESCENT TO {0}"),
    (ALTITUDE, "IMMEDIATELY CLIMB TO {0}"),
    (ALTITUDE, "IMMEDIATELY DESCEND TO {0}"),
    (ALTITUDE, "IMMEDIATELY STOP CLIMB AT {0}"),
    (ALTITUDE, "IMMEDIATELY STOP DESCENT AT {0}"),
    (POS_ALT, "EXPECT TO CROSS {0} AT {1}"),
    (POS_ALT, "EXPECT TO CROSS {0} AT OR ABOVE {1}"),
    (POS_ALT, "EXPECT TO CROSS {0} AT OR BELOW {1}"),
    (POS_ALT, "EXPECT TO CROSS {0} AT AND MAINTAIN {1}"),
    (POS_ALT, "CROSS {0} AT {1}"),
    (POS_ALT, "CROSS {0} AT OR ABOVE {1}"),
    (POS_ALT, "CROSS {0} AT OR BELOW {1}"),
    (POS_ALT, "CROSS {0} AT AND MAINTAIN {1}"),
    (POS_ALT_ALT, "CROSS {0} BETWEEN {1} AND {2}"),
    (POS_TIME, "CROSS {0} AT {1}"),
    (POS_TIME, "CROSS {0} AT OR BEFORE {1}"),
    (POS_TIME, "CROSS {0} AT OR AFTER {1}"),
    (POS_TIME_TIME, "CROSS {0} BETWEEN {1} AND {2}"),
    (POS_SPEED, "CROSS {0} AT {1}"),
    (POS_SPEED, "CROSS {0} AT OR LESS THAN {1}"),
    (POS_SPEED, "CROSS {0} AT OR GREATER THAN {1}"),
    (POS_TIME_ALT, "CROSS {0} AT {1} AT {2}"),
    (POS_TIME_ALT, "CROSS {0} AT OR BEFORE {1} AT {2}"),
    (POS_TIME_ALT, "CROSS {0} AT OR AFTER {1} AT {2}"),
    (POS_ALT_SPEED, "CROSS {0} AT AND MAINTAIN {1} AT {2}"),
    (TIME_POS_ALT, "AT {0} CROSS {1} AT AND MAINTAIN {2}"),
    (TIME_POS_ALT_SPEED, "AT {0} CROSS {1} AT AND MAINTAIN {2} AT {3}"),
    (DOD, "OFFSET {0} {1} OF ROUTE"),
    (POS_DOD, "AT {0} OFFSET {1} {2} OF ROUTE"),
    (TIME_DOD, "AT {0} OFFSET {1} {2} OF ROUTE"),
    (NULL, "PROCEED BACK ON ROUTE"),
    (POSITION, "REJOIN ROUTE BY {0}"),
    (TIME, "REJOIN ROUTE BY {0}"),
    (POSITION, "EXPECT BACK ON ROUTE BY {0}"),
    (TIME, "EXPECT BACK ON ROUTE BY {0}"),
    (NULL, "RESUME OWN NAVIGATION"),
    (PDC, "[predeparture clearance]"),
    (POSITION, "PROCEED DIRECT TO {0}"),
    (POSITION, "WHEN ABLE PROCEED DIRECT TO {0}"),
    (TIME_POS, "AT {0} PROCEED DIRECT TO {1}"),
    (POS_POS, "AT {0} PROCEED DIRECT TO {1}"),
    (ALT_POS, "AT {0} PROCEED DIRECT TO {1}"),
    (POS_RC, "CLEARED TO {0} VIA [route clearance]"),
    (ROUTE_CLEARANCE, "CLEARED [route clearance]"),
    (PROCEDURE_NAME, "CLEARED {0}"),
    (DOD, "CLEARED TO DEVIATE UP TO {0} {1} OF ROUTE"),
    (POS_RC, "AT {0} CLEARED [route clearance]"),
    (POS_PROC, "AT {0} CLEARED {1}"),
    (ROUTE_CLEARANCE, "EXPECT [route clearance]"),
    (POS_RC, "AT {0} EXPECT [route clearance]"),
    (POSITION, "EXPECT DIRECT TO {0}"),
    (POS_POS, "AT {0} EXPECT DIRECT TO {1}"),
    (TIME_POS, "AT {0} EXPECT DIRECT TO {1}"),
    (ALT_POS, "AT {0} EXPECT DIRECT TO {1}"),
    (HOLD_CLEARANCE, "HOLD AT [hold clearance]"),
    (POS_ALT, "HOLD AT {0} AS PUBLISHED MAINTAIN {1}"),
    (TIME, "EXPECT FURTHER CLEARANCE AT {0}"),
    (DIR_DEG, "TURN {0} HEADING {1}"),
    (DIR_DEG, "TURN {0} GROUND TRACK {1}"),
    (NULL, "CONTINUE PRESENT HEADING"),
    (POS_DEG, "AT {0} FLY HEADING {1}"),
    (DIR_DEG, "IMMEDIATELY TURN {0} HEADING {1}"),
    (PROCEDURE_NAME, "EXPECT {0}"),
    (TIME_SPEED, "AT {0} EXPECT {1}"),
    (POS_SPEED, "AT {0} EXPECT {1}"),
    (ALT_SPEED, "AT {0} EXPECT {1}"),
    (TIME_SPEED_SPEED, "AT {0} EXPECT {1}"),
    (POS_SPEED_SPEED, "AT {0} EXPECT {1}"),
    (ALT_SPEED_SPEED, "AT {0} EXPECT {1}"),
    (SPEED, "MAINTAIN {0}"),
    (NULL, "MAINTAIN PRESENT SPEED"),
    (SPEED, "MAINTAIN {0} OR GREATER"),
    (SPEED, "MAINTAIN {0} OR LESS"),
    (SPEED_SPEED, "MAINTAIN {0} TO {1}"),
    (SPEED, "INCREASE SPEED TO {0}"),
    (SPEED, "INCREASE SPEED TO {0} OR GREATER"),
    (SPEED, "REDUCE SPEED TO {0}"),
    (SPEED, "REDUCE SPEED TO {0} OR LESS"),
    (SPEED, "DO NOT EXCEED {0}"),
    (NULL, "RESUME NORMAL SPEED"),
    (UNITNAME_FREQ, "CONTACT {0} {1}"),
    (POS_UNITNAME_FREQ, "AT {0} CONTACT {1} {2}"),
    (TIME_UNITNAME_FREQ, "AT {0} CONTACT {1} {2}"),
    (UNITNAME_FREQ, "MONITOR {0} {1}"),
    (POS_UNITNAME_FREQ, "AT {0} MONITOR {1} {2}"),
    (TIME_UNITNAME_FREQ, "AT {0} MONITOR {1} {2}"),
    (BEACON_CODE, "SQUAWK {0}"),
    (NULL, "STOP SQUAWK"),
    (NULL, "SQUAWK ALTITUDE"),
    (NULL, "STOP ALTITUDE SQUAWK"),
    (NULL, "REPORT BACK ON ROUTE"),
    (ALTITUDE, "REPORT LEAVING {0}"),
    (ALTITUDE, "REPORT LEVEL {0}"),
    (POSITION, "REPORT PASSING {0}"),
    (NULL, "REPORT REMAINING FUEL AND SOULS ON BOARD"),
    (NULL, "CONFIRM POSITION"),
    (NULL, "CONFIRM ALTITUDE"),
    (NULL, "CONFIRM SPEED"),
    (NULL, "CONFIRM ASSIGNED ALTITUDE"),
    (NULL, "CONFIRM ASSIGNED SPEED"),
    (NULL, "CONFIRM ASSIGNED ROUTE"),
    (NULL, "CONFIRM TIME OVER REPORTED WAYPOINT"),
    (NULL, "CONFIRM REPORTED WAYPOINT"),
    (NULL, "CONFIRM NEXT WAYPOINT"),
    (NULL, "CONFIRM NEXT WAYPOINT ETA"),
    (NULL, "CONFIRM ENSUING WAYPOINT"),
    (NULL, "CONFIRM REQUEST"),
    (NULL, "CONFIRM SQUAWK"),
    (NULL, "CONFIRM HEADING"),
    (NULL, "CONFIRM GROUND TRACK"),
    (NULL, "REQUEST POSITION REPORT"),
    (ALTITUDE, "WHEN CAN YOU ACCEPT {0}"),
    (ALT_POS, "CAN YOU ACCEPT {0} AT {1}"),
    (ALT_TIME, "CAN YOU ACCEPT {0} AT {1}"),
    (SPEED, "WHEN CAN YOU ACCEPT {0}"),
    (DOD, "WHEN CAN YOU ACCEPT {0} {1} OFFSET"),
    (ALTIMETER, "ALTIMETER {0}"),
    (NULL, "RADAR SERVICES TERMINATED"),
    (POSITION, "RADAR CONTACT {0}"),
    (NULL, "RADAR CONTACT LOST"),
    (FREQUENCY, "CHECK STUCK MICROPHONE {0}"),
    (ATIS_CODE, "ATIS {0}"),
    (ERROR_INFO, "ERROR {0}"),
    (ICAO_FACILITY, "NEXT DATA AUTHORITY {0}"),
    (NULL, "END SERVICE"),
    (NULL, "SERVICE UNAVAILABLE"),
    (FACILITY_TP4, "[icao facility designation] [tp4table]"),
    (NULL, "WHEN READY"),
    (NULL, "THEN"),
    (NULL, "DUE TO TRAFFIC"),
    (NULL, "DUE TO AIRSPACE RESTRICTION"),
    (NULL, "DISREGARD"),
    (FREE_TEXT, "{0}"),
    (FREE_TEXT, "{0}"),
    (VERTICAL_RATE, "CLIMB AT {0} MINIMUM"),
    (VERTICAL_RATE, "CLIMB AT {0} MAXIMUM"),
    (VERTICAL_RATE, "DESCEND AT {0} MINIMUM"),
    (VERTICAL_RATE, "DESCEND AT {0} MAXIMUM"),
    (ALTITUDE, "REPORT REACHING {0}"),
    (NULL, "MAINTAIN OWN SEPARATION AND VMC"),
    (NULL, "AT PILOTS DISCRETION"),
    (NULL, "(reserved)"),
    (NULL, "SQUAWK IDENT"),
    (ALT_ALT, "REPORT REACHING BLOCK {0} TO {1}"),
    (TOFROM_POS, "REPORT DISTANCE {0} {1}"),
    (NULL, "CONFIRM ATIS CODE"),
)
assert len(UM_TABLE) == N_UM_CHOICES

# -- value formatting --------------------------------------------------------
def _camel_words(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper() and out:
            out.append(" ")
        out.append(ch)
    return "".join(out).upper()


def fmt_altitude(val) -> str:
    name, v = val
    if name == "altitudeFlightLevel":
        return f"FL{v}"
    if name == "altitudeFlightLevelMetric":
        return f"FL{v * 10} m"
    feet = ALT_FEET[name](v)
    unit = "m" if "Meters" in name else "ft"
    raw = f"{v} {unit}" if unit == "m" else f"{feet} ft"
    return raw


def fmt_time(val) -> str:
    return f"{val['hours']:02d}:{val['minutes']:02d}"


def _fmt_angle(part) -> float:
    v = float(part["degrees"])
    if "minutes" in part:
        v += part["minutes"] / 10.0 / 60.0        # tenths of minutes
    return v


def fmt_latlon(val) -> str:
    lat = _fmt_angle(val["latitude"])
    if val["latitude"]["direction"] == "south":
        lat = -lat
    lon = _fmt_angle(val["longitude"])
    if val["longitude"]["direction"] == "west":
        lon = -lon
    return f"{lat:.4f} {lon:.4f}"


def fmt_position(val) -> str:
    name, inner = val
    if name == "latitudeLongitude":
        return fmt_latlon(inner)
    if name == "placeBearingDistance":
        s = f"{inner['fixname']} brg {fmt_degrees(inner['degrees'])}" \
            f" dist {inner['distance']} nm"
        if "latitudeLongitude" in inner:
            s += f" ({fmt_latlon(inner['latitudeLongitude'])})"
        return s
    return inner                                  # fixName/navaid/airport


def fmt_degrees(val) -> str:
    name, v = val
    return f"{v} deg {'MAG' if name == 'degreesMagnetic' else 'TRUE'}"


def fmt_speed(val) -> str:
    name, v = val
    if name == "speedMach":
        return f"M{v / 1000:.3f}"
    kind = {"speedIndicated": "IAS", "speedTrue": "TAS",
            "speedGround": "GS"}[name]
    return f"{v} kt {kind}"


def fmt_frequency(val) -> str:
    name, v = val
    if name == "frequencyhf":
        return f"{v} kHz"
    if name == "frequencyvhf":
        return f"{v * 5 / 1000:.3f} MHz"
    if name == "frequencyuhf":
        return f"{v * 25 / 1000:.3f} MHz"
    return f"satcom {v.strip()}"


def fmt_altimeter(val) -> str:
    name, v = val
    if name == "altimeterEnglish":
        return f"{v / 100:.2f} inHg"
    return f"{v / 10:.1f} hPa"


def fmt_unitname(val) -> str:
    _fname, ident = val["facility"]
    return f"{ident} {_camel_words(val['function'])}"


def fmt_procedure(val) -> str:
    s = f"{val['type'].upper()} {val['procedure']}"
    if "transition" in val:
        s += f".{val['transition']}"
    return s


def fmt_winds(val) -> str:
    sname, sv = val["speed"]
    unit = "kt" if sname == "windSpeedEnglish" else "km/h"
    return f"{val['direction']} deg at {sv} {unit}"


def fmt_beacon(val) -> str:
    return "".join(str(d) for d in val)


def fmt_fuel_souls(val) -> str:
    return fmt_time(val["remainingFuel"])


_FMT = {
    id(ALTITUDE): fmt_altitude,
    id(TIME): fmt_time,
    id(LATLON): fmt_latlon,
    id(POSITION): fmt_position,
    id(DEGREES): fmt_degrees,
    id(SPEED): fmt_speed,
    id(FREQUENCY): fmt_frequency,
    id(ALTIMETER): fmt_altimeter,
    id(ICAO_UNITNAME): fmt_unitname,
    id(PROCEDURE_NAME): fmt_procedure,
    id(WINDS): fmt_winds,
    id(BEACON_CODE): fmt_beacon,
    id(VERTICAL_RATE): lambda v: f"{v} ft/min",
    id(DISTANCE_OFFSET): lambda v: f"{v} nm",
    id(DISTANCE): lambda v: f"{v} nm",
    id(TEMPERATURE): lambda v: f"{v} C",
}


def fmt_value(typ, val) -> str:
    f = _FMT.get(id(typ))
    if f is not None:
        return f(val)
    if isinstance(typ, Null):
        return ""
    if isinstance(typ, Int):
        return str(val)
    if isinstance(typ, Enum):
        return _camel_words(val)
    if isinstance(typ, (IA5, NumStr)):
        return val
    if isinstance(typ, Seq):
        return ", ".join(
            fmt_value(ftyp, val[name])
            for name, ftyp, _o in typ.fields if name in val
        )
    if isinstance(typ, SeqOf):
        return " TO ".join(fmt_value(typ.typ, item) for item in val)
    if isinstance(typ, Choice):
        name, inner = val
        return fmt_value(typ.alts[typ.index[name]][1], inner)
    return str(val)


def _element_args(typ, val) -> list[str]:
    """Top-level formatted components for {0},{1},.. template slots."""
    if isinstance(typ, Null):
        return []
    if isinstance(typ, Seq) and id(typ) not in _FMT \
            and typ is not POSITION_REPORT:
        out = []
        for name, ftyp, _o in typ.fields:
            if name in val:
                out.append(fmt_value(ftyp, val[name]))
            elif isinstance(ftyp, Opaque):
                out.append(f"[{ftyp.reason}]")
        return out
    if isinstance(typ, SeqOf) and id(typ) not in _FMT:
        return [fmt_value(typ.typ, item) for item in val]
    if typ is REMAINING_FUEL_SOULS:
        return [fmt_time(val["remainingFuel"]),
                str(val["remainingSouls"])]
    return [fmt_value(typ, val)]


def element_text(table, index: int, val) -> str:
    typ, template = table[index]
    args = _element_args(typ, val)
    try:
        return template.format(*args)
    except IndexError:
        return template


# -- public dataclasses ------------------------------------------------------
@dataclass
class Altitude:
    encoding: str            # one of ALTITUDE_CHOICES names
    value: int               # raw encoded value
    feet: int                # per parse_altitude (arincpos.c:47-90)


@dataclass
class LatLon:
    lat_deg: int
    lat_min10: int | None    # tenths of minutes, optional
    lat_south: bool
    lon_deg: int
    lon_min10: int | None
    lon_west: bool

    @property
    def lat(self) -> float:
        v = float(self.lat_deg)
        if self.lat_min10 is not None:
            v += self.lat_min10 / 10.0 / 60.0     # arincpos.c:38-45
        return -v if self.lat_south else v

    @property
    def lon(self) -> float:
        v = float(self.lon_deg)
        if self.lon_min10 is not None:
            v += self.lon_min10 / 10.0 / 60.0
        return -v if self.lon_west else v


@dataclass
class PositionReport:
    """DM48 with the fields the reference extracts (arincpos.c:92-118)
    plus the decoded optional components as display lines."""
    position: LatLon | None  # None when positioncurrent is not lat/lon
    hours: int
    minutes: int
    altitude: Altitude
    raw: dict | None = None           # full generic decode
    extras: list[str] = field(default_factory=list)


@dataclass
class Element:
    """A decoded non-DM48 element."""
    index: int               # DM/UM number
    text: str                # GOLD intent text with arguments substituted
    value: object = None     # generic decoded value
    complete: bool = True    # False when an opaque tail stopped the walk


@dataclass
class UnsupportedElement:
    index: int               # DM/UM number
    reason: str = "unmodelled element body"


@dataclass
class DownlinkMessage:
    msg_id: int
    msg_ref: int | None
    timestamp: tuple[int, int, int] | None
    elements: list = field(default_factory=list)


@dataclass
class UplinkMessage:
    msg_id: int
    msg_ref: int | None
    timestamp: tuple[int, int, int] | None
    elements: list = field(default_factory=list)


def _latlon_from_raw(val: dict) -> LatLon:
    la, lo = val["latitude"], val["longitude"]
    return LatLon(la["degrees"], la.get("minutes"),
                  la["direction"] == "south",
                  lo["degrees"], lo.get("minutes"),
                  lo["direction"] == "west")


_REPORT_EXTRA_LABELS = {
    "fixnext": "next fix",
    "timeetaatfixnext": "eta at next fix",
    "fixnextplusone": "next fix + 1",
    "timeetaatdestination": "eta at destination",
    "remainingfuel": "remaining fuel",
    "temperature": "temperature",
    "winds": "winds",
    "turbulence": "turbulence",
    "icing": "icing",
    "speed": "speed",
    "speedground": "ground speed",
    "verticalchange": "vertical change",
    "trackangle": "track angle",
    "trueheading": "true heading",
    "distance": "distance",
    "supplementaryinformation": "supplementary info",
    "reportedwaypointposition": "reported waypoint position",
    "reportedwaypointtime": "reported waypoint time",
    "reportedwaypointaltitude": "reported waypoint altitude",
}


def _position_report_from_raw(raw: dict) -> PositionReport:
    pname, pval = raw["positioncurrent"]
    pos = _latlon_from_raw(pval) if pname == "latitudeLongitude" else None
    t = raw["timeatpositioncurrent"]
    aname, aval = raw["altitude"]
    alt = Altitude(aname, aval, ALT_FEET[aname](aval))
    extras = []
    if pos is None:
        extras.append(f"position: {fmt_position(raw['positioncurrent'])}")
    ftypes = {name: ftyp for name, ftyp, _o in POSITION_REPORT.fields}
    for name, _ftyp, opt in POSITION_REPORT.fields:
        if opt and name in raw:
            label = _REPORT_EXTRA_LABELS[name]
            if name == "verticalchange":
                vc = raw[name]
                extras.append(f"{label}: {vc['direction']}"
                              f" {vc['rate']} ft/min")
            else:
                extras.append(f"{label}: {fmt_value(ftypes[name], raw[name])}")
    return PositionReport(pos, t["hours"], t["minutes"], alt,
                          raw=raw, extras=extras)


# -- message codec ---------------------------------------------------------
def _decode_message(data: bytes, table, n_choices: int, msg_cls):
    """FANSATC{Downlink,Uplink}Message: SEQUENCE { header, elementid,
    elementid-seqOf OPTIONAL } with header = SEQUENCE { msgid (0..63),
    msgref (0..63) OPTIONAL, timestamp OPTIONAL }.  Preamble bits come
    first per sequence, so the wire order is: seqOf-present, ref-present,
    ts-present, msgid, [ref], [ts], element, [count, elements...]."""
    r = BitReader(data)
    has_seq = r.read(1)
    has_ref = r.read(1)
    has_ts = r.read(1)
    msg_id = read_int(r, 0, 63)
    msg_ref = read_int(r, 0, 63) if has_ref else None
    ts = None
    if has_ts:
        ts = (read_int(r, 0, 23), read_int(r, 0, 59), read_int(r, 0, 59))
    msg = msg_cls(msg_id, msg_ref, ts)

    def element():
        idx = read_int(r, 0, n_choices - 1)
        typ, _template = table[idx]
        try:
            raw = decode(r, typ)
        except OpaqueHit as e:
            if e.partial:
                text = element_text(table, idx, e.partial)
                return Element(idx, text, e.partial, complete=False), False
            return UnsupportedElement(idx, e.reason), False
        if typ is POSITION_REPORT:
            return _position_report_from_raw(raw), True
        return Element(idx, element_text(table, idx, raw), raw), True

    el, ok = element()
    msg.elements.append(el)
    if has_seq and ok:
        # FANSATCDownlinkMsgElementIdSequence ::= SEQUENCE SIZE(1..4) OF
        n = read_int(r, 1, 4)
        for _ in range(n):
            el, ok = element()
            msg.elements.append(el)
            if not ok:
                break
    return msg


def decode_downlink(data: bytes) -> DownlinkMessage:
    return _decode_message(data, DM_TABLE, N_DM_CHOICES, DownlinkMessage)


def decode_uplink(data: bytes) -> UplinkMessage:
    return _decode_message(data, UM_TABLE, N_UM_CHOICES, UplinkMessage)


def encode_message(elements, msg_id: int, msg_ref: int | None = None,
                   timestamp: tuple[int, int, int] | None = None,
                   uplink: bool = False) -> bytes:
    """Wire-encode a message.  elements: list of (index, generic value)."""
    assert 1 <= len(elements) <= 5
    table = UM_TABLE if uplink else DM_TABLE
    n_choices = N_UM_CHOICES if uplink else N_DM_CHOICES
    w = BitWriter()
    w.write(1 if len(elements) > 1 else 0, 1)
    w.write(1 if msg_ref is not None else 0, 1)
    w.write(1 if timestamp is not None else 0, 1)
    write_int(w, msg_id, 0, 63)
    if msg_ref is not None:
        write_int(w, msg_ref, 0, 63)
    if timestamp is not None:
        write_int(w, timestamp[0], 0, 23)
        write_int(w, timestamp[1], 0, 59)
        write_int(w, timestamp[2], 0, 59)

    def emit(item):
        idx, val = item
        write_int(w, idx, 0, n_choices - 1)
        encode(w, table[idx][0], val)

    emit(elements[0])
    if len(elements) > 1:
        write_int(w, len(elements) - 1, 1, 4)
        for item in elements[1:]:
            emit(item)
    return w.bytes()


def latlon_raw(p: LatLon) -> dict:
    """LatLon dataclass -> generic LATLON value."""
    lat = {"degrees": p.lat_deg,
           "direction": "south" if p.lat_south else "north"}
    if p.lat_min10 is not None:
        lat["minutes"] = p.lat_min10
    lon = {"degrees": p.lon_deg,
           "direction": "west" if p.lon_west else "east"}
    if p.lon_min10 is not None:
        lon["minutes"] = p.lon_min10
    return {"latitude": lat, "longitude": lon}


def encode_downlink(msg_id: int, reports: list[dict],
                    msg_ref: int | None = None,
                    timestamp: tuple[int, int, int] | None = None) -> bytes:
    """Wire-encode a downlink message of DM48 position reports
    (for test vectors).  Each report dict: latlon (LatLon), hours,
    minutes, alt_encoding, alt_value, and optionally extra generic
    POSITION_REPORT optional-component values under 'optionals'."""
    els = []
    for rep in reports:
        raw = {
            "positioncurrent": ("latitudeLongitude",
                                latlon_raw(rep["latlon"])),
            "timeatpositioncurrent": {"hours": rep["hours"],
                                      "minutes": rep["minutes"]},
            "altitude": (rep["alt_encoding"], rep["alt_value"]),
        }
        raw.update(rep.get("optionals", {}))
        els.append((DM48_INDEX, raw))
    return encode_message(els, msg_id, msg_ref, timestamp)


def find_dm48(msg) -> PositionReport | None:
    """First DM48 position report with a lat/lon position, scanning the
    top element then the sequence (arincpos.c:183-211)."""
    for el in msg.elements:
        if isinstance(el, PositionReport) and el.position is not None:
            return el
    return None
