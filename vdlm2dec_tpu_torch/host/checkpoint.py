"""Checkpoint / resume for long offline decode jobs.

The reference keeps all state ephemeral (SURVEY.md section 5); for
pod-scale offline jobs we snapshot the stream cursor + the flight table so
a restarted job resumes cheaply.  JSON on disk, atomic replace.
"""
from __future__ import annotations

import json
import os
import tempfile

from .acars import Oooi
from .flights import Flight, FlightTracker


def _flight_to_dict(f: Flight) -> dict:
    return {
        "addr": f.addr, "reg": f.reg, "fid": f.fid, "gnd": f.gnd,
        "ts": f.ts, "tl": f.tl, "nbm": f.nbm, "rt": f.rt, "gt": f.gt,
        "oooi": vars(f.oooi),
    }


def _flight_from_dict(d: dict) -> Flight:
    f = Flight(addr=d["addr"], reg=d["reg"], fid=d["fid"], gnd=d["gnd"],
               ts=d["ts"], tl=d["tl"], nbm=d["nbm"], rt=d["rt"], gt=d["gt"])
    f.oooi = Oooi(**d["oooi"])
    return f


def save_checkpoint(path: str, sample_cursor: int, tracker: FlightTracker,
                    extra: dict | None = None) -> None:
    state = {
        "version": 1,
        "sample_cursor": sample_cursor,
        "flights": [_flight_to_dict(f) for f in tracker.flights()],
        "extra": extra or {},
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, tracker: FlightTracker) -> tuple[int, dict]:
    """Restores the flight table; returns (sample_cursor, extra)."""
    with open(path) as fh:
        state = json.load(fh)
    tracker._flights = [_flight_from_dict(d) for d in state["flights"]]
    return state["sample_cursor"], state.get("extra", {})
