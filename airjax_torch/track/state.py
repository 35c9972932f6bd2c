"""Tracker state checkpoint/resume — extension (airjax/track/state.py,
carried over unchanged: a file either package saves, the other loads).

The reference's only persistence is raw IQ capture (`receive` writes
`.c16`, src/receive.rs:47; `--playback` resumes from it); its aircraft
table dies with the process. airjax can snapshot the whole tracker to a
JSON file and restore it on the next run (`adsb --state FILE`), so a
restarted receiver keeps callsigns/positions and even resumes CPR
pairing mid-pair (the stashed odd/even frames are part of the
snapshot) instead of waiting for a fresh even/odd pair from every
aircraft.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

from airjax_torch.protocol.packet import (
    AircraftPositionMsg,
    CprFormat,
    SurfacePositionMsg,
)
from airjax_torch.track.aircraft import Aircraft
from airjax_torch.track.cpr import GeographicPosition

STATE_VERSION = 1

# Plain (JSON-native) per-aircraft attributes, snapshotted verbatim.
_PLAIN_ATTRS = (
    "callsign",
    "squawk",
    "ground_speed_kt",
    "track_deg",
    "vertical_rate_fpm",
    "emergency_state",
    "adsb_version",
    "selected_altitude_ft",
    "selected_heading_deg",
    "acas_ra",
    "bds_candidates",
    "gicb_supported",
    "commd_segments",
    "commd_elm",
    "met",
    "altitude",
    "last_contact",
    "on_ground",
    "last_odd_processed",
    "last_even_processed",
    "last_odd_surface_t",
    "last_even_surface_t",
)


def _msg_to_json(msg) -> Optional[dict]:
    if msg is None:
        return None
    if isinstance(msg, tuple):
        # Batched-path stash (airjax_torch.track.batch.CprStash or a plain
        # (lat, lon) tuple): only the CPR pair exists.
        return {"cpr": [msg[0], msg[1]]}
    d = dataclasses.asdict(msg)
    d["cpr_format"] = msg.cpr_format.name
    return d


def _msg_from_json(d: Optional[dict], cls):
    if d is None:
        return None
    if "cpr" in d:
        from airjax_torch.track.batch import CprStash

        return CprStash(d["cpr"][0], d["cpr"][1])
    d = dict(d)
    d["cpr_format"] = CprFormat[d["cpr_format"]]
    return cls(**d)


def aircraft_to_json(a: Aircraft) -> dict:
    out = {name: getattr(a, name) for name in _PLAIN_ATTRS}
    out["icao"] = a.icao
    out["geo_position"] = (
        dataclasses.asdict(a.geo_position) if a.geo_position else None
    )
    out["last_odd_packet"] = _msg_to_json(a.last_odd_packet)
    out["last_even_packet"] = _msg_to_json(a.last_even_packet)
    out["last_odd_surface"] = _msg_to_json(a.last_odd_surface)
    out["last_even_surface"] = _msg_to_json(a.last_even_surface)
    return out


def aircraft_from_json(d: dict) -> Aircraft:
    a = Aircraft(d["icao"])
    for name in _PLAIN_ATTRS:
        if name in d:
            setattr(a, name, d[name])
    if d.get("geo_position"):
        a.geo_position = GeographicPosition(**d["geo_position"])
    a.last_odd_packet = _msg_from_json(d.get("last_odd_packet"), AircraftPositionMsg)
    a.last_even_packet = _msg_from_json(d.get("last_even_packet"), AircraftPositionMsg)
    a.last_odd_surface = _msg_from_json(d.get("last_odd_surface"), SurfacePositionMsg)
    a.last_even_surface = _msg_from_json(d.get("last_even_surface"), SurfacePositionMsg)
    return a


def save_state(aircrafts: dict[int, Aircraft], path: str | os.PathLike) -> None:
    """Atomically snapshot the aircraft table to `path` (JSON)."""
    doc = {
        "version": STATE_VERSION,
        "aircraft": [aircraft_to_json(a) for a in aircrafts.values()],
    }
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=".airjax_state."
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_state(path: str | os.PathLike) -> dict[int, Aircraft]:
    """Restore an aircraft table saved by save_state."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != STATE_VERSION:
        raise ValueError(f"unsupported state version {doc.get('version')!r}")
    out: dict[int, Aircraft] = {}
    for d in doc["aircraft"]:
        a = aircraft_from_json(d)
        out[a.icao] = a
    return out
