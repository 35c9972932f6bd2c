"""ICAO-keyed aircraft state tracking (mirrors src/adsb/aircraft.rs;
airjax/track/aircraft.py, carried over unchanged).

Position messages update altitude, stash the even/odd CPR frame, and — if an
opposite-parity frame arrived within the last 10 seconds
(src/adsb/aircraft.rs:68,84) — run the CPR global decode. ID messages set the
callsign. This is host-side state (a hash map of mutable aircraft), exactly
the part of the reference that does not belong on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from airjax_torch.protocol.packet import (
    AdsbPacket,
    AircraftId,
    AircraftPositionMsg,
    AircraftStatusMsg,
    AircraftVelocityMsg,
    CprFormat,
    OperationalStatusMsg,
    SurfacePositionMsg,
    TargetStateMsg,
)
from airjax_torch.track.cpr import (
    GeographicPosition,
    calculate_geographic_position,
    calculate_surface_position,
)

CPR_PAIR_MAX_AGE_S = 10.0  # src/adsb/aircraft.rs:68


@dataclasses.dataclass
class AircraftSummary:
    """Display view of one aircraft (src/adsb/aircraft.rs:17-23).

    `to_json()` emits the camelCase schema of bindings/AircraftSummary.ts so
    the reference web frontend could connect unmodified.
    """

    icao: int
    callsign: str
    altitude: int
    geo_position: Optional[GeographicPosition]
    last_contact: int  # epoch seconds
    # Extension fields (extended mode only; None in parity mode).
    ground_speed_kt: Optional[float] = None
    track_deg: Optional[float] = None
    vertical_rate_fpm: Optional[int] = None
    squawk: Optional[int] = None
    on_ground: bool = False
    acas_ra: Optional[str] = None  # active RA clauses, comma-joined
    # Comm-B BDS registers the last DF20/21 MB field validated as. More
    # than one entry = the classic Comm-B inference ambiguity (the MB
    # field carries no register id); consumers must treat the decoded
    # velocity/heading extensions as uncertain then.
    bds_candidates: Optional[list] = None
    # BDS 4,4 meteorological report (sole-candidate inferences only).
    met: Optional[dict] = None
    # Comm-D ELM content (DF24 reassembly + register inference;
    # airjax_torch.extended.interpret_elm): {hex, segments, bds[, decoded]}.
    commd_elm: Optional[dict] = None

    def to_json(self, extended: bool = False) -> dict:
        out = {
            "icao": self.icao,
            "callsign": self.callsign,
            "altitude": self.altitude,
            "geoPosition": (
                self.geo_position.to_json() if self.geo_position else None
            ),
            "lastContact": self.last_contact,
        }
        if extended:
            # Extra keys beyond bindings/AircraftSummary.ts — only emitted
            # in extended mode so the default WS schema stays reference-
            # exact (unknown keys are ignored by the reference frontend
            # anyway, but parity mode shouldn't rely on that).
            out["groundSpeedKt"] = self.ground_speed_kt
            out["trackDeg"] = self.track_deg
            out["verticalRateFpm"] = self.vertical_rate_fpm
            out["squawk"] = self.squawk
            out["onGround"] = self.on_ground
            out["acasRa"] = self.acas_ra
            out["bdsCandidates"] = self.bds_candidates
            out["met"] = self.met
            out["commdElm"] = self.commd_elm
        return out


class Aircraft:
    """Per-ICAO mutable state (src/adsb/aircraft.rs:27-150)."""

    def __init__(self, icao: int):
        now = time.time()
        self.icao = icao
        self.callsign: Optional[str] = None
        self.squawk: Optional[int] = None  # extension (DF5/21 identity)
        # Extension (TC19 velocity; the reference never decodes velocity
        # and its TUI column is hardwired "n/a", src/adsb/tui.rs:77).
        self.ground_speed_kt: Optional[float] = None
        self.track_deg: Optional[float] = None
        self.vertical_rate_fpm: Optional[int] = None
        self.emergency_state: Optional[int] = None  # extension (TC28)
        self.adsb_version: Optional[int] = None  # extension (TC31)
        self.selected_altitude_ft: Optional[int] = None  # extension (TC29)
        self.selected_heading_deg: Optional[float] = None  # extension (TC29)
        self.acas_ra: Optional[dict] = None  # extension (DF16 RA report)
        self.bds_candidates: Optional[list] = None  # extension (Comm-B)
        # Extension (BDS 1,7): GICB registers the transponder announced
        # it services; prunes ambiguous Comm-B inferences (commb.py).
        self.gicb_supported: Optional[list] = None
        # Extension (DF24 Comm-D): ELM segment stash {str(nd): md_hex}.
        self.commd_segments: Optional[dict] = None
        # Interpreted Comm-D ELM content (extension; updated on every
        # gapless segment-prefix by airjax_torch.extended.interpret_elm).
        self.commd_elm: Optional[dict] = None
        # Extension (BDS 4,4, sole-candidate only): wind / temperature /
        # pressure / humidity dict as decoded by commb.decode_bds44.
        self.met: Optional[dict] = None
        self.altitude = 0
        self.geo_position: Optional[GeographicPosition] = None
        self.last_contact = now
        self.last_odd_packet: Optional[AircraftPositionMsg] = None
        self.last_odd_processed = now
        self.last_even_packet: Optional[AircraftPositionMsg] = None
        self.last_even_processed = now
        # Extension: surface-position (TC5-8) frame stash, paired
        # separately from airborne frames (mixing parities across the
        # two encodings would decode garbage).
        self.last_odd_surface: Optional[SurfacePositionMsg] = None
        self.last_odd_surface_t = now
        self.last_even_surface: Optional[SurfacePositionMsg] = None
        self.last_even_surface_t = now
        self.on_ground = False  # extension (latest position kind seen)

    def handle_packet(
        self,
        msg: AdsbPacket,
        ref_position: Optional[tuple[float, float]] = None,
    ) -> None:
        if msg.icao != self.icao:
            return

        if isinstance(msg.msg, SurfacePositionMsg):
            # Extension: only reachable in extended mode.
            surf = msg.msg
            self.last_contact = msg.time_processed
            self.on_ground = True
            self.altitude = 0
            if surf.movement_kt is not None:
                self.ground_speed_kt = surf.movement_kt
            if surf.track_deg is not None:
                self.track_deg = surf.track_deg
            if surf.cpr_format is CprFormat.EVEN:
                self.last_even_surface = surf
                self.last_even_surface_t = msg.time_processed
                other, other_t, first = (
                    self.last_odd_surface, self.last_odd_surface_t, CprFormat.ODD
                )
            else:
                self.last_odd_surface = surf
                self.last_odd_surface_t = msg.time_processed
                other, other_t, first = (
                    self.last_even_surface, self.last_even_surface_t, CprFormat.EVEN
                )
            if (
                ref_position is not None
                and other is not None
                and abs(msg.time_processed - other_t) <= CPR_PAIR_MAX_AGE_S
            ):
                even, odd = (surf, other) if surf.cpr_format is CprFormat.EVEN else (other, surf)
                geo = calculate_surface_position(
                    (even.cpr_latitude, even.cpr_longitude),
                    (odd.cpr_latitude, odd.cpr_longitude),
                    first,
                    ref_position[0],
                    ref_position[1],
                )
                if geo is not None:
                    self.geo_position = geo
            return

        if isinstance(msg.msg, AircraftPositionMsg):
            pos = msg.msg
            if pos.no_position:
                # TC0 (extension): altitude-only; the CPR fields are
                # meaningless and must never enter pairing.
                if pos.altitude_valid:
                    self.altitude = pos.altitude
                self.last_contact = msg.time_processed
                return
            self.altitude = pos.altitude
            self.last_contact = msg.time_processed
            self.on_ground = False

            if pos.cpr_format is CprFormat.EVEN:
                self.last_even_packet = pos
                self.last_even_processed = msg.time_processed
                if self.last_odd_packet is None:
                    return
                if abs(msg.time_processed - self.last_odd_processed) > CPR_PAIR_MAX_AGE_S:
                    return
                cpr_even = (pos.cpr_latitude, pos.cpr_longitude)
                cpr_odd = (
                    self.last_odd_packet.cpr_latitude,
                    self.last_odd_packet.cpr_longitude,
                )
                first = CprFormat.ODD
            else:
                self.last_odd_packet = pos
                self.last_odd_processed = msg.time_processed
                if self.last_even_packet is None:
                    return
                if abs(msg.time_processed - self.last_even_processed) > CPR_PAIR_MAX_AGE_S:
                    return
                cpr_odd = (pos.cpr_latitude, pos.cpr_longitude)
                cpr_even = (
                    self.last_even_packet.cpr_latitude,
                    self.last_even_packet.cpr_longitude,
                )
                first = CprFormat.EVEN

            geo = calculate_geographic_position(cpr_even, cpr_odd, first)
            if geo is not None:
                self.geo_position = geo
        elif isinstance(msg.msg, AircraftId):
            self.callsign = msg.msg.callsign
        elif isinstance(msg.msg, AircraftVelocityMsg):
            # Extension: only reachable in extended mode (parity-mode
            # packets never carry this type).
            vel = msg.msg
            self.last_contact = msg.time_processed
            if vel.ground_speed_kt is not None:
                self.ground_speed_kt = vel.ground_speed_kt
                self.track_deg = vel.track_deg
            if vel.vertical_rate_fpm is not None:
                self.vertical_rate_fpm = vel.vertical_rate_fpm
        elif isinstance(msg.msg, AircraftStatusMsg):
            self.last_contact = msg.time_processed
            if msg.msg.subtype == 1:
                self.emergency_state = msg.msg.emergency_state
                self.squawk = msg.msg.squawk
        elif isinstance(msg.msg, OperationalStatusMsg):
            self.last_contact = msg.time_processed
            self.adsb_version = msg.msg.adsb_version
        elif isinstance(msg.msg, TargetStateMsg):
            self.last_contact = msg.time_processed
            if msg.msg.selected_altitude_ft is not None:
                self.selected_altitude_ft = msg.msg.selected_altitude_ft
            if msg.msg.selected_heading_deg is not None:
                self.selected_heading_deg = msg.msg.selected_heading_deg
        # Unknown messages: ignored (src/adsb/aircraft.rs:107-109)

    def get_callsign(self) -> str:
        return self.callsign or ""

    def get_age(self) -> int:
        return int(time.time() - self.last_contact)

    def get_summary(self) -> AircraftSummary:
        return AircraftSummary(
            icao=self.icao,
            callsign=self.get_callsign(),
            altitude=self.altitude,
            geo_position=self.geo_position,
            last_contact=int(self.last_contact),
            ground_speed_kt=self.ground_speed_kt,
            track_deg=self.track_deg,
            vertical_rate_fpm=self.vertical_rate_fpm,
            squawk=self.squawk,
            on_ground=self.on_ground,
            acas_ra=(
                ", ".join(self.acas_ra["advisories"])
                if self.acas_ra
                and not self.acas_ra["terminated"]
                and self.acas_ra["advisories"]
                else None
            ),
            bds_candidates=self.bds_candidates,
            met=self.met,
            commd_elm=self.commd_elm,
        )


def handle_aircraft_update(
    packet: AdsbPacket,
    aircrafts: dict[int, Aircraft],
    ref_position: Optional[tuple[float, float]] = None,
) -> Aircraft:
    """Upsert-and-update (src/adsb/aircraft.rs:158-165). `ref_position`
    (receiver lat, lon) enables surface-position global decode (extension)."""
    aircraft = aircrafts.setdefault(packet.icao, Aircraft(packet.icao))
    aircraft.handle_packet(packet, ref_position=ref_position)
    return aircraft


def evict_stale(
    aircrafts: dict[int, Aircraft],
    max_age_s: float,
    now: Optional[float] = None,
) -> int:
    """Drop aircraft not heard from in `max_age_s` seconds (extension).

    The reference's HashMap grows without bound (src/adsb/aircraft.rs:158-165
    only ever inserts); a long-running receiver near a busy airway
    accumulates every ICAO it has ever heard. This is opt-in (CLI
    `--evict-after`) and OFF by default so default-mode tracker state stays
    reference-identical. Returns the number of aircraft evicted.
    """
    if now is None:
        now = time.time()
    stale = [
        icao
        for icao, a in aircrafts.items()
        if now - a.last_contact > max_age_s
    ]
    for icao in stale:
        del aircrafts[icao]
    return len(stale)
