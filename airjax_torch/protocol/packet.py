"""Host-side ADS-B packet model (mirrors src/adsb/packet.rs, msgs.rs).

The decode pipeline hands validated 14-byte frames to the host; this module
turns them into typed packet objects for tracking and display, with a
`format()` that replicates the reference's `Display` output
(src/adsb/packet.rs:77-99, src/adsb/msgs.rs:127-139,215-222) character for
character (timestamps aside).

Carried over unchanged from airjax/protocol/packet.py, whose module imports
jax through airjax.protocol.fields; tests/test_torch_packet.py holds the two
byte for byte.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import time
from typing import Optional, Union

from airjax_torch.protocol.fields import CHAR_CONVERT as _CHAR_CONVERT


class CprFormat(enum.Enum):
    EVEN = 0
    ODD = 1


def _to_6bit_chunks(data: bytes) -> list[int]:
    """MSB-first 6-bit chunking (src/adsb/msgs.rs:150-170)."""
    out = []
    acc = 0
    bits = 0
    for byte in data:
        acc = (acc << 8) | byte
        bits += 8
        while bits >= 6:
            bits -= 6
            out.append((acc >> bits) & 0x3F)
    if bits > 0:
        out.append((acc << (6 - bits)) & 0x3F)
    return out


@dataclasses.dataclass
class UnknownMsg:
    raw_msg: bytes

    def format(self) -> str:
        raw = ", ".join(str(b) for b in self.raw_msg)
        return f"Message:\nType    : Unknown\nRaw Msg :  [{raw}]\n"


@dataclasses.dataclass
class AircraftId:
    msg_type: int
    callsign: str

    @classmethod
    def from_me(cls, me: bytes) -> "AircraftId":
        # src/adsb/msgs.rs:180-201
        chunks = _to_6bit_chunks(me[1:7])
        callsign = "".join(_CHAR_CONVERT[c] for c in chunks)
        return cls(msg_type=(me[0] & 0xF8) >> 3, callsign=callsign)

    def format(self) -> str:
        return (
            "Message:\n"
            f"Type                : {self.msg_type} (ID)\n"
            f"Callsign            : {self.callsign}\n"
        )


@dataclasses.dataclass
class AircraftPositionMsg:
    msg_type: int
    surveillance_status: int
    nic_supplement: int
    altitude: int  # feet
    cpr_time: int
    cpr_format: CprFormat
    cpr_latitude: int
    cpr_longitude: int
    # Extension: True for TC20-22, whose 12-bit altitude field carries
    # GNSS height (HAE, metres) instead of the baro AC12 code. The
    # reference classes TC20-22 Unknown (src/adsb/packet.rs:34-38).
    altitude_gnss: bool = False
    # Extension: True for TC0 (airborne position, no position fix) —
    # altitude-only broadcast; the CPR fields are meaningless and must
    # never enter pairing. altitude_valid=False when the AC12 code is 0
    # ("no altitude available").
    no_position: bool = False
    altitude_valid: bool = True

    @classmethod
    def from_me_gnss(cls, me: bytes) -> "AircraftPositionMsg":
        """TC20-22 airborne position: altitude = GNSS HAE metres -> ft."""
        alt_m = (me[1] << 4) | ((me[2] & 0xF0) >> 4)
        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            surveillance_status=(me[0] & 0b110) >> 1,
            nic_supplement=me[0] & 1,
            altitude=round(alt_m * 3.28084),
            cpr_time=(me[2] & 0b1000) >> 3,
            cpr_format=CprFormat.ODD if (me[2] & 0b100) >> 2 else CprFormat.EVEN,
            cpr_latitude=((me[2] & 0b11) << 15)
            | (me[3] << 7)
            | ((me[4] & 0xFE) >> 1),
            cpr_longitude=((me[4] & 1) << 16) | (me[5] << 8) | me[6],
            altitude_gnss=True,
        )

    @classmethod
    def from_me(cls, me: bytes) -> "AircraftPositionMsg":
        # src/adsb/msgs.rs:70-101
        alt_mode_25 = (me[1] & 1) == 1
        altitude = (((me[1] & 0xFE) >> 1) << 4) | ((me[2] & 0xF0) >> 4)
        altitude *= 25 if alt_mode_25 else 100
        altitude -= 1000
        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            surveillance_status=(me[0] & 0b110) >> 1,
            nic_supplement=me[0] & 1,
            altitude=altitude,
            cpr_time=(me[2] & 0b1000) >> 3,
            cpr_format=CprFormat.ODD if (me[2] & 0b100) >> 2 else CprFormat.EVEN,
            cpr_latitude=((me[2] & 0b11) << 15)
            | (me[3] << 7)
            | ((me[4] & 0xFE) >> 1),
            cpr_longitude=((me[4] & 1) << 16) | (me[5] << 8) | me[6],
        )

    @classmethod
    def from_me_no_fix(cls, me: bytes) -> "AircraftPositionMsg":
        """TC0 airborne position without a position fix (extension; the
        reference classes TC0 Unknown). Same AC12 altitude slot as
        TC9-18; an all-zero code means no altitude either."""
        # Full 12-bit AC12 field INCLUDING the Q bit: Q=1 with zero value
        # is a legal -1000 ft encoding, only all-12-zeros means "no
        # altitude available".
        code12 = (me[1] << 4) | (me[2] >> 4)
        pos = cls.from_me(me)
        return dataclasses.replace(
            pos, no_position=True, altitude_valid=code12 != 0
        )

    def format(self) -> str:
        fmt = "Odd" if self.cpr_format is CprFormat.ODD else "Even"
        if self.no_position:
            alt = str(self.altitude) if self.altitude_valid else "n/a"
            return (
                "Message:\n"
                f"Type                : {self.msg_type} (Position, no fix)\n"
                f"Altitude (ft)       : {alt}\n"
            )
        if self.altitude_gnss:
            # Extension display form (never reachable in parity mode).
            return (
                "Message:\n"
                f"Type                : {self.msg_type} (Position, GNSS)\n"
                f"Altitude (ft, GNSS) : {self.altitude}\n"
                f"CPR Format          : {fmt}\n"
                f"Raw Latitude        : {self.cpr_latitude}\n"
                f"Raw Longitude       : {self.cpr_longitude}\n"
            )
        return (
            "Message:\n"
            f"Type                : {self.msg_type} (Position)\n"
            f"Surveillance Status : {self.surveillance_status}\n"
            f"NIC Supplement      : {self.nic_supplement}\n"
            f"Altitude (ft)       : {self.altitude}\n"
            f"CPR Time            : {self.cpr_time}\n"
            f"CPR Format          : {fmt}\n"
            f"Raw Latitude        : {self.cpr_latitude}\n"
            f"Raw Longitude       : {self.cpr_longitude}\n"
        )


@dataclasses.dataclass
class AircraftVelocityMsg:
    """TC19 airborne velocity — extension beyond the reference (which
    classes TC19 as Unknown, src/adsb/packet.rs:36-38; its TUI velocity
    column is hardwired "n/a", src/adsb/tui.rs:77). Decoded only in
    extended mode so default-mode display output stays reference-parity.

    Subtypes 1/2 carry ground velocity (E-W / N-S components; subtype 2 is
    the supersonic encoding, x4); subtypes 3/4 carry airspeed + magnetic
    heading. All subtypes carry a baro/GNSS vertical rate and the
    GNSS-baro altitude delta.
    """

    msg_type: int
    subtype: int
    intent_change: int
    nac_v: int
    # Subtype 1/2 (ground velocity); None when unavailable or subtype 3/4.
    ground_speed_kt: Optional[float]
    track_deg: Optional[float]
    # Subtype 3/4 (air velocity); None when unavailable or subtype 1/2.
    heading_deg: Optional[float]
    airspeed_kt: Optional[int]
    airspeed_is_tas: bool
    # All subtypes.
    vertical_rate_fpm: Optional[int]
    vr_source_gnss: bool
    gnss_baro_diff_ft: Optional[int]

    @classmethod
    def from_me(cls, me: bytes) -> "AircraftVelocityMsg":
        import math

        subtype = me[0] & 0x7
        supersonic = subtype in (2, 4)
        scale = 4 if supersonic else 1

        intent_change = (me[1] >> 7) & 1
        nac_v = (me[1] >> 3) & 0x7

        # Bits 14-24 / 25-35 of the ME field (1-indexed): two sign+10-bit
        # velocity fields spanning me[1..4].
        sign_a = (me[1] >> 2) & 1
        val_a = ((me[1] & 0x3) << 8) | me[2]  # 10 bits
        sign_b = (me[3] >> 7) & 1
        val_b = ((me[3] & 0x7F) << 3) | (me[4] >> 5)  # 10 bits

        ground_speed_kt = track_deg = None
        heading_deg = None
        airspeed_kt = None
        airspeed_is_tas = False
        if subtype in (1, 2):
            if val_a != 0 and val_b != 0:
                # value 0 = no data; speed = (value-1) kt, sign 1 = west/south
                vx = (val_a - 1) * scale * (-1 if sign_a else 1)  # east+
                vy = (val_b - 1) * scale * (-1 if sign_b else 1)  # north+
                ground_speed_kt = math.hypot(vx, vy)
                track_deg = math.degrees(math.atan2(vx, vy)) % 360.0
        elif subtype in (3, 4):
            if sign_a:  # heading status bit
                heading_deg = val_a * 360.0 / 1024.0
            airspeed_is_tas = bool(sign_b)
            if val_b != 0:
                airspeed_kt = (val_b - 1) * scale

        # Vertical rate: bit 36 source, 37 sign, 38-46 value (9 bits).
        vr_source_gnss = ((me[4] >> 4) & 1) == 0
        vr_sign = (me[4] >> 3) & 1
        vr_val = ((me[4] & 0x7) << 6) | (me[5] >> 2)
        vertical_rate_fpm = (
            None if vr_val == 0 else (vr_val - 1) * 64 * (-1 if vr_sign else 1)
        )

        # GNSS height minus baro altitude: bit 49 sign, 50-56 value (7 bits).
        gbd_sign = (me[6] >> 7) & 1
        gbd_val = me[6] & 0x7F
        gnss_baro_diff_ft = (
            None if gbd_val == 0 else (gbd_val - 1) * 25 * (-1 if gbd_sign else 1)
        )

        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            subtype=subtype,
            intent_change=intent_change,
            nac_v=nac_v,
            ground_speed_kt=ground_speed_kt,
            track_deg=track_deg,
            heading_deg=heading_deg,
            airspeed_kt=airspeed_kt,
            airspeed_is_tas=airspeed_is_tas,
            vertical_rate_fpm=vertical_rate_fpm,
            vr_source_gnss=vr_source_gnss,
            gnss_baro_diff_ft=gnss_baro_diff_ft,
        )

    def format(self) -> str:
        lines = [
            "Message:",
            f"Type                : {self.msg_type} (Velocity, subtype {self.subtype})",
        ]
        if self.ground_speed_kt is not None:
            lines.append(f"Ground Speed (kt)   : {self.ground_speed_kt:.1f}")
            lines.append(f"Track (deg)         : {self.track_deg:.1f}")
        if self.airspeed_kt is not None:
            kind = "TAS" if self.airspeed_is_tas else "IAS"
            lines.append(f"Airspeed {kind} (kt)  : {self.airspeed_kt}")
        if self.heading_deg is not None:
            lines.append(f"Heading (deg)       : {self.heading_deg:.1f}")
        if self.vertical_rate_fpm is not None:
            src = "GNSS" if self.vr_source_gnss else "Baro"
            lines.append(f"Vertical Rate (fpm) : {self.vertical_rate_fpm} ({src})")
        if self.gnss_baro_diff_ft is not None:
            lines.append(f"GNSS-Baro Alt (ft)  : {self.gnss_baro_diff_ft}")
        return "\n".join(lines) + "\n"


def decode_movement_kt(movement: int) -> Optional[float]:
    """TC5-8 7-bit ground-movement field -> speed in knots (piecewise
    nonlinear encoding; DO-260B Table 2-19). None = no information."""
    if movement == 0 or movement >= 125:
        return None
    if movement == 1:
        return 0.0
    if movement <= 8:
        return 0.125 + (movement - 2) * 0.125
    if movement <= 12:
        return 1.0 + (movement - 9) * 0.25
    if movement <= 38:
        return 2.0 + (movement - 13) * 0.5
    if movement <= 93:
        return 15.0 + (movement - 39) * 1.0
    if movement <= 108:
        return 70.0 + (movement - 94) * 2.0
    if movement <= 123:
        return 100.0 + (movement - 109) * 5.0
    return 175.0  # 124: >= 175 kt


@dataclasses.dataclass
class SurfacePositionMsg:
    """TC5-8 surface position — extension (reference classes these
    Unknown; its position decode covers TC9-18 only,
    src/adsb/packet.rs:34-35)."""

    msg_type: int
    movement_kt: Optional[float]
    track_deg: Optional[float]  # None when track status bit is 0
    cpr_time: int
    cpr_format: CprFormat
    cpr_latitude: int
    cpr_longitude: int

    @classmethod
    def from_me(cls, me: bytes) -> "SurfacePositionMsg":
        movement = ((me[0] & 0x7) << 4) | (me[1] >> 4)
        track_valid = (me[1] >> 3) & 1
        track7 = ((me[1] & 0x7) << 4) | (me[2] >> 4)
        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            movement_kt=decode_movement_kt(movement),
            track_deg=track7 * 360.0 / 128.0 if track_valid else None,
            cpr_time=(me[2] & 0b1000) >> 3,
            cpr_format=CprFormat.ODD if (me[2] & 0b100) >> 2 else CprFormat.EVEN,
            cpr_latitude=((me[2] & 0b11) << 15)
            | (me[3] << 7)
            | ((me[4] & 0xFE) >> 1),
            cpr_longitude=((me[4] & 1) << 16) | (me[5] << 8) | me[6],
        )

    def format(self) -> str:
        fmt = "Odd" if self.cpr_format is CprFormat.ODD else "Even"
        mov = f"{self.movement_kt:g} kt" if self.movement_kt is not None else "n/a"
        trk = f"{self.track_deg:.1f}" if self.track_deg is not None else "n/a"
        return (
            "Message:\n"
            f"Type                : {self.msg_type} (Surface position)\n"
            f"Movement            : {mov}\n"
            f"Ground Track (deg)  : {trk}\n"
            f"CPR Format          : {fmt}\n"
            f"Raw Latitude        : {self.cpr_latitude}\n"
            f"Raw Longitude       : {self.cpr_longitude}\n"
        )


_ID13_BIT_ORDER = (
    # (digit, weight) per ID13 bit, transmitted order
    # C1 A1 C2 A2 C4 A4 X B1 D1 B2 D2 B4 D4
    ("c", 1), ("a", 1), ("c", 2), ("a", 2), ("c", 4), ("a", 4), (None, 0),
    ("b", 1), ("d", 1), ("b", 2), ("d", 2), ("b", 4), ("d", 4),
)


def squawk_from_id13(id13: int) -> int:
    """13-bit interleaved identity field -> 4-digit Mode A code."""
    digits = {"a": 0, "b": 0, "c": 0, "d": 0}
    for i, (digit, weight) in enumerate(_ID13_BIT_ORDER):
        if digit is not None and (id13 >> (12 - i)) & 1:
            digits[digit] |= weight
    return digits["a"] * 1000 + digits["b"] * 100 + digits["c"] * 10 + digits["d"]


EMERGENCY_STATES = (
    "none",
    "general",
    "lifeguard/medical",
    "minimum fuel",
    "no communications",
    "unlawful interference",
    "downed aircraft",
    "reserved",
)


@dataclasses.dataclass
class AircraftStatusMsg:
    """TC28 aircraft status — extension (reference classes TC28 Unknown).

    Subtype 1 carries the emergency/priority state and the Mode A
    (squawk) code; other subtypes are kept raw.
    """

    msg_type: int
    subtype: int
    emergency_state: Optional[int]  # subtype 1 only
    squawk: Optional[int]  # subtype 1 only

    @classmethod
    def from_me(cls, me: bytes) -> "AircraftStatusMsg":
        subtype = me[0] & 0x7
        emergency_state = squawk = None
        if subtype == 1:
            emergency_state = me[1] >> 5
            id13 = ((me[1] & 0x1F) << 8) | me[2]
            squawk = squawk_from_id13(id13)
        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            subtype=subtype,
            emergency_state=emergency_state,
            squawk=squawk,
        )

    def format(self) -> str:
        lines = [
            "Message:",
            f"Type                : {self.msg_type} (Status, subtype {self.subtype})",
        ]
        if self.emergency_state is not None:
            lines.append(
                f"Emergency           : {EMERGENCY_STATES[self.emergency_state]}"
            )
            lines.append(f"Squawk              : {self.squawk:04d}")
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class TargetStateMsg:
    """TC29 subtype 1 target state & status (DO-260B) — extension
    (reference classes TC29 Unknown). Subtype 0 (the legacy format) is
    kept raw (all fields None except msg_type/subtype)."""

    msg_type: int
    subtype: int
    sil_supplement: Optional[int] = None
    selected_altitude_ft: Optional[int] = None
    altitude_is_fms: Optional[bool] = None  # False = MCP/FCU source
    baro_setting_mb: Optional[float] = None
    selected_heading_deg: Optional[float] = None
    nac_p: Optional[int] = None
    nic_baro: Optional[int] = None
    sil: Optional[int] = None
    mode_valid: Optional[bool] = None
    autopilot: Optional[bool] = None
    vnav: Optional[bool] = None
    alt_hold: Optional[bool] = None
    approach: Optional[bool] = None
    tcas_operational: Optional[bool] = None
    lnav: Optional[bool] = None

    @classmethod
    def from_me(cls, me: bytes) -> "TargetStateMsg":
        v = int.from_bytes(me, "big")  # 56 bits

        def field(start: int, width: int) -> int:  # 1-indexed MSB-first
            return (v >> (56 - start - width + 1)) & ((1 << width) - 1)

        subtype = field(6, 2)
        if subtype != 1:  # legacy subtype 0 / reserved: keep raw
            return cls(msg_type=(me[0] & 0xF8) >> 3, subtype=subtype)

        alt_val = field(10, 11)
        baro_val = field(21, 9)
        hdg_status = field(30, 1)
        hdg_val = field(31, 9)
        heading = None
        if hdg_status:
            signed = hdg_val - 512 if hdg_val >= 256 else hdg_val
            heading = (signed * 180.0 / 256.0) % 360.0
        mode_valid = bool(field(47, 1))
        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            subtype=subtype,
            sil_supplement=field(8, 1),
            selected_altitude_ft=None if alt_val == 0 else (alt_val - 1) * 32,
            altitude_is_fms=bool(field(9, 1)),
            baro_setting_mb=(
                None if baro_val == 0 else round((baro_val - 1) * 0.8 + 800.0, 1)
            ),
            selected_heading_deg=heading,
            nac_p=field(40, 4),
            nic_baro=field(44, 1),
            sil=field(45, 2),
            mode_valid=mode_valid,
            autopilot=bool(field(48, 1)) if mode_valid else None,
            vnav=bool(field(49, 1)) if mode_valid else None,
            alt_hold=bool(field(50, 1)) if mode_valid else None,
            approach=bool(field(52, 1)) if mode_valid else None,
            tcas_operational=bool(field(53, 1)) if mode_valid else None,
            lnav=bool(field(54, 1)) if mode_valid else None,
        )

    def format(self) -> str:
        lines = [
            "Message:",
            f"Type                : {self.msg_type} (Target state, subtype {self.subtype})",
        ]
        if self.selected_altitude_ft is not None:
            src = "FMS" if self.altitude_is_fms else "MCP"
            lines.append(f"Selected Alt (ft)   : {self.selected_altitude_ft} ({src})")
        if self.selected_heading_deg is not None:
            lines.append(f"Selected Heading    : {self.selected_heading_deg:.1f}")
        if self.baro_setting_mb is not None:
            lines.append(f"Baro Setting (mb)   : {self.baro_setting_mb}")
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class OperationalStatusMsg:
    """TC31 operational status — extension (reference classes TC31 Unknown).

    Subtype 0 = airborne (16-bit capability class), subtype 1 = surface
    (12-bit capability class + 4-bit length/width code).
    """

    msg_type: int
    subtype: int
    capability_class: int
    lw_code: Optional[int]  # surface only
    operational_mode: int
    adsb_version: int
    nic_supplement_a: int
    nac_p: int
    gva: Optional[int]  # airborne only (surface: reserved)
    sil: int
    nic_baro: Optional[int]  # airborne; surface has track/heading flag here
    track_heading_valid: Optional[int]  # surface only
    hrd_magnetic: int  # 0 = true north, 1 = magnetic north
    sil_supplement: int

    @classmethod
    def from_me(cls, me: bytes) -> "OperationalStatusMsg":
        subtype = me[0] & 0x7
        surface = subtype == 1
        cc16 = (me[1] << 8) | me[2]
        return cls(
            msg_type=(me[0] & 0xF8) >> 3,
            subtype=subtype,
            capability_class=(cc16 >> 4) if surface else cc16,
            lw_code=(cc16 & 0xF) if surface else None,
            operational_mode=(me[3] << 8) | me[4],
            adsb_version=me[5] >> 5,
            nic_supplement_a=(me[5] >> 4) & 1,
            nac_p=me[5] & 0xF,
            gva=None if surface else me[6] >> 6,
            sil=(me[6] >> 4) & 0x3,
            nic_baro=None if surface else (me[6] >> 3) & 1,
            track_heading_valid=((me[6] >> 3) & 1) if surface else None,
            hrd_magnetic=(me[6] >> 2) & 1,
            sil_supplement=(me[6] >> 1) & 1,
        )

    def format(self) -> str:
        kind = "surface" if self.subtype == 1 else "airborne"
        return (
            "Message:\n"
            f"Type                : {self.msg_type} (Operational status, {kind})\n"
            f"ADS-B Version       : {self.adsb_version}\n"
            f"NACp                : {self.nac_p}\n"
            f"SIL                 : {self.sil}\n"
        )


AdsbMsg = Union[
    AircraftId,
    AircraftPositionMsg,
    AircraftVelocityMsg,
    AircraftStatusMsg,
    OperationalStatusMsg,
    SurfacePositionMsg,
    TargetStateMsg,
    UnknownMsg,
]


# --- Extension: non-DF17 Mode S frames (see airjax_torch.protocol.shortframe;
# the reference decodes only DF17) ---


@dataclasses.dataclass
class AllCallReply:
    """DF11 all-call reply (56-bit).

    `interrogator` is the II/SI code recovered from PI ^ CRC: 0 for
    spontaneous acquisition squitters (directly validated), nonzero for
    interrogated replies (cache-gated, see airjax_torch.extended)."""

    icao: int
    capability: int
    time_processed: float
    interrogator: int = 0

    def format(self) -> str:
        out = (
            "== DF11 all-call ==\n"
            f"ICAO            : {self.icao:06X}\n"
            f"Capability      : {self.capability}\n"
        )
        if self.interrogator:
            out += f"Interrogator    : {self.interrogator}\n"
        return out


@dataclasses.dataclass
class SurveillanceReply:
    """DF4/5 (56-bit) or DF20/21 (112-bit Comm-B) surveillance reply.

    AP-addressed: the ICAO comes from the parity overlay and is only
    trusted because it matched a recently validated aircraft.
    """

    df: int
    icao: int
    flight_status: int
    altitude_ft: Optional[int]  # DF4/20 (None if AC13 invalid/metric)
    squawk: Optional[int]  # DF5/21
    time_processed: float
    # DF20/21 only: inferred Comm-B registers (airjax_torch.protocol.commb),
    # e.g. {"2,0": "KLM1017_", "6,0": {...}}. None for DF4/5.
    bds: Optional[dict] = None

    def format(self) -> str:
        lines = [
            f"== DF{self.df} surveillance ==",
            f"ICAO            : {self.icao:06X}",
            f"Flight Status   : {self.flight_status}",
        ]
        if self.altitude_ft is not None:
            lines.append(f"Altitude (ft)   : {self.altitude_ft}")
        if self.squawk is not None:
            lines.append(f"Squawk          : {self.squawk:04d}")
        if self.bds:
            for reg, val in sorted(self.bds.items()):
                lines.append(f"BDS {reg}         : {val}")
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class AcasReply:
    """DF0 (short) / DF16 (long) ACAS air-air surveillance reply.

    AP-addressed like DF4/5 (see airjax_torch.protocol.shortframe); DF16's MV
    field may carry an active resolution advisory (airjax_torch.protocol.acas).
    """

    df: int
    icao: int
    vertical_status: int  # 1 = on ground
    sensitivity_level: int
    reply_information: int
    altitude_ft: Optional[int]  # None if AC13 invalid/metric
    time_processed: float
    ra: Optional[dict] = None  # DF16 BDS 3,0 RA report

    def format(self) -> str:
        lines = [
            f"== DF{self.df} ACAS air-air ==",
            f"ICAO            : {self.icao:06X}",
            f"Vertical Status : {'on ground' if self.vertical_status else 'airborne'}",
            f"Sensitivity Lvl : {self.sensitivity_level}",
        ]
        if self.altitude_ft is not None:
            lines.append(f"Altitude (ft)   : {self.altitude_ft}")
        if self.ra:
            adv = ", ".join(self.ra["advisories"]) or "none"
            lines.append(f"Resolution Adv. : {adv}")
            if self.ra["complements"]:
                lines.append(
                    f"RA Complements  : {', '.join(self.ra['complements'])}"
                )
            if self.ra["terminated"]:
                lines.append("RA Terminated   : yes")
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class CommDReply:
    """DF24+ (first two bits '11') Comm-D extended-length message (ELM)
    segment — ICAO Annex 10 v4 3.1.2.7.3. AP-addressed like DF20/21;
    the repo extension the reference has no analogue for (it decodes no
    non-DF17 frames at all).

    Frame layout: bits 1-2 '11', bit 3 spare, bit 4 KE (control: 1 =
    downlink ELM transmission ack), bits 5-8 ND (segment number), bits
    9-88 MD (80-bit message segment), 89-112 AP.
    """

    icao: int
    ke: int
    nd: int  # D-segment number, 0-15
    md: bytes  # 10-byte segment payload
    time_processed: float
    df: int = 24

    def format(self) -> str:
        return (
            f"== DF24 Comm-D ELM ==\n"
            f"ICAO            : {self.icao:06X}\n"
            f"KE              : {self.ke}\n"
            f"Segment (ND)    : {self.nd}\n"
            f"MD              : {self.md.hex()}\n"
        )


# ADS-B-shaped ME gating for non-DF17 extended squitters (extension):
# DF18 CF values whose ME uses the DF17 layout (0/1/6 ADS-B, 2/5
# fine-format TIS-B) and DF19 AF values (military; only 0). Shared with
# airjax's batched tracker (airjax/track/batch.py), whose port waits for
# the batched-sink slice.
DF18_ADSB_CF = frozenset({0, 1, 2, 5, 6})
DF19_ADSB_AF = frozenset({0})


@dataclasses.dataclass
class AdsbPacket:
    packet: bytes  # full 14 frame bytes
    downlink_format: int
    capability: int
    icao: int
    msg_type: int
    msg: AdsbMsg
    time_processed: float  # epoch seconds

    @classmethod
    def from_bytes(
        cls,
        packet: bytes,
        time_processed: float | None = None,
        extensions: bool = False,
    ) -> "AdsbPacket":
        # src/adsb/packet.rs:25-49. With extensions=True (extended decode
        # mode only) TC19 becomes a typed velocity message instead of the
        # reference's Unknown; default output stays reference-parity.
        packet = bytes(packet)
        msg_type = packet[4] >> 3
        me = packet[4:11]
        msg: AdsbMsg
        # Extension: DF18 (extended squitter / non-transponder) shares the
        # DF17 ME layout only for CF 0/1/6 (ADS-B) and 2/5 (fine-format
        # TIS-B); CF 3 (coarse TIS-B), 4 (management) and 7 (reserved) use
        # different ME encodings and stay Unknown. DF19 is military: only
        # AF=0 is DF17-shaped. The default (parity) path never sees these
        # (the reference detector hard-gates DF17).
        me_is_adsb = True
        if extensions:
            df = packet[0] >> 3
            sub = packet[0] & 0b111  # CF (DF18) / AF (DF19)
            if df == 18:
                me_is_adsb = sub in DF18_ADSB_CF
            elif df == 19:
                me_is_adsb = sub in DF19_ADSB_AF
        if not me_is_adsb:
            msg = UnknownMsg(raw_msg=packet[4:])
        elif 1 <= msg_type <= 4:
            msg = AircraftId.from_me(me)
        elif 9 <= msg_type <= 18:
            msg = AircraftPositionMsg.from_me(me)
        elif extensions and 5 <= msg_type <= 8:
            msg = SurfacePositionMsg.from_me(me)
        elif extensions and msg_type == 19:
            msg = AircraftVelocityMsg.from_me(me)
        elif extensions and 20 <= msg_type <= 22:
            msg = AircraftPositionMsg.from_me_gnss(me)
        elif extensions and msg_type == 0:
            msg = AircraftPositionMsg.from_me_no_fix(me)
        elif extensions and msg_type == 28:
            msg = AircraftStatusMsg.from_me(me)
        elif extensions and msg_type == 29:
            msg = TargetStateMsg.from_me(me)
        elif extensions and msg_type == 31:
            msg = OperationalStatusMsg.from_me(me)
        else:
            msg = UnknownMsg(raw_msg=packet[4:])
        return cls(
            packet=packet,
            downlink_format=packet[0] >> 3,
            capability=packet[0] & 5,  # parity quirk (src/adsb/packet.rs:27)
            icao=(packet[1] << 16) | (packet[2] << 8) | packet[3],
            msg_type=msg_type,
            msg=msg,
            time_processed=time.time() if time_processed is None else time_processed,
        )

    @classmethod
    def from_hex(
        cls,
        hex_str: str,
        time_processed: float | None = None,
        extensions: bool = False,
    ) -> "AdsbPacket":
        return cls.from_bytes(bytes.fromhex(hex_str), time_processed, extensions)

    def format(self) -> str:
        """Replicates the reference Display impl (src/adsb/packet.rs:77-99)."""
        ts = datetime.datetime.fromtimestamp(self.time_processed).astimezone()
        return (
            f"== {self.packet.hex()} ==\n"
            "Decoded Information:\n"
            f"Downlink Format : {self.downlink_format}\n"
            f"Capability      : {self.capability}\n"
            f"ICAO            : {self.icao:06X}\n"
            f"Processed Time  : {ts}\n"
            f"Message Type    : {self.msg_type}\n"
            f"{self.msg.format()}"
        )

    def __str__(self) -> str:
        return self.format()
