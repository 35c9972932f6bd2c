"""Comm-B (BDS register) decode for the DF20/21 MB field — extension.

The reference ignores the 56-bit MB payload of Comm-B replies entirely
(it decodes no short/AP frames at all). Real Mode S surveillance relies
on it: BDS 2,0 carries the callsign, 4,0 the selected altitude, 5,0
track/ground speed, 6,0 heading/airspeed. The MB field does not announce
which register it holds, so receivers infer it with per-register validity
heuristics (status-bit consistency + physical range checks — the same
approach dump1090/pyModeS use).

All decoders return None when the field fails its register's validity
rules; `infer_bds` returns every register that validates (ambiguity is
possible and callers should treat multi-matches as uncertain).

Carried over unchanged from airjax/protocol/commb.py (whose package imports jax);
tests/test_torch_extended.py holds the assembled Comm-B replies equal.
"""

from __future__ import annotations

from typing import Optional

from airjax_torch.protocol.fields import CHAR_CONVERT

_VALID_CS = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_ ")


def _bits(mb: bytes) -> int:
    if len(mb) != 7:
        raise ValueError("MB field must be 7 bytes")
    return int.from_bytes(mb, "big")


def _field(v: int, start: int, width: int) -> int:
    """1-indexed MSB-first bit field of a 56-bit MB value."""
    return (v >> (56 - start - width + 1)) & ((1 << width) - 1)


def decode_bds20(mb: bytes) -> Optional[str]:
    """BDS 2,0 aircraft identification -> 8-char callsign."""
    if mb[0] != 0x20:
        return None
    bits48 = int.from_bytes(mb[1:7], "big")
    cs = "".join(
        CHAR_CONVERT[(bits48 >> (42 - 6 * i)) & 0x3F] for i in range(8)
    )
    # '#' marks unassigned 6-bit codes; a real BDS2,0 never contains them.
    if any(c not in _VALID_CS for c in cs):
        return None
    return cs


def decode_bds40(mb: bytes) -> Optional[dict]:
    """BDS 4,0 selected vertical intention."""
    v = _bits(mb)
    out: dict = {}
    s_mcp, mcp = _field(v, 1, 1), _field(v, 2, 12)
    s_fms, fms = _field(v, 14, 1), _field(v, 15, 12)
    s_baro, baro = _field(v, 27, 1), _field(v, 28, 12)
    # Status 0 requires an all-zero field; reserved bits 40-47 must be 0.
    for s, val in ((s_mcp, mcp), (s_fms, fms), (s_baro, baro)):
        if s == 0 and val != 0:
            return None
    if _field(v, 40, 8) != 0:
        return None
    if s_mcp:
        alt = mcp * 16
        if alt > 65000:
            return None
        out["mcp_alt_ft"] = alt
    if s_fms:
        alt = fms * 16
        if alt > 65000:
            return None
        out["fms_alt_ft"] = alt
    if s_baro:
        mb_val = baro * 0.1 + 800.0
        if not 850.0 <= mb_val <= 1100.0:
            return None
        out["baro_setting_mb"] = round(mb_val, 1)
    return out or None


def _signed(val: int, width: int) -> int:
    return val - (1 << width) if val >= (1 << (width - 1)) else val


def decode_bds50(mb: bytes) -> Optional[dict]:
    """BDS 5,0 track and turn report."""
    v = _bits(mb)
    out: dict = {}
    s_roll, roll = _field(v, 1, 1), _field(v, 2, 10)
    s_trk, trk = _field(v, 12, 1), _field(v, 13, 11)
    s_gs, gs = _field(v, 24, 1), _field(v, 25, 10)
    s_tr, tr = _field(v, 35, 1), _field(v, 36, 10)
    s_tas, tas = _field(v, 46, 1), _field(v, 47, 10)
    for s, val in ((s_roll, roll), (s_trk, trk), (s_gs, gs), (s_tr, tr), (s_tas, tas)):
        if s == 0 and val != 0:
            return None
    if s_roll:
        deg = _signed(roll, 10) * 45.0 / 256.0
        if abs(deg) > 50.0:
            return None
        out["roll_deg"] = round(deg, 2)
    if s_trk:
        deg = _signed(trk, 11) * 90.0 / 512.0 % 360.0
        out["track_deg"] = round(deg, 2)
    if s_gs:
        kt = gs * 2
        if kt > 800:
            return None
        out["ground_speed_kt"] = kt
    if s_tr:
        rate = _signed(tr, 10) * 8.0 / 256.0
        if abs(rate) > 16.0:
            return None
        out["track_rate_dps"] = round(rate, 3)
    if s_tas:
        kt = tas * 2
        if not 0 <= kt <= 800:
            return None
        out["tas_kt"] = kt
    # Cross-check: TAS and GS should be broadly consistent when both set.
    if "tas_kt" in out and "ground_speed_kt" in out:
        if abs(out["tas_kt"] - out["ground_speed_kt"]) > 200:
            return None
    return out or None


def decode_bds60(mb: bytes) -> Optional[dict]:
    """BDS 6,0 heading and speed report."""
    v = _bits(mb)
    out: dict = {}
    s_hdg, hdg = _field(v, 1, 1), _field(v, 2, 11)
    s_ias, ias = _field(v, 13, 1), _field(v, 14, 10)
    s_mach, mach = _field(v, 24, 1), _field(v, 25, 10)
    s_bvs, bvs = _field(v, 35, 1), _field(v, 36, 10)
    s_ivs, ivs = _field(v, 46, 1), _field(v, 47, 10)
    for s, val in ((s_hdg, hdg), (s_ias, ias), (s_mach, mach), (s_bvs, bvs), (s_ivs, ivs)):
        if s == 0 and val != 0:
            return None
    if s_hdg:
        deg = _signed(hdg, 11) * 90.0 / 512.0 % 360.0
        out["heading_deg"] = round(deg, 2)
    if s_ias:
        if not 0 < ias <= 600:
            return None
        out["ias_kt"] = ias
    if s_mach:
        m = mach * 2.048 / 512.0
        if m > 1.1:
            return None
        out["mach"] = round(m, 3)
    if s_bvs:
        fpm = _signed(bvs, 10) * 32
        if abs(fpm) > 12000:
            return None
        out["baro_vs_fpm"] = fpm
    if s_ivs:
        fpm = _signed(ivs, 10) * 32
        if abs(fpm) > 12000:
            return None
        out["inertial_vs_fpm"] = fpm
    # Cross-check IAS vs Mach plausibility when both present.
    if "ias_kt" in out and "mach" in out and out["mach"] > 0:
        if out["ias_kt"] > 500 and out["mach"] < 0.3:
            return None
    return out or None


def decode_bds10(mb: bytes) -> Optional[dict]:
    """BDS 1,0 data link capability report."""
    v = _bits(mb)
    if mb[0] != 0x10:  # BDS code is explicit in this register
        return None
    if _field(v, 10, 5) != 0:  # reserved bits
        return None
    version = _field(v, 17, 7)  # Mode S subnetwork version number
    if version > 5:
        return None
    return {
        "continuation": bool(_field(v, 9, 1)),
        "overlay_command_capability": bool(_field(v, 15, 1)),
        "subnetwork_version": version,
        "enhanced_protocol": bool(_field(v, 24, 1)),
        "specific_services": bool(_field(v, 25, 1)),
        "aircraft_id_capability": bool(_field(v, 33, 1)),
    }


_GICB_REGS = (
    "0,5", "0,6", "0,7", "0,8", "0,9", "0,A", "2,0", "2,1",
    "4,0", "4,1", "4,2", "4,3", "4,4", "4,5", "4,8", "5,0",
    "5,1", "5,2", "5,3", "5,4", "5,5", "5,6", "5,F", "6,0",
)


def decode_bds17(mb: bytes) -> Optional[dict]:
    """BDS 1,7 common usage GICB capability report: bits 1-24 flag
    support for the registers in _GICB_REGS; 25-56 are reserved."""
    v = _bits(mb)
    if _field(v, 25, 32) != 0:  # reserved tail must be zero
        return None
    caps = [_field(v, i + 1, 1) for i in range(24)]
    if not caps[6]:  # BDS 2,0 (identification) support is universal
        return None
    return {"supported": [r for r, c in zip(_GICB_REGS, caps) if c]}


def decode_bds44(mb: bytes) -> Optional[dict]:
    """BDS 4,4 meteorological routine air report (extension depth: the
    GICB registers real receivers poll for wind/temperature)."""
    v = _bits(mb)
    out: dict = {}
    fom = _field(v, 1, 4)
    s_wind, wspd, wdir = _field(v, 5, 1), _field(v, 6, 9), _field(v, 15, 9)
    # Static air temperature: sign bit 24, 10-bit magnitude, LSB 0.25 C.
    temp_raw = _field(v, 24, 11)
    s_press, press = _field(v, 35, 1), _field(v, 36, 11)
    s_turb, turb = _field(v, 47, 1), _field(v, 48, 2)
    s_hum, hum = _field(v, 50, 1), _field(v, 51, 6)
    for s, val in ((s_wind, (wspd << 9) | wdir), (s_press, press), (s_turb, turb), (s_hum, hum)):
        if s == 0 and val != 0:
            return None
    if fom > 4:  # figure-of-merit/source codes above 4 are unassigned
        return None
    if s_wind:
        if wspd > 250:
            return None
        out["wind_speed_kt"] = wspd
        out["wind_dir_deg"] = round(wdir * 180.0 / 256.0, 1)
    temp_c = _signed(temp_raw, 11) * 0.25
    if not -80.0 <= temp_c <= 60.0:
        return None
    out["static_air_temp_c"] = round(temp_c, 2)
    if s_press:
        if press > 1100:  # sea-level record highs are ~1085 hPa
            return None
        out["avg_static_pressure_hpa"] = press
    if s_turb:
        out["turbulence"] = turb
    if s_hum:
        out["humidity_pct"] = round(hum * 100.0 / 64.0, 1)
    return out or None


def decode_bds53(mb: bytes) -> Optional[dict]:
    """BDS 5,3 air-referenced state vector."""
    v = _bits(mb)
    out: dict = {}
    s_hdg, hdg = _field(v, 1, 1), _field(v, 2, 11)
    s_ias, ias = _field(v, 13, 1), _field(v, 14, 10)
    s_mach, mach = _field(v, 24, 1), _field(v, 25, 9)
    s_tas, tas = _field(v, 34, 1), _field(v, 35, 12)
    s_vs, vs = _field(v, 47, 1), _field(v, 48, 9)
    for s, val in ((s_hdg, hdg), (s_ias, ias), (s_mach, mach), (s_tas, tas), (s_vs, vs)):
        if s == 0 and val != 0:
            return None
    if s_hdg:
        out["magnetic_heading_deg"] = round(
            _signed(hdg, 11) * 90.0 / 512.0 % 360.0, 2
        )
    if s_ias:
        if not 0 < ias <= 600:
            return None
        out["ias_kt"] = ias
    if s_mach:
        m = mach * 0.008
        if m > 1.1:
            return None
        out["mach"] = round(m, 3)
    if s_tas:
        kt = tas * 0.5
        if not 0 < kt <= 800:
            return None
        out["tas_kt"] = kt
    if s_vs:
        fpm = _signed(vs, 9) * 64
        if abs(fpm) > 12000:
            return None
        out["vs_fpm"] = fpm
    # IAS/TAS broad consistency, like the 5,0 GS/TAS cross-check.
    if "ias_kt" in out and "tas_kt" in out:
        if out["tas_kt"] < out["ias_kt"] - 50:
            return None
    return out or None


def decode_bds30(mb: bytes) -> Optional[dict]:
    """BDS 3,0 ACAS active resolution advisory (same layout as the DF16
    MV field, airjax_torch.protocol.acas)."""
    from airjax_torch.protocol.acas import decode_mv_ra

    ra = decode_mv_ra(mb)
    if ra is None or ra["threat_type"] == 3:  # TTI 3 is reserved
        return None
    return ra


def infer_bds(mb: bytes) -> dict[str, dict | str]:
    """Try every supported register; return {bds: decoded} for all that
    validate. Empty MB (all zeros) matches nothing."""
    if mb == b"\x00" * 7:
        return {}
    out: dict[str, dict | str] = {}
    cs = decode_bds20(mb)
    if cs is not None:
        out["2,0"] = cs
    for name, fn in (
        ("1,0", decode_bds10),
        ("1,7", decode_bds17),
        ("3,0", decode_bds30),
        ("4,0", decode_bds40),
        ("4,4", decode_bds44),
        ("5,0", decode_bds50),
        ("5,3", decode_bds53),
        ("6,0", decode_bds60),
    ):
        d = fn(mb)
        if d is not None:
            out[name] = d
    return out


# Registers the BDS 1,7 common-usage GICB report can rule out: a
# candidate in this set that a fresh 1,7 says the transponder does NOT
# service cannot be the register an interrogator read back.
PRUNABLE_BY_GICB = frozenset(_GICB_REGS)


def prune_by_capability(
    candidates: dict[str, dict | str], supported
) -> dict[str, dict | str]:
    """Drop inferred registers the aircraft's announced GICB capability
    (BDS 1,7 `supported` list) rules out. Only prunes when >1 candidate
    (disambiguation, never outright rejection — a stale capability
    report must not suppress the sole plausible reading) and never drops
    registers outside the GICB report's scope (1,0 / 1,7 / 3,0)."""
    if supported is None or len(candidates) <= 1:
        return candidates
    pruned = {
        k: v
        for k, v in candidates.items()
        if k not in PRUNABLE_BY_GICB or k in supported
    }
    return pruned or candidates
