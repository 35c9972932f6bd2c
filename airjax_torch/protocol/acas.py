"""ACAS/TCAS resolution-advisory decode for DF16 MV fields — extension.

The reference decodes no air-air surveillance at all (its detector
hard-gates DF17, src/adsb/demod.rs:38-54). DF0 (short) and DF16 (long)
air-air replies are what TCAS interrogations elicit; DF16 carries a
56-bit MV field which, when its leading VDS byte is 0x30 (BDS 3,0
"active resolution advisory"), encodes the RA report defined by
ICAO Annex 10 vol IV 4.3.8.4.2.2:

  MV bits (1-based within the 56-bit field):
    1-8   VDS  (0x30 for an RA report)
    9-22  ARA  active resolution advisories (14 bits)
    23-26 RAC  resolution advisory complements
    27    RAT  RA terminated
    28    MTE  multiple threat encounter
    29-30 TTI  threat type indicator
    31-56 TID  threat identity (ICAO when TTI=1)

ARA bit semantics depend on ARA41 (its first bit) and MTE; the decode
below follows DO-185B / the published bit tables.

Carried over unchanged from airjax/protocol/acas.py (whose package imports jax);
tests/test_torch_extended.py and test_torch_packet.py hold their outputs equal.
"""

from __future__ import annotations

VDS_RA_REPORT = 0x30


def _bit(v: int, pos: int, width: int) -> int:
    """1-based MSB-first bit within a `width`-bit integer."""
    return (v >> (width - pos)) & 1


def decode_ara(ara: int, mte: int) -> list[str]:
    """14-bit ARA field -> list of human-readable active-RA clauses."""
    out: list[str] = []
    b = lambda i: _bit(ara, i, 14)
    if b(1):  # ARA41: single-threat (or identical-sense multi-threat) RA
        out.append("corrective" if b(2) else "preventive")
        out.append("downward sense" if b(3) else "upward sense")
        if b(4):
            out.append("increased rate")
        if b(5):
            out.append("sense reversal")
        if b(6):
            out.append("altitude crossing")
        out.append("positive" if b(7) else "vertical speed limit")
    elif mte:  # ARA41=0, MTE=1: multi-threat, one bit per clause
        if b(2):
            out.append("requires upward correction")
        if b(3):
            out.append("requires positive climb")
        if b(4):
            out.append("requires downward correction")
        if b(5):
            out.append("requires positive descend")
        if b(6):
            out.append("requires altitude crossing")
        if b(7):
            out.append("requires sense reversal")
    return out


def decode_rac(rac: int) -> list[str]:
    """4-bit RAC field -> list of active advisory complements."""
    names = (
        "do not pass below",
        "do not pass above",
        "do not turn left",
        "do not turn right",
    )
    return [n for i, n in enumerate(names) if (rac >> (3 - i)) & 1]


def decode_mv_ra(mv: bytes) -> dict | None:
    """7-byte DF16 MV field -> RA report dict, or None when the VDS is
    not an RA report (the MV format is then interrogator-defined)."""
    if len(mv) != 7 or mv[0] != VDS_RA_REPORT:
        return None
    word = int.from_bytes(mv, "big")  # 56 bits
    ara = (word >> 34) & 0x3FFF
    rac = (word >> 30) & 0xF
    rat = (word >> 29) & 1
    mte = (word >> 28) & 1
    tti = (word >> 26) & 0b11
    tid = word & 0x3FFFFFF
    report: dict = {
        "ara": ara,
        "advisories": decode_ara(ara, mte),
        "rac": rac,
        "complements": decode_rac(rac),
        "terminated": bool(rat),
        "multiple_threats": bool(mte),
        "threat_type": tti,
    }
    if tti == 1:  # threat identified by ICAO address
        report["threat_icao"] = tid >> 2
    elif tti == 2:  # threat identified by altitude/range/bearing
        report["threat_altitude_code"] = (tid >> 13) & 0x1FFF
        report["threat_range_code"] = (tid >> 6) & 0x7F
        report["threat_bearing_code"] = tid & 0x3F
    return report


def make_mv_ra(
    ara: int,
    rac: int = 0,
    rat: int = 0,
    mte: int = 0,
    tti: int = 0,
    tid: int = 0,
) -> bytes:
    """Assemble a 7-byte RA-report MV field (inverse of decode_mv_ra)."""
    word = (
        (VDS_RA_REPORT << 48)
        | ((ara & 0x3FFF) << 34)
        | ((rac & 0xF) << 30)
        | ((rat & 1) << 29)
        | ((mte & 1) << 28)
        | ((tti & 0b11) << 26)
        | (tid & 0x3FFFFFF)
    )
    return word.to_bytes(7, "big")
