"""CPR (Compressed Position Reporting) global decode, f64-exact on host
(airjax/track/cpr.py, carried over unchanged).

Faithful reimplementation of src/adsb/cpr.rs:19-147 including its quirks,
because decoded positions must match the reference to <1e-4 degrees:

  * NL special cases: lat==0 -> 59, lat==+-87 -> 2, |lat|>87 -> 1
    (src/adsb/cpr.rs:39-54)
  * latitude chosen from the *newest* frame's formula, folded only when
    > 270 (src/adsb/cpr.rs:76-84)
  * when the newest frame is odd the longitude zone count uses
    NL(latitude - 1.0) — one **degree** down, not NL-1 (src/adsb/cpr.rs:101)
  * Rust's `%` on f64 is `fmod` (truncated toward zero), NOT Python's
    floored `%` — this matters for southern-hemisphere (negative index)
    decodes, so we use math.fmod throughout.
  * the even/odd NL consistency gate (src/adsb/cpr.rs:138-141)

This runs on the host: CPR pairing is stateful per aircraft and involves a
handful of transcendentals per *position fix* (not per sample), so it does
not belong on the device; airjax_torch.track.cpr_batch is the vectorized
numpy form for a block's pairs.
"""

from __future__ import annotations

import dataclasses
import math

from airjax_torch.protocol.packet import CprFormat

NUM_ZONES = 15.0  # src/adsb/cpr.rs:19
_CPR_SCALE = 131072.0  # 2^17


@dataclasses.dataclass
class GeographicPosition:
    latitude: float
    longitude: float

    def to_json(self) -> dict:
        # camelCase per bindings/GeographicPosition.ts
        return {"latitude": self.latitude, "longitude": self.longitude}


def calc_num_zones(lat: float) -> int:
    """NL(lat): number of longitude zones (src/adsb/cpr.rs:39-54)."""
    if lat == 0.0:
        return 59
    if lat == 87.0 or lat == -87.0:
        return 2
    if lat < -87.0 or lat > 87.0:
        return 1
    int1 = 1.0 - math.cos(math.pi / (2.0 * NUM_ZONES))
    int2 = math.cos(math.pi / 180.0 * lat)
    int3 = (2.0 * math.pi) / math.acos(1.0 - (int1 / (int2 * int2)))
    return int(math.floor(int3))


def _normalize_longitude(lon: float) -> float:
    while lon < -180.0:
        lon += 360.0
    while lon > 180.0:
        lon -= 360.0
    return lon


def calculate_latitude(
    even_cpr_lat: int, odd_cpr_lat: int, first: CprFormat
) -> tuple[float, float, float]:
    """-> (latitude, even_latitude, odd_latitude); src/adsb/cpr.rs:63-88."""
    even_lat_divisions = 360.0 / (4.0 * NUM_ZONES)
    odd_lat_divisions = 360.0 / (4.0 * NUM_ZONES - 1.0)

    lat_e = even_cpr_lat / _CPR_SCALE
    lat_o = odd_cpr_lat / _CPR_SCALE

    j = math.floor(59.0 * lat_e - 60.0 * lat_o + 0.5)

    even_latitude = even_lat_divisions * (math.fmod(j, 60.0) + lat_e)
    odd_latitude = odd_lat_divisions * (math.fmod(j, 59.0) + lat_o)

    # Newest frame decides (src/adsb/cpr.rs:76-80).
    latitude = odd_latitude if first is CprFormat.EVEN else even_latitude
    if latitude > 270.0:
        latitude -= 360.0
    return latitude, even_latitude, odd_latitude


def calculate_longitude(
    even_cpr_lon: int, odd_cpr_lon: int, latitude: float, first: CprFormat
) -> float:
    """src/adsb/cpr.rs:90-126, including the NL(lat - 1 degree) quirk."""
    lon_e = even_cpr_lon / _CPR_SCALE
    lon_o = odd_cpr_lon / _CPR_SCALE

    nl = calc_num_zones(latitude)
    if first is CprFormat.EVEN:  # newest is odd
        num_zones = float(max(calc_num_zones(latitude - 1.0), 1))
    else:  # newest is even
        num_zones = float(max(calc_num_zones(latitude), 1))

    divisions = 360.0 / num_zones
    m = math.floor(lon_e * (nl - 1) - lon_o * nl + 0.5)

    if first is CprFormat.EVEN:
        longitude = divisions * (math.fmod(m, num_zones) + lon_o)
    else:
        longitude = divisions * (math.fmod(m, num_zones) + lon_e)
    return _normalize_longitude(longitude)


def calculate_geographic_position(
    even_cpr_lat_lon: tuple[int, int],
    odd_cpr_lat_lon: tuple[int, int],
    first: CprFormat,
) -> GeographicPosition | None:
    """Global decode from an (even, odd) frame pair; src/adsb/cpr.rs:135-147."""
    latitude, even_latitude, odd_latitude = calculate_latitude(
        even_cpr_lat_lon[0], odd_cpr_lat_lon[0], first
    )
    if calc_num_zones(even_latitude) != calc_num_zones(odd_latitude):
        return None
    longitude = calculate_longitude(
        even_cpr_lat_lon[1], odd_cpr_lat_lon[1], latitude, first
    )
    return GeographicPosition(latitude=latitude, longitude=longitude)


# ---------------------------------------------------------------------------
# Surface CPR (TC5-8) — extension. The reference decodes no surface
# positions at all, so this follows the spec directly (no quirk
# replication): zone sizes are 90 deg (not 360), and the 4-fold global
# ambiguity is resolved against a receiver reference position.
# ---------------------------------------------------------------------------


def calculate_surface_position(
    even_cpr_lat_lon: tuple[int, int],
    odd_cpr_lat_lon: tuple[int, int],
    first: CprFormat,
    ref_lat: float,
    ref_lon: float,
) -> GeographicPosition | None:
    """Global surface decode from an (even, odd) pair + receiver location."""
    lat_e = even_cpr_lat_lon[0] / _CPR_SCALE
    lat_o = odd_cpr_lat_lon[0] / _CPR_SCALE
    dlat_e = 90.0 / 60.0
    dlat_o = 90.0 / 59.0

    j = math.floor(59.0 * lat_e - 60.0 * lat_o + 0.5)
    lat_even = dlat_e * ((j % 60.0) + lat_e)
    lat_odd = dlat_o * ((j % 59.0) + lat_o)

    lat = lat_odd if first is CprFormat.EVEN else lat_even  # newest frame
    # Latitude solutions repeat every 90 deg; pick the one nearest the
    # receiver (candidates clamped to the valid range).
    shift = min(
        (k * 90.0 for k in (-2, -1, 0, 1) if -90.0 <= lat + k * 90.0 <= 90.0),
        key=lambda s: abs(lat + s - ref_lat),
    )
    lat += shift
    # NL consistency gate AFTER hemisphere resolution: NL is not symmetric
    # across 90-degree shifts, so gating on the raw [0, 90) images lets
    # southern-hemisphere zone-boundary straddles through with a silently
    # wrong longitude (found by fuzzing at lat ~ -79.29 across NL 10/11).
    if calc_num_zones(lat_even + shift) != calc_num_zones(lat_odd + shift):
        return None

    lon_e = even_cpr_lat_lon[1] / _CPR_SCALE
    lon_o = odd_cpr_lat_lon[1] / _CPR_SCALE
    nl = calc_num_zones(lat)
    m = math.floor(lon_e * (nl - 1) - lon_o * nl + 0.5)
    if first is CprFormat.EVEN:  # newest is odd
        ni = max(nl - 1, 1)
        lon = (90.0 / ni) * ((m % ni) + lon_o)
    else:
        ni = max(nl, 1)
        lon = (90.0 / ni) * ((m % ni) + lon_e)
    # Longitude solutions also repeat every 90 deg.
    lon = _normalize_longitude(lon)

    def lon_dist(a: float, b: float) -> float:
        d = abs(a - b) % 360.0
        return min(d, 360.0 - d)

    lon = min(
        (_normalize_longitude(lon + k * 90.0) for k in range(4)),
        key=lambda c: lon_dist(c, ref_lon),
    )
    return GeographicPosition(latitude=lat, longitude=lon)
