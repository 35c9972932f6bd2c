"""Vectorized CPR global decode for mass-replay analytics and the batched
tracker (airjax/track/cpr_batch.py, carried over unchanged).

Decodes N (even, odd) frame pairs at once with the same f64 math — and the
same reference quirks — as the scalar path (airjax_torch.track.cpr, itself a
faithful port of src/adsb/cpr.rs:19-147): NL special cases, newest-frame
latitude selection, the NL(lat - 1 degree) odd-path quirk, and Rust fmod
semantics (np.fmod truncates toward zero, matching Rust's `%` on f64).

Runs on the host in numpy: CPR is a handful of transcendentals per
*position fix*, so it never belongs on the device, but bulk replays
(millions of archived pairs) want it vectorized. Fuzz-tested element-wise
against the scalar oracle in tests/test_cpr_batch.py; the port against
airjax in tests/test_torch_track.py.
"""

from __future__ import annotations

import numpy as np

from airjax_torch.track.cpr import NUM_ZONES, _CPR_SCALE

_NL_D1 = 1.0 - np.cos(np.pi / (2.0 * NUM_ZONES))
# The even and odd rows' latitude zone widths and zone counts:
# 360 / (4 * NUM_ZONES) and 360 / (4 * NUM_ZONES - 1); 60 and 59.
_DIV_EO = np.array([[360.0 / (4.0 * NUM_ZONES)], [360.0 / (4.0 * NUM_ZONES - 1.0)]])
_ZONES_EO = np.array([[60.0], [59.0]])


def calc_num_zones_batch(lat: np.ndarray) -> np.ndarray:
    """NL(lat) vectorized (quirk-exact vs airjax_torch.track.cpr.calc_num_zones)."""
    lat = np.asarray(lat, dtype=np.float64)
    cos2 = np.cos(np.pi / 180.0 * lat) ** 2
    # Guard the acos domain; out-of-domain inputs are overridden below.
    ratio = np.clip(1.0 - _NL_D1 / np.maximum(cos2, 1e-12), -1.0, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        nl = np.floor((2.0 * np.pi) / np.arccos(ratio), out=np.empty_like(lat))
    # The special cases written in place: numpy's where() with a scalar
    # costs more than the rest of the function on a block's few pairs.
    nl[~np.isfinite(nl)] = 1.0
    nl = nl.astype(np.int64)
    nl[lat == 0.0] = 59
    lat = np.abs(lat)
    nl[lat == 87.0] = 2
    nl[lat > 87.0] = 1
    return nl


def decode_pairs(
    even_lat: np.ndarray,
    even_lon: np.ndarray,
    odd_lat: np.ndarray,
    odd_lon: np.ndarray,
    newest_is_odd: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode N CPR pairs -> (latitude, longitude, valid).

    Args:
      even_lat/..: (N,) raw 17-bit CPR fields (int).
      newest_is_odd: (N,) bool — True when the odd frame is newer
        (equivalent to the scalar path's first == CprFormat.EVEN).
    Returns:
      (N,) f64 latitude, (N,) f64 longitude, (N,) bool valid (the even/odd
      NL consistency gate, src/adsb/cpr.rs:138-141). Invalid entries hold
      whatever the formulas produced — mask with `valid`.

    The even and odd halves of each step run as one (2, N) operation and
    NL as one evaluation over the four latitudes that need it: the same
    element-wise functions of the same values as one step per half, at a
    fraction of the fixed cost a numpy call has on a block's few pairs.
    """
    newest_is_odd = np.asarray(newest_is_odd, dtype=bool)
    # Rows: even, odd.
    lat_eo = np.array((even_lat, odd_lat), np.float64) / _CPR_SCALE
    lon_eo = np.array((even_lon, odd_lon), np.float64) / _CPR_SCALE
    lat_e, lat_o = lat_eo
    lon_e, lon_o = lon_eo

    j = np.floor(59.0 * lat_e - 60.0 * lat_o + 0.5)
    # even_div * (fmod(j, 60) + lat_e), odd_div * (fmod(j, 59) + lat_o)
    lat_eo = _DIV_EO * (np.fmod(j, _ZONES_EO) + lat_eo)

    latitude = np.where(newest_is_odd, lat_eo[1], lat_eo[0])
    latitude = np.where(latitude > 270.0, latitude - 360.0, latitude)

    nl_even, nl_odd, nl, nl_below = calc_num_zones_batch(
        np.concatenate((lat_eo.reshape(-1), latitude, latitude - 1.0))
    ).reshape(4, -1)
    valid = nl_even == nl_odd
    num_zones = np.where(
        newest_is_odd,
        np.maximum(nl_below, 1),
        np.maximum(nl, 1),
    ).astype(np.float64)

    divisions = 360.0 / num_zones
    m = np.floor(lon_e * (nl - 1) - lon_o * nl + 0.5)
    frac = np.where(newest_is_odd, lon_o, lon_e)
    longitude = divisions * (np.fmod(m, num_zones) + frac)
    # Normalize to (-180, 180] like the scalar while-loop (one wrap is
    # enough given |longitude| < 720 by construction).
    longitude = np.where(longitude > 180.0, longitude - 360.0, longitude)
    longitude = np.where(longitude < -180.0, longitude + 360.0, longitude)
    return latitude, longitude, valid
