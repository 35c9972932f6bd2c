"""Geodesic projection math — the Python twin of the port's frontend
projection (airjax/ui/projection.py).

It replicates the reference frontend's geometry (the reference's
adsb_frontend/src/position.ts):

- :14-30  ``Position.get_distance`` — haversine great-circle distance (m)
- :38-49  ``Position.get_bearing``  — initial bearing (radians)
- :72-83  ``Center.get_xy``         — azimuthal meters->pixels projection

``airjax_torch/ui/static/projection.js`` carries the same functions for
the browser; tests/test_torch_frontend.py transpiles that JS source to
Python (tests/js_subset.py) and holds it, and this module, to airjax's
mirror over a grid of inputs, so the shipped JS math is executed without
node.
"""

from __future__ import annotations

import math

EARTH_RADIUS_M = 6371000.0


def geo_distance(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Haversine distance in meters (position.ts:14-30)."""
    rad = math.pi / 180.0
    d_lat = (lat2 - lat1) * rad
    d_lon = (lon2 - lon1) * rad
    a = (
        math.sin(d_lat / 2.0) ** 2
        + math.cos(lat1 * rad) * math.cos(lat2 * rad) * math.sin(d_lon / 2.0) ** 2
    )
    c = 2.0 * math.atan2(math.sqrt(a), math.sqrt(1.0 - a))
    return EARTH_RADIUS_M * c


def geo_bearing(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Initial bearing from point 1 to point 2 in radians (position.ts:38-49)."""
    rad = math.pi / 180.0
    phi1 = lat1 * rad
    phi2 = lat2 * rad
    d_lon = (lon2 - lon1) * rad
    y = math.sin(d_lon) * math.cos(phi2)
    x = math.cos(phi1) * math.sin(phi2) - math.sin(phi1) * math.cos(phi2) * math.cos(d_lon)
    return math.atan2(y, x)


def get_xy(
    center_lat: float,
    center_lon: float,
    center_x: float,
    center_y: float,
    scale_ppm: float,
    lat: float,
    lon: float,
) -> tuple[float, float]:
    """Center.get_xy (position.ts:72-83): position -> canvas pixel coords.

    ``scale_ppm`` is pixels per meter; dy is negated so north is up.
    """
    distance = geo_distance(center_lat, center_lon, lat, lon)
    bearing = geo_bearing(center_lat, center_lon, lat, lon)
    dx = distance * math.sin(bearing)
    dy = -distance * math.cos(bearing)
    return (center_x + dx * scale_ppm, center_y + dy * scale_ppm)


def check_visible(
    center_lat: float,
    center_lon: float,
    center_x: float,
    center_y: float,
    scale_ppm: float,
    lat: float,
    lon: float,
) -> bool:
    """Center.check_visible (position.ts:91-94): canvas-bounds test with
    the center pinned at (center_x, center_y) = (width/2, height/2)."""
    x, y = get_xy(center_lat, center_lon, center_x, center_y, scale_ppm, lat, lon)
    return (0 < x < center_x * 2) and (0 < y < center_y * 2)


def recenter(width: float, height: float) -> tuple[int, int]:
    """Center.recenter (position.ts:101-104)."""
    return (math.floor(width / 2), math.floor(height / 2))
