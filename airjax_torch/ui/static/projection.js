// airjax geodesic projection — exact math parity with the reference
// frontend (adsb_frontend/src/position.ts:14-30 haversine
// distance, :38-49 bearing, :72-83 Center.get_xy azimuthal meters->pixels).
//
// Written in a disciplined JS subset (one `const`/`return` statement per
// `;`, only Math.* calls) so tests/test_projection.py can mechanically
// transpile this exact source to Python and execute it against the mirror
// in airjax/ui/projection.py — the JS math is tested without node.

"use strict";

// Haversine great-circle distance in meters (position.ts:14-30).
function geoDistance(lat1, lon1, lat2, lon2) {
  const R = 6371000;
  const rad = Math.PI / 180;
  const dLat = (lat2 - lat1) * rad;
  const dLon = (lon2 - lon1) * rad;
  const a = Math.sin(dLat / 2) ** 2 +
    Math.cos(lat1 * rad) * Math.cos(lat2 * rad) * Math.sin(dLon / 2) ** 2;
  const c = 2 * Math.atan2(Math.sqrt(a), Math.sqrt(1 - a));
  return R * c;
}

// Initial bearing from point 1 to point 2, radians (position.ts:38-49).
function geoBearing(lat1, lon1, lat2, lon2) {
  const rad = Math.PI / 180;
  const phi1 = lat1 * rad;
  const phi2 = lat2 * rad;
  const dLon = (lon2 - lon1) * rad;
  const y = Math.sin(dLon) * Math.cos(phi2);
  const x = Math.cos(phi1) * Math.sin(phi2) -
    Math.sin(phi1) * Math.cos(phi2) * Math.cos(dLon);
  return Math.atan2(y, x);
}

// Center.get_xy (position.ts:72-83): azimuthal distance+bearing projection
// to canvas pixels. North is up (dy negated), scalePpm is pixels per meter.
function getXY(centerLat, centerLon, centerX, centerY, scalePpm, lat, lon) {
  const distance = geoDistance(centerLat, centerLon, lat, lon);
  const bearing = geoBearing(centerLat, centerLon, lat, lon);
  const dx = distance * Math.sin(bearing);
  const dy = 0 - distance * Math.cos(bearing);
  const x = centerX + dx * scalePpm;
  const y = centerY + dy * scalePpm;
  return [x, y];
}

// Center.check_visible (position.ts:91-94): on-canvas test against a
// center pinned at (centerX, centerY) = (width/2, height/2).
function checkVisible(centerLat, centerLon, centerX, centerY, scalePpm, lat, lon) {
  const xy = getXY(centerLat, centerLon, centerX, centerY, scalePpm, lat, lon);
  const vx = (0 < xy[0]) && (xy[0] < centerX * 2);
  const vy = (0 < xy[1]) && (xy[1] < centerY * 2);
  return vx && vy;
}

// Center.recenter (position.ts:101-104).
function recenter(width, height) {
  const x = Math.floor(width / 2);
  const y = Math.floor(height / 2);
  return [x, y];
}
