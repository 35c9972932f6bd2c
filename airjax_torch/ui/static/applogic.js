// airjax frontend logic — the pure (DOM-free) part of app.js.
//
// Written in the same disciplined JS subset as projection.js so the test
// suite can EXECUTE it without node (tests/js_subset.py transpiles it to
// Python and runs it against golden inputs — tests/test_applogic.py).
// Reference behaviors covered: auto-scale to the furthest aircraft
// (main.ts:264-277), 8 px sprite hit-test (aircraft.ts:131-145),
// click-to-expand toggle (main.ts:234-243), the no-position table
// selection (main.ts:64-137), and range-ring layout.
//
// Conventions (transpiler contract): function/const/let/if/else and
// counting for-loops only; one statement per line or a braced single-line
// if; arrays + Math.* only; no ternaries, template literals, Maps,
// arrows, or method definitions. Missing values are encoded as -1.

"use strict";

// Scale (px per meter) so the furthest aircraft stays at 42% of the
// smaller canvas dimension; 1000 m floor stops a lone overhead aircraft
// from zooming to infinity. No aircraft: 0.002 px/m fallback.
function autoScale(centerLat, centerLon, lats, lons, w, h, dpr) {
  if (lats.length === 0) { return 0.002 * dpr; }
  let rmax = 1000;
  for (let i = 0; i < lats.length; i += 1) {
    const xy = getXY(centerLat, centerLon, 0, 0, 1, lats[i], lons[i]);
    const r = Math.hypot(xy[0], xy[1]);
    if (r > rmax) { rmax = r; }
  }
  return (0.42 * Math.min(w, h)) / rmax;
}

// Projected meters -> screen px (canvas center = radar center).
function toScreen(px, py, scale, w, h) {
  return [w / 2 + px * scale, h / 2 + py * scale];
}

// First sprite within 8 device px of the mouse; -1 = no hit.
function hitTestArrays(xs, ys, mx, my, dpr) {
  const r = 8 * dpr;
  for (let i = 0; i < xs.length; i += 1) {
    if (Math.hypot(xs[i] - mx, ys[i] - my) <= r) { return i; }
  }
  return -1;
}

// Click toggles the pinned aircraft: clicking the already-selected one
// (or empty space) unpins. -1 encodes "none".
function clickSelect(hit, selected) {
  if (hit === selected) { return -1; }
  return hit;
}

// Range rings (km) that fit: stop at the first ring beyond the canvas
// diagonal, so offscreen rings are never drawn.
function visibleRingsKm(scale, w, h) {
  const kms = [10, 25, 50, 100, 200];
  const out = [];
  for (let i = 0; i < kms.length; i += 1) {
    const r = kms[i] * 1000 * scale;
    if (r > Math.hypot(w, h)) { return out; }
    out.push(kms[i]);
  }
  return out;
}

// Indices of aircraft for the "no position yet" side table.
function noPositionIndices(hasGeo) {
  const out = [];
  for (let i = 0; i < hasGeo.length; i += 1) {
    if (hasGeo[i] === 0) { out.push(i); }
  }
  return out;
}

// Is a projected point on the canvas (airfield marker culling)?
function onScreen(x, y, w, h) {
  if (x < 0) { return 0; }
  if (y < 0) { return 0; }
  if (x > w) { return 0; }
  if (y > h) { return 0; }
  return 1;
}

// Sprite freshness: aircraft heard <15 s ago draw bright.
function isFresh(now, seen) {
  if (now - seen < 15) { return 1; }
  return 0;
}

// Measured-text line layout (the reference's get_text_height helper,
// utils.ts:9-11, and the padding + text_height line advance its call
// sites use, main.ts:43-52 / aircraft.ts:90-93). Ascent/descent < 0
// encode "metrics unavailable" (old canvas): fall back to the fixed
// 16 px rows this app used before the helper existed.
function textHeight(ascent, descent) {
  if (ascent < 0) { return -1; }
  if (descent < 0) { return -1; }
  return ascent + descent;
}

function lineAdvance(ascent, descent, pad, dpr) {
  const th = textHeight(ascent, descent);
  // Positive-gate rather than th <= 0: NaN metrics (one bounding box
  // defined, the other undefined) must also fall back to fixed rows.
  if (th > 0) { return pad + th; }
  return 16 * dpr;
}

// Panel height: 2*pad margins + one advance per line (aircraft.ts:93).
function panelHeight(ascent, descent, pad, nLines, dpr) {
  return 2 * pad + lineAdvance(ascent, descent, pad, dpr) * nLines;
}
