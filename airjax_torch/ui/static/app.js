// airjax live aircraft display — plain-JS canvas client.
// Consumes the same WebSocket JSON schema as the reference frontend
// (AircraftSummary: {icao, callsign, altitude, geoPosition, lastContact}).
// Pure logic (auto-scale, hit-test, selection, ring/table layout) lives in
// applogic.js, which the test suite executes without node
// (tests/test_applogic.py); this file is the DOM/canvas/WS glue.

"use strict";

const DEMO_MODE = new URLSearchParams(location.search).has("demo");

const canvas = document.getElementById("radar");
const ctx = canvas.getContext("2d");
const aircraft = new Map(); // icao -> summary
const airfields = []; // {icao, lat, lon, name}
let packets = 0;
let center = null; // {lat, lon}

function resize() {
  canvas.width = window.innerWidth * devicePixelRatio;
  canvas.height = window.innerHeight * devicePixelRatio;
}
window.addEventListener("resize", resize);
resize();

// Hover + click-to-expand (hit-test radius 8 px, like the reference
// sprite, aircraft.ts:131-145). -1 encodes "none" (applogic.js contract).
let mouse = { x: -1, y: -1 };
let selected = -1; // icao pinned by click, -1 = none
const screenPos = { icaos: [], xs: [], ys: [] }; // last draw's sprites
canvas.addEventListener("mousemove", (ev) => {
  mouse = { x: ev.offsetX * devicePixelRatio, y: ev.offsetY * devicePixelRatio };
});
canvas.addEventListener("click", () => {
  selected = clickSelect(hitIcao(), selected);
});
function hitIcao() {
  const i = hitTestArrays(screenPos.xs, screenPos.ys, mouse.x, mouse.y, devicePixelRatio);
  return i === -1 ? -1 : screenPos.icaos[i];
}

function ingest(summary) {
  packets += 1;
  aircraft.set(summary.icao, { ...summary, seen: Date.now() / 1000 });
  if (!center && summary.geoPosition) {
    center = { lat: summary.geoPosition.latitude, lon: summary.geoPosition.longitude };
  }
}

function connect() {
  const ws = new WebSocket(`ws://${location.host}/ws`);
  ws.onmessage = (ev) => ingest(JSON.parse(ev.data));
  ws.onclose = () => setTimeout(connect, 2000);
}

// Demo mode (?demo): four synthetic Wellington-area aircraft with
// per-second jitter — no backend needed.
function startDemo() {
  const base = { lat: -41.3272, lon: 174.8053 };
  const demo = [
    { icao: 0xc80001, callsign: "DEMO101_", altitude: 12000, dlat: 0.12, dlon: 0.2 },
    { icao: 0xc80002, callsign: "DEMO202_", altitude: 24000, dlat: -0.25, dlon: 0.1 },
    { icao: 0xc80003, callsign: "DEMO303_", altitude: 6000, dlat: 0.05, dlon: -0.3 },
    { icao: 0xc80004, callsign: "DEMO404_", altitude: 36000, dlat: -0.1, dlon: -0.15 },
  ];
  setInterval(() => {
    for (const d of demo) {
      d.dlat += (Math.random() - 0.5) * 0.004;
      d.dlon += (Math.random() - 0.5) * 0.004;
      ingest({
        icao: d.icao,
        callsign: d.callsign,
        altitude: d.altitude,
        geoPosition: { latitude: base.lat + d.dlat, longitude: base.lon + d.dlon },
        lastContact: Math.floor(Date.now() / 1000),
      });
    }
  }, 1000);
}

fetch("airfields.csv")
  .then((r) => r.text())
  .then((text) => {
    for (const line of text.trim().split("\n").slice(1)) {
      const [icao, lat, lon, name] = line.split(",");
      airfields.push({ icao, lat: parseFloat(lat), lon: parseFloat(lon), name });
    }
  })
  .catch(() => {});

if (DEMO_MODE) startDemo();
else connect();

// Azimuthal haversine-distance + bearing projection, math-identical to the
// reference frontend (position.ts Center.get_xy); functions in projection.js.
function project(lat, lon) {
  const xy = getXY(center.lat, center.lon, 0, 0, 1, lat, lon);
  return { x: xy[0], y: xy[1] };
}

function draw() {
  const w = canvas.width, h = canvas.height;
  ctx.clearRect(0, 0, w, h);
  ctx.fillStyle = "#0b1020";
  ctx.fillRect(0, 0, w, h);

  const all = [...aircraft.values()];
  const withPos = all.filter((a) => a.geoPosition);

  // Scale so the furthest aircraft stays on screen (main.ts:264-277).
  const scale = center
    ? autoScale(
        center.lat, center.lon,
        withPos.map((a) => a.geoPosition.latitude),
        withPos.map((a) => a.geoPosition.longitude),
        w, h, devicePixelRatio)
    : 0.002 * devicePixelRatio;

  // Range rings.
  if (center) {
    ctx.strokeStyle = "#1d2b50";
    ctx.fillStyle = "#5a6c9e";
    ctx.font = `${12 * devicePixelRatio}px monospace`;
    for (const km of visibleRingsKm(scale, w, h)) {
      const r = km * 1000 * scale;
      ctx.beginPath();
      ctx.arc(w / 2, h / 2, r, 0, 2 * Math.PI);
      ctx.stroke();
      ctx.fillText(`${km} km`, w / 2 + r * 0.707, h / 2 - r * 0.707);
    }
  }

  // 1 km scale bar, bottom-left (reference main.ts:279-284 draw_scale).
  if (center) {
    ctx.strokeStyle = "#9fb4ea";
    ctx.beginPath();
    ctx.moveTo(25, h - 25);
    ctx.lineTo(25 + scale * 1000, h - 25);
    ctx.stroke();
    ctx.fillStyle = "#9fb4ea";
    ctx.font = `${12 * devicePixelRatio}px monospace`;
    ctx.fillText("1 km", 25, h - 32);
  }

  // Airfield overlay (yellow markers, like the reference's NZ airports).
  if (center) {
    ctx.font = `${11 * devicePixelRatio}px monospace`;
    for (const f of airfields) {
      const p = project(f.lat, f.lon);
      const [x, y] = toScreen(p.x, p.y, scale, w, h);
      if (!onScreen(x, y, w, h)) continue;
      ctx.fillStyle = "#e8c34a";
      ctx.fillRect(x - 3, y - 3, 6, 6);
      ctx.fillText(f.icao, x + 6, y + 4);
    }
  }

  // Aircraft.
  ctx.font = `${12 * devicePixelRatio}px monospace`;
  screenPos.icaos = [];
  screenPos.xs = [];
  screenPos.ys = [];
  for (const a of withPos) {
    if (!center) continue;
    const p = project(a.geoPosition.latitude, a.geoPosition.longitude);
    const [x, y] = toScreen(p.x, p.y, scale, w, h);
    screenPos.icaos.push(a.icao);
    screenPos.xs.push(x);
    screenPos.ys.push(y);
  }
  // Reference utils.ts:9-11: measured text height off the canvas.
  function getTextMetrics(sample) {
    const m = ctx.measureText(sample);
    if (m.actualBoundingBoxAscent == null || m.actualBoundingBoxDescent == null)
      return [-1, -1];
    return [m.actualBoundingBoxAscent, m.actualBoundingBoxDescent];
  }
  const hoverIcao = hitIcao();
  for (let i = 0; i < screenPos.icaos.length; i += 1) {
    const a = aircraft.get(screenPos.icaos[i]);
    const x = screenPos.xs[i], y = screenPos.ys[i];
    ctx.fillStyle = isFresh(Date.now() / 1000, a.seen) ? "#ffd75a" : "#7a6a30";
    ctx.beginPath();
    ctx.arc(x, y, 4 * devicePixelRatio, 0, 2 * Math.PI);
    ctx.fill();
    ctx.strokeStyle = "#39508c";
    ctx.beginPath();
    ctx.moveTo(x + 5, y - 5);
    ctx.lineTo(x + 18, y - 18);
    ctx.stroke();
    ctx.fillStyle = "#dfe7ff";
    const label = `${a.callsign || a.icao.toString(16)} ${a.altitude}ft`;
    ctx.fillText(label, x + 20, y - 20);

    // Expanded panel on hover or click.
    if (a.icao === hoverIcao || a.icao === selected) {
      const lines = [
        `icao     ${a.icao.toString(16).padStart(6, "0")}`,
        `callsign ${a.callsign || "-"}`,
        `altitude ${a.altitude} ft`,
        `lat      ${a.geoPosition.latitude.toFixed(6)}`,
        `lon      ${a.geoPosition.longitude.toFixed(6)}`,
        `contact  ${new Date(a.lastContact * 1000).toLocaleTimeString()}`,
      ];
      // Extended-schema keys (backend --extended mode); absent otherwise.
      if (a.groundSpeedKt != null) {
        lines.push(`speed    ${a.groundSpeedKt.toFixed(0)} kt @ ${
          a.trackDeg != null ? a.trackDeg.toFixed(0) : "-"}°`);
      }
      if (a.verticalRateFpm != null) lines.push(`v/s      ${a.verticalRateFpm} fpm`);
      if (a.squawk != null) lines.push(`squawk   ${String(a.squawk).padStart(4, "0")}`);
      if (a.onGround) lines.push("status   on ground");
      if (a.acasRa) lines.push(`TCAS RA  ${a.acasRa}`);
      if (a.bdsCandidates && a.bdsCandidates.length > 1) {
        lines.push(`BDS?     ${a.bdsCandidates.join("/")} (ambiguous)`);
      }
      if (a.met && a.met.wind_speed_kt != null) {
        lines.push(`wind     ${a.met.wind_speed_kt} kt @ ${
          a.met.wind_dir_deg != null ? a.met.wind_dir_deg.toFixed(0) : "-"}°`);
      }
      if (a.met && a.met.static_air_temp_c != null) {
        lines.push(`SAT      ${a.met.static_air_temp_c} °C`);
      }
      if (a.commdElm) {
        const tag = a.commdElm.bds.length
          ? a.commdElm.bds.join("/")
          : "raw";
        lines.push(`ELM      ${a.commdElm.segments} seg ${tag} ${
          a.commdElm.hex.slice(0, 16)}${a.commdElm.hex.length > 16 ? "…" : ""}`);
      }
      const pw = 210 * devicePixelRatio;
      const [asc, desc] = getTextMetrics(lines[0]);
      const pad = 4 * devicePixelRatio;
      const adv = lineAdvance(asc, desc, pad, devicePixelRatio);
      const ph = panelHeight(asc, desc, pad, lines.length, devicePixelRatio);
      ctx.fillStyle = "rgba(16,26,56,0.95)";
      ctx.fillRect(x + 22, y - 10, pw, ph);
      ctx.strokeStyle = "#39508c";
      ctx.strokeRect(x + 22, y - 10, pw, ph);
      ctx.fillStyle = "#dfe7ff";
      lines.forEach((l, i2) => ctx.fillText(l, x + 30, y + 8 + adv * i2));
    }
  }

  // Stats box + table of aircraft without positions (main.ts:64-137);
  // cell height measured per main.ts:87's get_text_height usage.
  const [tAsc, tDesc] = getTextMetrics("0");
  const cellH = lineAdvance(tAsc, tDesc, 4 * devicePixelRatio, devicePixelRatio);
  ctx.fillStyle = "#101a38";
  ctx.fillRect(8, 8, 330 * devicePixelRatio, 48 + cellH * aircraft.size);
  ctx.fillStyle = "#9fb4ea";
  let ty = 26;
  ctx.fillText(`aircraft: ${aircraft.size}  msgs: ${packets}`, 16, ty);
  ty += 20;
  for (const i of noPositionIndices(all.map((a) => (a.geoPosition ? 1 : 0)))) {
    const a = all[i];
    ctx.fillText(
      `${a.icao.toString(16).padStart(6, "0")} ${a.callsign || "-"} ${a.altitude}ft (no pos)`,
      16, ty);
    ty += cellH;
  }

  requestAnimationFrame(draw);
}
requestAnimationFrame(draw);
