"""Web display: HTTP + WebSocket broadcast of aircraft summaries
(airjax/ui/web.py, carried over unchanged; the frontend's static files
are this package's copy, airjax_torch/ui/static/).

Mirrors src/adsb/web.rs: serves a static frontend at `/`, a hello JSON at
`/api/data`, and a WebSocket at `/ws` that broadcasts each updated
aircraft's `AircraftSummary` as camelCase JSON (schema per
bindings/AircraftSummary.ts, so the reference's browser frontend could
connect to us unchanged). Implemented with the Python stdlib only: a
ThreadingHTTPServer whose /ws handler performs the RFC 6455 handshake by
hand and streams text frames.
"""

from __future__ import annotations

import base64
import hashlib
import json
import pathlib
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from airjax_torch.protocol.packet import AdsbPacket
from airjax_torch.track.aircraft import Aircraft

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_STATIC_DIR = pathlib.Path(__file__).parent / "static"


def _ws_frame_text(payload: bytes) -> bytes:
    """Build one unmasked server->client text frame."""
    n = len(payload)
    if n < 126:
        header = struct.pack("!BB", 0x81, n)
    elif n < 1 << 16:
        header = struct.pack("!BBH", 0x81, 126, n)
    else:
        header = struct.pack("!BBQ", 0x81, 127, n)
    return header + payload


class _Broadcast:
    """Fan-out of JSON strings to all connected WebSocket clients
    (the reference's tokio::sync::broadcast(100), web.rs:106)."""

    def __init__(self, depth: int = 100):
        self._clients: dict[int, queue.Queue] = {}
        self._lock = threading.Lock()
        self._next = 0
        self._depth = depth
        # Summaries sent (one a packet; batched, one a touched aircraft a
        # block), and those a lagging client's full queue dropped (one a
        # client): updates that client's map lost.
        self.sent = 0
        self.dropped = 0

    def subscribe(self) -> tuple[int, queue.Queue]:
        with self._lock:
            cid = self._next
            self._next += 1
            q: queue.Queue = queue.Queue(maxsize=self._depth)
            self._clients[cid] = q
            return cid, q

    def unsubscribe(self, cid: int) -> None:
        with self._lock:
            self._clients.pop(cid, None)

    def send(self, msg: str) -> None:
        with self._lock:
            clients = list(self._clients.values())
        self.sent += 1
        for q in clients:
            try:
                q.put_nowait(msg)
            except queue.Full:
                self.dropped += 1  # lagging client drops messages, like broadcast::Lagged


class WebDisplay:
    """Aircraft tracker + web server; `on_packet` is the pipeline sink."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        quiet: bool = False,
        extended_schema: bool = False,
        ref_position: tuple[float, float] | None = None,
        evict_after_s: float | None = None,
    ):
        self.host = host
        self.port = port
        self.quiet = quiet
        # Receiver (lat, lon); enables surface-position decode (extension).
        self.ref_position = ref_position
        # extended_schema adds velocity/squawk keys to the JSON (extended
        # decode mode); default stays bindings/AircraftSummary.ts-exact.
        self.extended_schema = extended_schema
        # Age-based eviction (extension; None = reference behavior: the
        # table grows without bound, src/adsb/aircraft.rs:158-165).
        # Checked at most once per second, not per packet.
        self.evict_after_s = evict_after_s
        self._last_evict = 0.0
        self.aircrafts: dict[int, Aircraft] = {}
        self.broadcast = _Broadcast()
        self._lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None

    # --- pipeline sink (web.rs:117-129) ---
    def on_packet(self, packet) -> None:
        from airjax_torch.extended import handle_extended_update

        with self._lock:
            handle_extended_update(packet, self.aircrafts, self.ref_position)
            summary = (
                self.aircrafts[packet.icao]
                .get_summary()
                .to_json(extended=self.extended_schema)
            )
            if self.evict_after_s is not None:
                import time as _time

                now = _time.time()
                if now - self._last_evict >= 1.0:
                    from airjax_torch.track.aircraft import evict_stale

                    evict_stale(self.aircrafts, self.evict_after_s, now=now)
                    self._last_evict = now
        msg = json.dumps(summary)
        if not self.quiet:
            print(f"Broadcasting aircraft summary: {msg}")
        self.broadcast.send(msg)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                a.get_summary().to_json(extended=self.extended_schema)
                for a in self.aircrafts.values()
            ]

    # --- batched pipeline sink (extension; opt-in via `adsb --batched`) ---
    def batched_sink(self, extended: bool = False):
        """High-throughput sink: tracker updates run through the batched
        block path (airjax_torch.track.batch) against THIS display's
        aircraft table, and the WS broadcast coalesces to ONE summary per
        touched aircraft per decode block. The reference broadcasts one
        summary per packet (web.rs:117-129) — that granularity stays the
        default for parity. Clients (app.js ingest keyed by ICAO) are
        granularity-agnostic."""
        from airjax_torch.track.batch import build_batched_sink

        sink, tracker = build_batched_sink(
            self.aircrafts, self._lock, extended=extended,
            evict_after_s=self.evict_after_s, ref_position=self.ref_position,
        )
        display = self

        def broadcast_applied(icaos):
            # Called by the tracker with display._lock ALREADY HELD (the
            # locked sink takes it around every update), so no locking
            # here; the broadcast fan-out has its own lock.
            for icao in sorted(icaos):
                a = display.aircrafts.get(icao)
                if a is None:
                    continue  # evicted within the same block
                display.broadcast.send(
                    json.dumps(a.get_summary().to_json(extended=display.extended_schema))
                )

        tracker.on_applied = broadcast_applied
        return sink

    # --- server ---
    def serve_forever(self) -> None:
        display = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/ws":
                    self._handle_ws()
                elif self.path == "/api/data":
                    body = json.dumps(
                        {"id": 123, "message": "Hello from airjax backend!"}
                    ).encode()
                    self._send_body(body, "application/json")
                elif self.path == "/api/aircraft":
                    # Extension: current full state for late-joining clients.
                    self._send_body(
                        json.dumps(display.snapshot()).encode(), "application/json"
                    )
                else:
                    self._serve_static()

            def _send_body(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve_static(self):
                rel = self.path.lstrip("/") or "index.html"
                target = (_STATIC_DIR / rel).resolve()
                # Path.is_relative_to, NOT str.startswith: the latter
                # would also match sibling dirs like `static_secret/`.
                if not target.is_relative_to(_STATIC_DIR.resolve()) or not target.is_file():
                    self.send_error(404)
                    return
                ctype = {
                    ".html": "text/html",
                    ".js": "text/javascript",
                    ".css": "text/css",
                    ".csv": "text/csv",
                }.get(target.suffix, "application/octet-stream")
                self._send_body(target.read_bytes(), ctype)

            def _handle_ws(self):
                key = self.headers.get("Sec-WebSocket-Key")
                if not key:
                    self.send_error(400, "not a websocket request")
                    return
                accept = base64.b64encode(
                    hashlib.sha1((key + _WS_GUID).encode()).digest()
                ).decode()
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept)
                self.end_headers()
                self.close_connection = True

                cid, q = display.broadcast.subscribe()
                sock = self.connection
                sock.settimeout(0.5)
                try:
                    # Late joiners get the current picture immediately.
                    for summary in display.snapshot():
                        sock.sendall(
                            _ws_frame_text(json.dumps(summary).encode())
                        )
                    while True:
                        try:
                            msg = q.get(timeout=0.5)
                        except queue.Empty:
                            continue
                        sock.sendall(_ws_frame_text(msg.encode()))
                except OSError:
                    pass
                finally:
                    display.broadcast.unsubscribe(cid)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        print(f"Listening on http://{self.host}:{self.port}")
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
