"""Terminal UI: live aircraft table (mirrors src/adsb/tui.rs;
airjax/ui/tui.py, carried over unchanged).

Same columns and behavior as the reference ratatui table — ICAO, Callsign,
Altitude, Latitude, Longitude, Velocity (n/a), Age — sorted by age, packet
counter in the title, q/Esc/Ctrl-C to quit — implemented with stdlib
curses. Packets are drained from a thread-safe queue each frame
(the reference drains its mpsc non-blocking per frame, tui.rs:40-43).
"""

from __future__ import annotations

import curses
import queue
import threading
import time

from airjax_torch.protocol.packet import AdsbPacket
from airjax_torch.track.aircraft import Aircraft

HEADER = ["ICAO", "Callsign", "Altitude", "Latitude", "Longitude", "Velocity", "Age"]
WIDTHS = [8, 11, 11, 12, 12, 10, 6]


class TuiApp:
    def __init__(
        self,
        ref_position: tuple[float, float] | None = None,
        evict_after_s: float | None = None,
    ):
        self.aircrafts: dict[int, Aircraft] = {}
        self.num_packets = 0
        self.queue: "queue.Queue[AdsbPacket]" = queue.Queue()
        # Receiver (lat, lon); enables surface-position decode (extension).
        self.ref_position = ref_position
        # Age-based eviction (extension; None = reference behavior: the
        # table grows without bound, src/adsb/aircraft.rs:158-165).
        self.evict_after_s = evict_after_s
        # Held by the render loop around table reads; the batched sink
        # (if used) mutates the shared aircraft table under it. The
        # default per-packet path needs no lock (queue handoff).
        self._lock = threading.Lock()

    def on_packet(self, packet: AdsbPacket) -> None:
        """Sink callable — safe to call from the decode thread."""
        self.queue.put(packet)

    def batched_sink(self, extended: bool = False):
        """Batched decode sink sharing this app's aircraft table (CLI
        `--batched` in interactive mode): block updates apply on the
        decode thread under the render lock instead of queuing one
        packet at a time; the title's packet counter follows the
        tracker's message count."""
        from airjax_torch.track.batch import build_batched_sink

        sink, tracker = build_batched_sink(
            self.aircrafts, self._lock, extended=extended,
            evict_after_s=self.evict_after_s, ref_position=self.ref_position,
        )
        app = self

        def applied(_icaos):
            app.num_packets = tracker.n_messages

        tracker.on_applied = applied
        return sink

    def _drain(self):
        while True:
            try:
                packet = self.queue.get_nowait()
            except queue.Empty:
                break
            self.num_packets += 1
            from airjax_torch.extended import handle_extended_update

            handle_extended_update(packet, self.aircrafts, self.ref_position)
        if self.evict_after_s is not None:
            from airjax_torch.track.aircraft import evict_stale

            evict_stale(self.aircrafts, self.evict_after_s)

    def _rows(self):
        planes = sorted(self.aircrafts.values(), key=lambda a: a.get_age())
        for plane in planes:
            pos = plane.geo_position
            # Velocity fills in only when a TC19 message has been decoded
            # (extended mode); otherwise "n/a" like the reference's
            # hardwired column (src/adsb/tui.rs:77).
            vel = plane.ground_speed_kt
            yield [
                f"{plane.icao:x}",
                plane.get_callsign(),
                str(plane.altitude),
                f"{pos.latitude:.6f}" if pos else "n/a",
                f"{pos.longitude:.6f}" if pos else "n/a",
                f"{vel:.0f} kt" if vel is not None else "n/a",
                str(plane.get_age()),
            ]

    def run(self, stdscr) -> None:
        curses.curs_set(0)
        stdscr.nodelay(True)
        running = True
        while running:
            with self._lock:
                self._drain()
                rows = list(self._rows())
            stdscr.erase()
            maxy, maxx = stdscr.getmaxyx()
            title = f" airjax adsb tracker {self.num_packets} "
            stdscr.addnstr(0, max(0, (maxx - len(title)) // 2), title, maxx - 1, curses.A_BOLD)
            line = "".join(h.ljust(w) for h, w in zip(HEADER, WIDTHS))
            stdscr.addnstr(1, 0, line, maxx - 1, curses.A_BOLD)
            for i, row in enumerate(rows):
                if i + 2 >= maxy:
                    break
                stdscr.addnstr(
                    i + 2, 0, "".join(c.ljust(w) for c, w in zip(row, WIDTHS)), maxx - 1
                )
            stdscr.refresh()
            t0 = time.time()
            while time.time() - t0 < 0.1:
                ch = stdscr.getch()
                if ch in (ord("q"), 27, 3):  # q, Esc, Ctrl-C
                    running = False
                    break
                time.sleep(0.01)


def interactive_display(app: TuiApp) -> None:
    curses.wrapper(app.run)
