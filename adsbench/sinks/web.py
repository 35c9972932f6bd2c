"""The web map's sink, as `adsb -m web` builds it, never served: a
WebDisplay whose tracker takes every packet (or, batched, every block)
and builds and broadcasts each summary as JSON. The sink handed to the
runner records what reaches the tracker and when each call returned."""

from __future__ import annotations

import time

perf_counter = time.perf_counter


class PacketSink:
    """A sink a packet: WebDisplay.on_packet."""

    def __init__(self, on_packet, recorder):
        self._on_packet = on_packet
        self._record = recorder.packet

    def __call__(self, packet) -> None:
        t = perf_counter()
        self._on_packet(packet)
        self._record(packet.packet, packet.time_processed, t, perf_counter())


class ExtendedBlockSink:
    """A sink a block in extended mode: the batched tracker behind
    WebDisplay.batched_sink(extended=True)."""

    def __init__(self, inner, recorder):
        self._inner = inner
        self._record = recorder.block

    def on_extended_block(self, out, now, cache, min_offset=None) -> int:
        t = perf_counter()
        n = self._inner.on_extended_block(out, now, cache, min_offset=min_offset)
        self._record(out, n, t, perf_counter())
        return n


def build(config: dict, recorder):
    """-> (the sink for run_stream, the display whose table is compared)."""
    from airjax_torch.ui.web import WebDisplay

    sink = config["sink"]
    extended = bool(config["decode"]["extended"])
    display = WebDisplay(quiet=True, extended_schema=bool(sink.get("extended_schema", False)))
    if sink["batched"]:
        if not extended:
            raise ValueError("a batched web sink is measured in extended mode only")
        return ExtendedBlockSink(display.batched_sink(extended=True), recorder), display
    return PacketSink(display.on_packet, recorder), display


def table(display) -> dict:
    """ICAO -> callsign, altitude, squawk, ground speed, track, vertical
    rate and position of the display's aircraft."""
    return {
        icao: {
            "callsign": a.callsign,
            "altitude": a.altitude,
            "squawk": a.squawk,
            "ground_speed_kt": a.ground_speed_kt,
            "track_deg": a.track_deg,
            "vertical_rate_fpm": a.vertical_rate_fpm,
            "position": None if a.geo_position is None else (a.geo_position.latitude, a.geo_position.longitude),
        }
        for icao, a in display.aircrafts.items()
    }
