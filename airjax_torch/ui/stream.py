"""Stream sinks: print each decoded packet (src/adsb.rs:154-160) with the
reference's Display, append it as a JSON line, or both. Carried over
unchanged from airjax/ui/stream.py:10-97 (tests/test_torch_packet.py
holds the two byte for byte)."""

from __future__ import annotations

import sys

from airjax_torch.protocol.packet import AdsbPacket


def stream_printer(out=None):
    out = out or sys.stdout

    def on_packet(packet: AdsbPacket) -> None:
        # Reference: print!("\n{}\n", packet) — Display ends with a newline.
        out.write(f"\n{packet.format()}\n")
        out.flush()

    return on_packet


def jsonl_writer(path: str):
    """Structured decoded-message sink: one JSON object per packet.

    The reference's only persistence is raw .c16 capture; this adds the
    decoded-side checkpoint (SURVEY §5): replayable, greppable, and enough
    to rebuild the aircraft table.
    """
    import json

    f = open(path, "a", buffering=1)

    def on_packet(packet) -> None:
        if not isinstance(packet, AdsbPacket):
            # Extension frames (DF11 / DF4/5/20/21) have their own shape.
            record = {"icao": f"{packet.icao:06x}", "time": packet.time_processed}
            for attr in (
                "capability", "df", "flight_status", "altitude_ft",
                "squawk", "ke", "nd",
            ):
                if getattr(packet, attr, None) is not None:
                    record[attr] = getattr(packet, attr)
            md = getattr(packet, "md", None)
            if md is not None:
                record["md"] = md.hex()
            f.write(json.dumps(record) + "\n")
            return
        record = {
            "hex": packet.packet.hex(),
            "df": packet.downlink_format,
            "capability": packet.capability,
            "icao": f"{packet.icao:06x}",
            "tc": packet.msg_type,
            "time": packet.time_processed,
        }
        msg = packet.msg
        if hasattr(msg, "callsign"):
            record["callsign"] = msg.callsign
        if hasattr(msg, "altitude"):
            record.update(
                altitude_ft=msg.altitude,
                cpr_format=msg.cpr_format.name.lower(),
                cpr_lat=msg.cpr_latitude,
                cpr_lon=msg.cpr_longitude,
            )
        elif hasattr(msg, "movement_kt"):  # TC5-8 surface position (ext.)
            record.update(
                movement_kt=msg.movement_kt,
                track_deg=msg.track_deg,
                cpr_format=msg.cpr_format.name.lower(),
                cpr_lat=msg.cpr_latitude,
                cpr_lon=msg.cpr_longitude,
            )
        if hasattr(msg, "vertical_rate_fpm"):  # TC19 velocity (ext.)
            record.update(
                ground_speed_kt=msg.ground_speed_kt,
                track_deg=msg.track_deg,
                heading_deg=msg.heading_deg,
                airspeed_kt=msg.airspeed_kt,
                vertical_rate_fpm=msg.vertical_rate_fpm,
            )
        if hasattr(msg, "emergency_state") and msg.emergency_state is not None:
            record.update(emergency=msg.emergency_state, squawk=msg.squawk)
        if hasattr(msg, "adsb_version"):
            record["adsb_version"] = msg.adsb_version
        f.write(json.dumps(record) + "\n")

    return on_packet


def tee(*sinks):
    """Fan one packet stream into several sinks."""

    def on_packet(packet: AdsbPacket) -> None:
        for sink in sinks:
            sink(packet)

    return on_packet
