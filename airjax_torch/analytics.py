"""Mass-replay analytics: a whole capture decoded into per-aircraft tracks
(airjax/analytics.py).

`analyze_capture` decodes the capture (pipeline.decode_capture_overlap, or
with devices=N parallel/halo.decode_capture_sharded over an N-device mesh),
takes every protocol field of every hit in one kernels/fields.py::
block_fields launch, pairs each position message with the newest earlier
one of the other parity within 10 s on the host, and decodes all pairs at
once (track/cpr_batch.decode_pairs): a flight-track table, not only the
final state. `analyze_capture_extended` decodes every downlink format
through parallel/halo.decode_capture_sharded_extended (a one-device mesh
decodes the capture as one extended block) and replays the packets
through the live tracker (extended.handle_extended_update), recording
fixes, velocities, squawks and altitudes as they change.

Time is counted in sample offsets: at 2 MS/s the reference's 10 s CPR
window is 20 M samples. `device` is where the decode runs ("cuda" or
"cpu"); a mesh of N devices is make_mesh(N, device=device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.kernels.fields import block_fields
from airjax_torch.pipeline import decode_capture_overlap, to_host
from airjax_torch.protocol.fields import MSG_AIRCRAFT_ID, MSG_AIRCRAFT_POSITION, callsign_to_str

SAMPLE_RATE = 2_000_000.0
CPR_WINDOW_SAMPLES = int(10.0 * SAMPLE_RATE)  # aircraft.rs:68, in samples


@dataclasses.dataclass
class Fix:
    offset: int  # global sample offset of the newest frame of the pair
    latitude: float
    longitude: float
    altitude_ft: int


@dataclasses.dataclass
class Track:
    icao: int
    callsign: str | None
    n_messages: int
    altitudes: list[tuple[int, int]]  # (offset, altitude_ft)
    fixes: list[Fix]


def analyze_capture(
    iq: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG, devices: int | None = None, *,
    device: torch.device | str = "cuda",
) -> tuple[dict[int, Track], dict]:
    """A capture -> ({icao: Track}, stats) (airjax/analytics.py:55-152).
    Positions follow the online tracker's pairing rule (the other parity
    within 10 s, the newest frame choosing the formulas), so a fix is what
    the live tracker showed at that offset. devices=N decodes over the
    halo-sharded mesh: the same hits, N devices."""
    if devices is not None:
        from airjax_torch.parallel.halo import decode_capture_sharded
        from airjax_torch.parallel.mesh import make_mesh

        hits, stats = decode_capture_sharded(iq, make_mesh(devices, device=device),
                                             capacity_per_shard=cfg.max_candidates)
    else:
        hits, stats = decode_capture_overlap(iq, cfg, device=device)
    if not hits:
        return {}, {**stats, "n_aircraft": 0, "n_fixes": 0}

    offsets = np.array([g for _, g, _, _ in hits], dtype=np.int64)
    frames = np.frombuffer(bytearray(b"".join(f for _, _, f, _ in hits)), dtype=np.uint8).reshape(len(hits), 14)

    # One launch decodes every field of every frame.
    f = to_host(block_fields(torch.as_tensor(frames).to(device))[0])
    icao = f["icao"].astype(np.int64)
    msg_class = f["msg_class"]
    cpr_odd = f["cpr_odd"].astype(bool)
    cpr_lat = f["cpr_lat"].astype(np.int64)
    cpr_lon = f["cpr_lon"].astype(np.int64)
    altitude = f["altitude_ft"]

    tracks: dict[int, Track] = {}
    for a in np.unique(icao):
        tracks[int(a)] = Track(icao=int(a), callsign=None, n_messages=0, altitudes=[], fixes=[])
    for a, c in zip(*np.unique(icao, return_counts=True)):
        tracks[int(a)].n_messages = int(c)

    # Callsigns: the last ID message of an aircraft wins (tracker semantics).
    for k in np.nonzero(msg_class == MSG_AIRCRAFT_ID)[0]:
        tracks[int(icao[k])].callsign = callsign_to_str(f["callsign_codes"][k])

    # CPR pairing: each position message with the newest earlier position
    # message of the same aircraft and the other parity.
    pos_idx = np.nonzero(msg_class == MSG_AIRCRAFT_POSITION)[0]
    for k in pos_idx:
        tracks[int(icao[k])].altitudes.append((int(offsets[k]), int(altitude[k])))

    pairs = []  # (even_lat, even_lon, odd_lat, odd_lon, newest_odd, k)
    by_aircraft: dict[int, list[int]] = {}
    for k in pos_idx:
        by_aircraft.setdefault(int(icao[k]), []).append(int(k))
    for ks in by_aircraft.values():
        last: dict[bool, int] = {}
        for k in sorted(ks, key=lambda k: offsets[k]):
            parity = bool(cpr_odd[k])
            other = last.get(not parity)
            if other is not None and offsets[k] - offsets[other] <= CPR_WINDOW_SAMPLES:
                e, o = (other, k) if parity else (k, other)
                pairs.append((cpr_lat[e], cpr_lon[e], cpr_lat[o], cpr_lon[o], parity, k))
            last[parity] = k

    n_fixes = 0
    if pairs:
        from airjax_torch.track.cpr_batch import decode_pairs

        arr = np.array(pairs, dtype=np.int64)
        lat, lon, valid = decode_pairs(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4].astype(bool))
        for row, la, lo, ok in zip(pairs, lat, lon, valid):
            if not ok:
                continue
            k = row[5]
            tracks[int(icao[k])].fixes.append(
                Fix(offset=int(offsets[k]), latitude=float(la), longitude=float(lo), altitude_ft=int(altitude[k])))
            n_fixes += 1

    return tracks, {**stats, "n_aircraft": len(tracks), "n_fixes": n_fixes}


@dataclasses.dataclass
class ExtendedTrack(Track):
    """Track, with the histories only the decode of every format gives."""

    velocities: list[tuple] = dataclasses.field(default_factory=list)
    # (offset, ground_speed_kt, track_deg, vertical_rate_fpm)
    squawks: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    kinds: dict[str, int] = dataclasses.field(default_factory=dict)
    # messages by packet class: AdsbPacket, AllCallReply, SurveillanceReply, AcasReply


def analyze_capture_extended(
    iq: np.ndarray, ref_position: tuple[float, float] | None = None, capacity_per_shard: int = 2048,
    devices: int | None = None, *, device: torch.device | str = "cuda",
) -> tuple[dict[int, ExtendedTrack], dict]:
    """Every Mode S downlink format of a capture -> ({icao: ExtendedTrack},
    stats) (airjax/analytics.py:176-256): the sharded extended decode over
    make_mesh(devices or 1, device=device), then the ordered packets replayed
    through the live tracker with time = offset / SAMPLE_RATE."""
    from airjax_torch.extended import handle_extended_update
    from airjax_torch.parallel.halo import decode_capture_sharded_extended
    from airjax_torch.parallel.mesh import make_mesh
    from airjax_torch.protocol.packet import AdsbPacket, AircraftVelocityMsg

    # make_mesh raises on more devices than exist, never uses fewer.
    mesh = make_mesh(devices or 1, device=device)
    packets, stats = decode_capture_sharded_extended(iq, mesh, capacity_per_shard=capacity_per_shard, now=0.0)

    aircrafts: dict = {}
    tracks: dict[int, ExtendedTrack] = {}
    n_fixes = 0
    for off, pkt in packets:
        t = tracks.get(pkt.icao)
        if t is None:
            t = tracks[pkt.icao] = ExtendedTrack(icao=pkt.icao, callsign=None, n_messages=0, altitudes=[], fixes=[])
        t.n_messages += 1
        kind = type(pkt).__name__
        t.kinds[kind] = t.kinds.get(kind, 0) + 1

        a_prev = aircrafts.get(pkt.icao)
        geo_prev = a_prev.geo_position if a_prev is not None else None
        # A new aircraft starts at the tracker's altitude 0: creation alone
        # logs no altitude.
        alt_prev = a_prev.altitude if a_prev is not None else 0
        squawk_prev = a_prev.squawk if a_prev is not None else None
        # The tracker's pairing window is in seconds: time = offset / rate
        # keeps the 10 s window at 20 M samples.
        handle_extended_update(
            dataclasses.replace(pkt, time_processed=off / SAMPLE_RATE) if dataclasses.is_dataclass(pkt) else pkt,
            aircrafts, ref_position=ref_position,
        )
        a = aircrafts[pkt.icao]
        t.callsign = a.callsign
        if a.altitude != alt_prev:
            t.altitudes.append((off, a.altitude))
        if a.squawk is not None and a.squawk != squawk_prev:
            t.squawks.append((off, a.squawk))
        if a.geo_position is not None and a.geo_position is not geo_prev:
            t.fixes.append(Fix(offset=off, latitude=a.geo_position.latitude, longitude=a.geo_position.longitude,
                               altitude_ft=a.altitude))
            n_fixes += 1
        if isinstance(pkt, AdsbPacket) and isinstance(pkt.msg, AircraftVelocityMsg):
            if pkt.msg.ground_speed_kt is not None or pkt.msg.vertical_rate_fpm is not None:
                t.velocities.append((off, a.ground_speed_kt, a.track_deg, a.vertical_rate_fpm))

    return tracks, {**stats, "n_aircraft": len(tracks), "n_fixes": n_fixes}
