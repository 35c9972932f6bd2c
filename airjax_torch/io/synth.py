"""Synthetic IQ in numpy: Mode S frames PPM-modulated into a 2 MS/s noise
floor, and the frame and ME makers of every message the trackers handle.
Byte-identical to airjax/io/synth.py for the same arguments (that module
imports jax through airjax.protocol). The makers of the other downlink
formats are in airjax_torch.protocol.shortframe, as in airjax.

`modulate_device` builds a capture on the device in torch ops, for
workloads too large to make on the host (airjax/io/synth.py:400-437).

Modulation matches what the detector and slicer expect:
  preamble: pulses at half-us samples {0, 2, 7, 9} of 16
  bit 1 -> (pulse, gap), bit 0 -> (gap, pulse)
"""

from __future__ import annotations

import numpy as np
import torch

from airjax_torch.dsp.demod import dynamic_start
from airjax_torch.protocol import acas
from airjax_torch.protocol import shortframe as sf
from airjax_torch.protocol.crc import crc24
from airjax_torch.protocol.fields import CHAR_CONVERT

PREAMBLE_PULSES = (0, 2, 7, 9)
PREAMBLE_LEN = 16
FRAME_BITS = 112
FRAME_SAMPLES = 224
WINDOW = PREAMBLE_LEN + FRAME_SAMPLES


def make_df17(icao: int, me: bytes, capability: int = 5) -> bytes:
    """A 14-byte DF17 frame with a valid CRC-24 (airjax/io/synth.py:30-36)."""
    if len(me) != 7:
        raise ValueError("ME field must be 7 bytes")
    body = bytes([(17 << 3) | capability, (icao >> 16) & 0xFF, (icao >> 8) & 0xFF, icao & 0xFF]) + me
    crc = crc24(body)
    return body + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF, crc & 0xFF])


def make_df18(icao: int, me: bytes, cf: int = 0) -> bytes:
    """Assemble a 14-byte DF18 (extended squitter / non-transponder or
    TIS-B) frame with a valid CRC-24. CF 0/1/6 are ADS-B, 2/5 fine-format
    TIS-B (DF17 ME layout); 3/4/7 use other ME encodings."""
    if len(me) != 7:
        raise ValueError("ME field must be 7 bytes")
    body = bytes(
        [(18 << 3) | cf, (icao >> 16) & 0xFF, (icao >> 8) & 0xFF, icao & 0xFF]
    ) + me
    crc = crc24(body)
    return body + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF, crc & 0xFF])


def make_id_me(callsign: str, tc: int = 4, category: int = 0) -> bytes:
    """An AircraftID ME field from an 8-char callsign (airjax/io/synth.py:52-65)."""
    cs = callsign.ljust(8, "_")[:8]
    bits48 = 0
    for ch in cs:
        idx = CHAR_CONVERT.find(ch)
        if idx < 0:
            raise ValueError(f"character {ch!r} not encodable")
        bits48 = (bits48 << 6) | idx
    return bytes([(tc << 3) | category]) + bits48.to_bytes(6, "big")


def make_position_me(
    tc: int,
    altitude_ft: int,
    cpr_lat: int,
    cpr_lon: int,
    odd: bool,
    q25: bool = True,
    surveillance_status: int = 0,
    nic: int = 0,
    cpr_time: int = 0,
) -> bytes:
    """An AircraftPosition ME field (airjax/io/synth.py:68-98)."""
    code = (altitude_ft + 1000) // (25 if q25 else 100)
    if not 0 <= code < 2048:
        raise ValueError("altitude code out of range")
    m0 = (tc << 3) | (surveillance_status << 1) | nic
    m1 = ((code >> 4) << 1) | (1 if q25 else 0)
    m2 = ((code & 0xF) << 4) | (cpr_time << 3) | ((1 if odd else 0) << 2) | ((cpr_lat >> 15) & 0b11)
    m3 = (cpr_lat >> 7) & 0xFF
    m4 = ((cpr_lat & 0x7F) << 1) | ((cpr_lon >> 16) & 1)
    m5 = (cpr_lon >> 8) & 0xFF
    m6 = cpr_lon & 0xFF
    return bytes([m0, m1, m2, m3, m4, m5, m6])


def make_velocity_me(
    ew_kt: int = 0,
    ns_kt: int = 0,
    vertical_rate_fpm: int | None = None,
    subtype: int = 1,
    nac_v: int = 0,
    intent_change: int = 0,
    vr_source_gnss: bool = True,
    gnss_baro_diff_ft: int | None = None,
    heading_deg: float | None = None,
    airspeed_kt: int | None = None,
    airspeed_is_tas: bool = False,
) -> bytes:
    """Build a TC19 airborne-velocity ME field (inverse of
    airjax_torch.protocol.packet.AircraftVelocityMsg.from_me).

    Subtype 1/2: `ew_kt`/`ns_kt` signed knots (east/north positive).
    Subtype 3/4: `heading_deg` (None = heading unavailable) + `airspeed_kt`.
    """
    scale = 4 if subtype in (2, 4) else 1
    if subtype in (1, 2):
        sign_a = 1 if ew_kt < 0 else 0
        val_a = abs(ew_kt) // scale + 1
        sign_b = 1 if ns_kt < 0 else 0
        val_b = abs(ns_kt) // scale + 1
    else:
        sign_a = 0 if heading_deg is None else 1
        val_a = 0 if heading_deg is None else round(heading_deg * 1024 / 360) % 1024
        sign_b = 1 if airspeed_is_tas else 0
        val_b = 0 if airspeed_kt is None else airspeed_kt // scale + 1
    if not (0 <= val_a < 1024 and 0 <= val_b < 1024):
        raise ValueError("velocity field out of 10-bit range")
    if vertical_rate_fpm is None:
        vr_sign, vr_val = 0, 0
    else:
        vr_sign = 1 if vertical_rate_fpm < 0 else 0
        vr_val = abs(vertical_rate_fpm) // 64 + 1
    if gnss_baro_diff_ft is None:
        gbd_sign, gbd_val = 0, 0
    else:
        gbd_sign = 1 if gnss_baro_diff_ft < 0 else 0
        gbd_val = abs(gnss_baro_diff_ft) // 25 + 1
    m0 = (19 << 3) | subtype
    m1 = (intent_change << 7) | (nac_v << 3) | (sign_a << 2) | (val_a >> 8)
    m2 = val_a & 0xFF
    m3 = (sign_b << 7) | (val_b >> 3)
    m4 = (
        ((val_b & 0x7) << 5)
        | ((0 if vr_source_gnss else 1) << 4)
        | (vr_sign << 3)
        | (vr_val >> 6)
    )
    m5 = (vr_val & 0x3F) << 2
    m6 = (gbd_sign << 7) | gbd_val
    return bytes([m0, m1, m2, m3, m4, m5, m6])


def encode_movement(speed_kt: float | None) -> int:
    """Inverse of airjax_torch.protocol.packet.decode_movement_kt (nearest code)."""
    if speed_kt is None:
        return 0
    if speed_kt <= 0:
        return 1
    if speed_kt < 1:
        return 2 + round((speed_kt - 0.125) / 0.125)
    if speed_kt < 2:
        return 9 + round((speed_kt - 1.0) / 0.25)
    if speed_kt < 15:
        return 13 + round((speed_kt - 2.0) / 0.5)
    if speed_kt < 70:
        return 39 + round(speed_kt - 15.0)
    if speed_kt < 100:
        return 94 + round((speed_kt - 70.0) / 2.0)
    if speed_kt < 175:
        return 109 + round((speed_kt - 100.0) / 5.0)
    return 124


def encode_surface_cpr(lat: float, lon: float, odd: bool) -> tuple[int, int]:
    """Spec CPR surface encoding (90-degree zones) -> (lat17, lon17)."""
    import math

    from airjax_torch.track.cpr import calc_num_zones

    dlat = 90.0 / 59.0 if odd else 90.0 / 60.0
    yz = math.floor(131072.0 * (lat % dlat) / dlat + 0.5) % 131072
    rlat = dlat * (yz / 131072.0 + math.floor(lat / dlat))
    n = max(calc_num_zones(rlat) - (1 if odd else 0), 1)
    dlon = 90.0 / n
    xz = math.floor(131072.0 * (lon % dlon) / dlon + 0.5) % 131072
    return yz, xz


def make_gnss_position_me(
    tc: int,
    altitude_m: int,
    cpr_lat: int,
    cpr_lon: int,
    odd: bool,
    surveillance_status: int = 0,
    nic: int = 0,
    cpr_time: int = 0,
) -> bytes:
    """Build a TC20-22 airborne position ME (GNSS HAE altitude, metres)."""
    if not 20 <= tc <= 22:
        raise ValueError("GNSS position TC must be 20-22")
    if not 0 <= altitude_m < 4096:
        raise ValueError("GNSS altitude out of 12-bit metre range")
    m0 = (tc << 3) | (surveillance_status << 1) | nic
    m1 = (altitude_m >> 4) & 0xFF
    m2 = (
        ((altitude_m & 0xF) << 4)
        | (cpr_time << 3)
        | ((1 if odd else 0) << 2)
        | ((cpr_lat >> 15) & 0b11)
    )
    m3 = (cpr_lat >> 7) & 0xFF
    m4 = ((cpr_lat & 0x7F) << 1) | ((cpr_lon >> 16) & 1)
    m5 = (cpr_lon >> 8) & 0xFF
    m6 = cpr_lon & 0xFF
    return bytes([m0, m1, m2, m3, m4, m5, m6])


def make_target_state_me(
    selected_altitude_ft: int | None = None,
    altitude_is_fms: bool = False,
    baro_setting_mb: float | None = None,
    selected_heading_deg: float | None = None,
    nac_p: int = 9,
    sil: int = 3,
    autopilot: bool = False,
    vnav: bool = False,
    alt_hold: bool = False,
    approach: bool = False,
    tcas_operational: bool = True,
    lnav: bool = False,
    mode_valid: bool = True,
) -> bytes:
    """Build a TC29 subtype-1 target state & status ME field."""
    alt_val = 0 if selected_altitude_ft is None else selected_altitude_ft // 32 + 1
    baro_val = (
        0 if baro_setting_mb is None else round((baro_setting_mb - 800.0) / 0.8) + 1
    )
    if selected_heading_deg is None:
        hdg_status, hdg_val = 0, 0
    else:
        hdg_status = 1
        h = selected_heading_deg if selected_heading_deg < 180 else selected_heading_deg - 360
        hdg_val = round(h * 256.0 / 180.0) & 0x1FF
    fields = [
        (29, 5), (1, 2), (0, 1),  # TC, subtype 1, SIL supplement
        (1 if altitude_is_fms else 0, 1), (alt_val, 11),
        (baro_val, 9),
        (hdg_status, 1), (hdg_val, 9),
        (nac_p, 4), (0, 1), (sil, 2),
        (1 if mode_valid else 0, 1),
        (1 if autopilot else 0, 1), (1 if vnav else 0, 1),
        (1 if alt_hold else 0, 1), (0, 1),
        (1 if approach else 0, 1), (1 if tcas_operational else 0, 1),
        (1 if lnav else 0, 1), (0, 2),
    ]
    v = 0
    total = 0
    for val, width in fields:
        v = (v << width) | (val & ((1 << width) - 1))
        total += width
    assert total == 56, total
    return v.to_bytes(7, "big")


def encode_airborne_cpr(lat: float, lon: float, odd: bool) -> tuple[int, int]:
    """Spec CPR airborne encoding (360-degree zones) -> (lat17, lon17)."""
    import math

    from airjax_torch.track.cpr import calc_num_zones

    dlat = 360.0 / 59.0 if odd else 360.0 / 60.0
    yz = math.floor(131072.0 * (lat % dlat) / dlat + 0.5) % 131072
    rlat = dlat * (yz / 131072.0 + math.floor(lat / dlat))
    n = max(calc_num_zones(rlat) - (1 if odd else 0), 1)
    dlon = 360.0 / n
    xz = math.floor(131072.0 * (lon % dlon) / dlon + 0.5) % 131072
    return yz, xz


def make_surface_me(
    lat: float,
    lon: float,
    odd: bool,
    tc: int = 7,
    speed_kt: float | None = None,
    track_deg: float | None = None,
    cpr_time: int = 0,
) -> bytes:
    """Build a TC5-8 surface-position ME field (extension)."""
    lat17, lon17 = encode_surface_cpr(lat, lon, odd)
    movement = encode_movement(speed_kt)
    track_valid = 0 if track_deg is None else 1
    track7 = 0 if track_deg is None else round(track_deg * 128.0 / 360.0) % 128
    m0 = (tc << 3) | (movement >> 4)
    m1 = ((movement & 0xF) << 4) | (track_valid << 3) | (track7 >> 4)
    m2 = (
        ((track7 & 0xF) << 4)
        | (cpr_time << 3)
        | ((1 if odd else 0) << 2)
        | ((lat17 >> 15) & 0b11)
    )
    m3 = (lat17 >> 7) & 0xFF
    m4 = ((lat17 & 0x7F) << 1) | ((lon17 >> 16) & 1)
    m5 = (lon17 >> 8) & 0xFF
    m6 = lon17 & 0xFF
    return bytes([m0, m1, m2, m3, m4, m5, m6])


def make_status_me(squawk: int, emergency_state: int = 0) -> bytes:
    """Build a TC28 subtype-1 aircraft-status ME field."""
    from airjax_torch.protocol.shortframe import _id13_from_squawk

    id13 = _id13_from_squawk(squawk)
    return bytes(
        [(28 << 3) | 1, (emergency_state << 5) | (id13 >> 8), id13 & 0xFF, 0, 0, 0, 0]
    )


def make_opstatus_me(
    version: int = 2,
    nac_p: int = 9,
    sil: int = 3,
    surface: bool = False,
    capability_class: int = 0,
    operational_mode: int = 0,
    lw_code: int = 0,
    nic_a: int = 0,
    hrd_magnetic: int = 0,
) -> bytes:
    """Build a TC31 operational-status ME field."""
    cc16 = ((capability_class << 4) | lw_code) if surface else capability_class
    return bytes(
        [
            (31 << 3) | (1 if surface else 0),
            cc16 >> 8,
            cc16 & 0xFF,
            operational_mode >> 8,
            operational_mode & 0xFF,
            (version << 5) | (nic_a << 4) | nac_p,
            (sil << 4) | (hrd_magnetic << 2),
        ]
    )


def frame_to_pulses(frame: bytes) -> np.ndarray:
    """Frame bytes -> (16 + 2*nbits,) float64 {0,1}: preamble + PPM pulses
    (airjax/io/synth.py:351-367)."""
    bits = np.unpackbits(np.frombuffer(frame, dtype=np.uint8))
    pulses = np.zeros(PREAMBLE_LEN + 2 * len(bits), dtype=np.float64)
    pulses[list(PREAMBLE_PULSES)] = 1.0
    data = PREAMBLE_LEN + 2 * np.arange(len(bits))
    pulses[data + (1 - bits)] = 1.0  # 1 -> (pulse, gap), 0 -> (gap, pulse)
    return pulses


def modulate(
    frames: list[bytes],
    offsets: list[int],
    total_len: int,
    amplitude: float = 10000.0,
    noise_std: float = 60.0,
    snr_db: float | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Place frames in complex AWGN -> (total_len, 2) int16 IQ
    (airjax/io/synth.py:370-397). The signal rides on I; `snr_db`
    overrides `noise_std` via snr = amplitude^2 / (2 sigma^2)."""
    rng = np.random.default_rng(seed)
    if snr_db is not None:
        noise_std = amplitude / np.sqrt(2.0 * 10.0 ** (snr_db / 10.0))
    iq = rng.normal(0.0, noise_std, (total_len, 2)).astype(np.float32)
    for frame, off in zip(frames, offsets):
        pulses = frame_to_pulses(frame).astype(np.float32)
        if off < 0 or off + len(pulses) > total_len:
            raise ValueError(f"frame at {off} does not fit in {total_len}")
        iq[off : off + len(pulses), 0] += np.float32(amplitude) * pulses
    np.rint(iq, out=iq)
    np.clip(iq, -32768, 32767, out=iq)
    return iq.astype(np.int16)


def modulate_device(
    frames: list[bytes],
    offsets: list[int],
    total_len: int,
    amplitude: float = 10000.0,
    noise_std: float = 60.0,
    seed: int = 0,
    *,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """`modulate` on the device -> (total_len, 2) int16 tensor on `device`
    (airjax/io/synth.py:400-437): float32 Gaussian noise of `noise_std` on
    both rails, each 14-byte frame's pulse train times `amplitude` added
    to I at its offset, then rounded half to even and clipped to int16.

    The noise comes from a torch.Generator of `device` seeded with `seed`,
    so one seed gives one capture on every call; the CPU's and a card's
    streams differ, and neither is JAX's or numpy's (airjax's is not
    bit-identical to `modulate` either). With noise_std=0 the capture
    equals airjax's bit for bit wherever each sample's sum of pulses,
    k * amplitude, is exact in float32 (always for the default amplitude).

    Each frame starts where airjax's dynamic_slice starts it
    (dsp/demod.py::dynamic_start: a negative offset counts from the end,
    then the start is clamped into [0, total_len - 240]): a frame that
    does not fit is moved, not refused (the host `modulate` raises).
    Overlapping pulses are counted per sample in int32 (no float atomics,
    so the sum has no order), then added once."""
    if not frames:
        raise ValueError("modulate_device needs at least one frame")
    if any(len(f) != FRAME_BITS // 8 for f in frames):
        raise ValueError(f"modulate_device takes {FRAME_BITS // 8}-byte frames only")
    if len(offsets) != len(frames):
        raise ValueError(f"{len(frames)} frames but {len(offsets)} offsets")
    if total_len < WINDOW:
        raise ValueError(f"total_len {total_len} is shorter than a frame's {WINDOW} samples")
    device = torch.device(device)
    raw = torch.frombuffer(bytearray(b"".join(map(bytes, frames))), dtype=torch.uint8)
    raw = raw.view(len(frames), -1).to(device)
    bits = (raw.to(torch.int64)[:, :, None] >> torch.arange(7, -1, -1, device=device)) & 1
    # A frame's 116 pulses: the preamble's 4, then bit k at 16 + 2k if 1,
    # at 16 + 2k + 1 if 0.
    data = PREAMBLE_LEN + 2 * torch.arange(FRAME_BITS, device=device) + (1 - bits.reshape(len(frames), -1))
    preamble = torch.tensor(PREAMBLE_PULSES, device=device).expand(len(frames), -1)
    starts = dynamic_start(torch.as_tensor(np.asarray(offsets, dtype=np.int64), device=device), total_len, WINDOW)
    touched = (starts[:, None] + torch.cat([preamble, data], dim=1)).reshape(-1)
    count = torch.zeros(total_len, dtype=torch.int32, device=device)
    count.index_add_(0, touched, torch.ones_like(touched, dtype=torch.int32))

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    iq = torch.empty((total_len, 2), dtype=torch.float32, device=device).normal_(0.0, noise_std, generator=gen)
    rail = iq[:, 0]
    rail[touched] = rail[touched] + count[touched].to(torch.float32) * amplitude
    del count  # freed before the int16 result is allocated: a lower peak
    return iq.round_().clamp_(-32768, 32767).to(torch.int16)


def flip_bit(frame: bytes, bit_index: int) -> bytes:
    """Flip one bit (MSB-first index) — for CRC-repair tests."""
    buf = bytearray(frame)
    buf[bit_index // 8] ^= 1 << (7 - bit_index % 8)
    return bytes(buf)


def make_mixed_frames(n_aircraft: int, seed: int) -> list[bytes]:
    """Traffic of every downlink format the extended decode emits, for
    tests and smoke runs: per aircraft, in this order, a DF17 (which makes
    its ICAO known to the acceptance cache), then a DF11 acquisition
    squitter, an interrogated DF11, DF0, DF4, DF5, DF16 (with an RA
    report), DF20 (BDS 2,0 callsign), DF21 and DF24 reply. Altitudes
    alternate between the 25 ft and the Gillham encodings."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_aircraft):
        icao = int(rng.integers(1, 1 << 24))
        alt = 100 * int(rng.integers(10, 400))
        gillham = bool(i % 2)
        squawk = int("".join(str(d) for d in rng.integers(0, 8, 4)))
        if i % 2:
            me = make_position_me(11, alt, int(rng.integers(0, 1 << 17)), int(rng.integers(0, 1 << 17)), bool(i % 4 == 1))
        else:
            me = make_id_me(f"MIX{i % 100000:05d}")
        frames += [
            make_df17(icao, me),
            sf.make_df11(icao),
            sf.make_df11(icao, interrogator=int(rng.integers(1, 80))),
            sf.make_df0(icao, alt, vs=i % 2, gillham=gillham),
            sf.make_df4(icao, alt, fs=i % 6, gillham=gillham),
            sf.make_df5(icao, squawk),
            sf.make_df16(icao, alt, mv=acas.make_mv_ra(ara=1 << int(rng.integers(0, 14)))),
            sf.make_df20(icao, alt, mb=make_id_me(f"CB{i % 1000000:06d}")),
            sf.make_df21(icao, squawk, mb=make_id_me(f"CB{i % 1000000:06d}")),
            sf.make_df24(icao, nd=i % 16, md=rng.integers(0, 256, 10, dtype=np.uint8).tobytes()),
        ]
    return frames
