"""Synthetic IQ in numpy: Mode S frames PPM-modulated into a 2 MS/s noise
floor. Byte-identical to airjax/io/synth.py for the same arguments (that
module imports jax through airjax.protocol). The makers of the other
downlink formats are in airjax_torch.protocol.shortframe, as in airjax.

Modulation matches what the detector and slicer expect:
  preamble: pulses at half-us samples {0, 2, 7, 9} of 16
  bit 1 -> (pulse, gap), bit 0 -> (gap, pulse)
"""

from __future__ import annotations

import numpy as np

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
