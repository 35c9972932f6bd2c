"""The sky a receiver hears, made from a seed: Mode S frames sent at the
aircraft's own times, at the level free space leaves them at the
receiver, and modulated into int16 IQ on the device.

A frozen copy of the frame makers, the CRC-24 and the PPM modulation of
the program under test (its io/synth.py and protocol/shortframe.py, and a
traffic model of level flights), rewritten to build every frame of a
capture in a few numpy calls and to modulate on the card with plain torch
ops. It imports nothing of the program, so a change to the program cannot
move the yardstick.

What the sky holds comes from a traffic file's `sky` group: the number of
aircraft, where they fly, the squitter and reply rates a second for each
kind and how far each interval may stray from its period at random, the
shares of DF17 frames sent with a 1-bit or 2-bit error, the receiver's
place, the transponders' power, the link's gains and the receiver's
noise, and the capture's length.

The link. Each frame leaves its transponder at a power drawn for the
aircraft within `transmit_power_dbw` and reaches the receiver attenuated
by free space over the slant range at that moment (Friis); frames from
beyond the radio horizon (4/3 Earth radius) never arrive. The receiver's
noise is thermal, k T0 B at the sample rate, raised by its noise figure;
`noise_std` is where the receiver's gain puts that noise on each int16
rail, and a pulse's amplitude follows from its signal-to-noise ratio.
Each frame keeps one carrier phase, drawn at random, so two frames that
overlap add as two independent transmitters do, and samples past int16
clip as a receiver's converter does. Frames start where their times
fall, so that they overlap as often as the sky's load makes them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

GENERATOR = 0x1FFF409  # the Mode S CRC-24 polynomial, 25 bits
CHARSET = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######"
PREAMBLE_PULSES = (0, 2, 7, 9)
PREAMBLE_LEN = 16
WINDOW = 240  # samples a 112-bit frame's preamble and data span
BOLTZMANN = 1.380649e-23  # J/K
T0_KELVIN = 290.0  # the noise figure's reference temperature
LIGHT_MPS = 299_792_458.0
EARTH_RADIUS_M = 6_371_000.0
FEET_M = 0.3048

# Frame kinds, in the order their events are made; the codes are this
# module's own.
KINDS = ("position", "velocity", "id", "df11", "df4", "df5", "df20")
LONG_KINDS = {"position", "velocity", "id", "df20"}
DF17_KINDS = {"position", "velocity", "id"}


def crc24_scalar(data: bytes) -> int:
    """Bit-serial CRC-24 over `data`, the remainder of data * x^24."""
    reg = 0
    for byte in data:
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            top = (reg >> 23) & 1
            reg = (reg << 1) & 0xFFFFFF
            if top ^ bit:
                reg ^= GENERATOR & 0xFFFFFF
    return reg


@functools.cache
def crc_table() -> np.ndarray:
    """(256,) int64: the CRC-24 register's update for each leading byte."""
    table = np.zeros(256, np.int64)
    for b in range(256):
        reg = b << 16
        for _ in range(8):
            reg = ((reg << 1) ^ (GENERATOR & 0xFFFFFF)) if reg & 0x800000 else (reg << 1)
            reg &= 0xFFFFFF
        table[b] = reg
    return table


def crc24_rows(rows: np.ndarray) -> np.ndarray:
    """(n, k) uint8 -> (n,) int64 CRC-24 of each row, table driven."""
    table = crc_table()
    reg = np.zeros(rows.shape[0], np.int64)
    for j in range(rows.shape[1]):
        reg = ((reg << 8) & 0xFFFFFF) ^ table[((reg >> 16) ^ rows[:, j].astype(np.int64)) & 0xFF]
    return reg


def put24(rows: np.ndarray, col: int, value: np.ndarray) -> None:
    rows[:, col] = (value >> 16) & 0xFF
    rows[:, col + 1] = (value >> 8) & 0xFF
    rows[:, col + 2] = value & 0xFF


def num_zones(lat: np.ndarray) -> np.ndarray:
    """NL(lat), the CPR longitude zone count, element-wise."""
    lat = np.asarray(lat, np.float64)
    a = 1.0 - math.cos(math.pi / 30.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.cos(np.pi / 180.0 * lat)
        nl = np.floor(2.0 * np.pi / np.arccos(1.0 - a / (c * c)))
    nl = np.where(lat == 0.0, 59, nl)
    nl = np.where(np.abs(lat) == 87.0, 2, nl)
    nl = np.where(np.abs(lat) > 87.0, 1, nl)
    return nl.astype(np.int64)


def encode_airborne_cpr(lat: np.ndarray, lon: np.ndarray, odd: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Airborne CPR encoding (17-bit, 360-degree zones), element-wise."""
    dlat = np.where(odd, 360.0 / 59.0, 360.0 / 60.0)
    yz = np.floor(131072.0 * np.mod(lat, dlat) / dlat + 0.5).astype(np.int64) % 131072
    rlat = dlat * (yz / 131072.0 + np.floor(lat / dlat))
    n = np.maximum(num_zones(rlat) - odd.astype(np.int64), 1)
    dlon = 360.0 / n
    xz = np.floor(131072.0 * np.mod(lon, dlon) / dlon + 0.5).astype(np.int64) % 131072
    return yz, xz


def ac13(altitude_ft: np.ndarray) -> np.ndarray:
    """The 13-bit AC field, Q=1 (25 ft), of DF4 and DF20 replies."""
    n = (np.asarray(altitude_ft, np.int64) + 1000) // 25
    return (((n >> 5) & 0x3F) << 7) | (((n >> 4) & 1) << 5) | (1 << 4) | (n & 0xF)


def id13(squawk_digits: np.ndarray) -> np.ndarray:
    """(n, 4) octal digits A B C D -> the 13-bit ID field of DF5 replies."""
    a, b, c, d = (squawk_digits[:, i].astype(np.int64) for i in range(4))
    bits = [c & 1, a & 1, (c >> 1) & 1, (a >> 1) & 1, (c >> 2) & 1, (a >> 2) & 1, 0 * a,
            b & 1, d & 1, (b >> 1) & 1, (d >> 1) & 1, (b >> 2) & 1, (d >> 2) & 1]
    out = np.zeros_like(a)
    for bit in bits:
        out = (out << 1) | bit
    return out


def id_me(callsigns: list[str]) -> np.ndarray:
    """(n, 7) uint8 aircraft identification ME fields (TC 4, category 0)."""
    me = np.zeros((len(callsigns), 7), np.uint8)
    for i, cs in enumerate(callsigns):
        v = 0
        for ch in cs.ljust(8, "_")[:8]:
            v = (v << 6) | CHARSET.index(ch)
        me[i] = np.frombuffer(bytes([4 << 3]) + v.to_bytes(6, "big"), np.uint8)
    return me


def velocity_me(ew_kt: np.ndarray, ns_kt: np.ndarray) -> np.ndarray:
    """(n, 7) uint8 airborne velocity ME fields, subtype 1, level flight."""
    n = len(ew_kt)
    sa, va = (ew_kt < 0).astype(np.int64), np.abs(ew_kt).astype(np.int64) + 1
    sb, vb = (ns_kt < 0).astype(np.int64), np.abs(ns_kt).astype(np.int64) + 1
    vr = 1  # vertical rate 0 ft/min: the code 0 // 64 + 1
    me = np.zeros((n, 7), np.int64)
    me[:, 0] = (19 << 3) | 1
    me[:, 1] = (sa << 2) | (va >> 8)
    me[:, 2] = va & 0xFF
    me[:, 3] = (sb << 7) | (vb >> 3)
    me[:, 4] = ((vb & 0x7) << 5) | (vr >> 6)
    me[:, 5] = (vr & 0x3F) << 2
    return me.astype(np.uint8)


def df17(icao: np.ndarray, me: np.ndarray) -> np.ndarray:
    """(n, 14) uint8 DF17 frames (capability 5) with their CRC."""
    rows = np.zeros((len(icao), 14), np.uint8)
    rows[:, 0] = (17 << 3) | 5
    put24(rows, 1, icao)
    rows[:, 4:11] = me
    put24(rows, 11, crc24_rows(rows[:, :11]))
    return rows


def short_reply(word: np.ndarray, parity_xor: np.ndarray) -> np.ndarray:
    """(n, 14) uint8: a 56-bit frame, its 32-bit word then CRC ^ parity_xor,
    in the first 7 bytes (the rest 0)."""
    rows = np.zeros((len(word), 14), np.uint8)
    for j in range(4):
        rows[:, j] = (word >> (24 - 8 * j)) & 0xFF
    put24(rows, 4, crc24_rows(rows[:, :4]) ^ parity_xor)
    return rows


@dataclasses.dataclass
class Sky:
    """A capture and what it holds. `iq` is (n_samples, 2) int16 on the
    host; the frames that reach the receiver are in time order, `offsets`
    their first sample (a frame near the end wraps round to the capture's
    start, which the replay follows), `frames` (n, 14) uint8 as sent
    (errors included, short frames in the first 7 bytes), `kinds` indices
    into KINDS, `icao` the sender, `flips` the bits flipped (0, 1 or 2),
    `snr_db` each frame's pulse signal-to-noise ratio; `aircraft` those
    heard, by address."""

    iq: np.ndarray
    offsets: np.ndarray
    frames: np.ndarray
    kinds: np.ndarray
    icao: np.ndarray
    flips: np.ndarray
    snr_db: np.ndarray
    aircraft: dict


def make_sky(sky: dict, seed: int, sample_rate_hz: float, device: torch.device | str) -> Sky:
    """The capture the traffic file's `sky` group describes, from `seed`."""
    rng = np.random.default_rng(seed)
    n_air = int(sky["aircraft"])
    seconds = float(sky["capture_seconds"])
    n_samples = int(round(seconds * sample_rate_hz))
    icao = rng.choice((1 << 24) - 1, n_air, replace=False).astype(np.int64) + 1
    lat0 = rng.uniform(*sky["latitude_deg"], n_air)
    lon0 = rng.uniform(*sky["longitude_deg"], n_air)
    speed = rng.uniform(*sky["speed_mps"], n_air)
    heading = rng.uniform(0.0, 2.0 * np.pi, n_air)
    vn, ve = speed * np.cos(heading), speed * np.sin(heading)
    alt_lo, alt_hi = sky["altitude_ft"]
    alt = 25 * rng.integers(alt_lo // 25, alt_hi // 25 + 1, n_air)
    squawk = rng.integers(0, 8, (n_air, 4))
    letters = rng.integers(0, 26, (n_air, 3))
    callsign = [
        "".join(chr(65 + c) for c in letters[i]) + f"{i:04d}" for i in range(n_air)
    ]
    power_dbw = rng.uniform(*sky["transmit_power_dbw"], n_air)
    kt = 1.0 / 0.514444  # knots per m/s

    rates = {**sky["squitters_per_s"], **sky["replies_per_s"]}
    jitter = sky["interval_jitter"]
    ev_air, ev_t, ev_kind, ev_seq = [], [], [], []
    for code, kind in enumerate(KINDS):
        # Each interval uniform in period * (1 +- jitter): transmitters
        # space their squitters at random, never in step with a block.
        period, j = 1.0 / float(rates[kind]), float(jitter[kind])
        n_max = int(math.ceil(seconds / (period * (1.0 - j)))) + 1
        gaps = period * rng.uniform(1.0 - j, 1.0 + j, (n_air, n_max))
        t = rng.uniform(0.0, period, n_air)[:, None] + np.cumsum(gaps, axis=1) - gaps[:, :1]
        keep = t < seconds
        a = np.broadcast_to(np.arange(n_air)[:, None], t.shape)[keep]
        ev_air.append(a)
        ev_t.append(t[keep])
        ev_kind.append(np.full(a.shape, code))
        ev_seq.append(np.broadcast_to(np.arange(n_max)[None, :], t.shape)[keep])
    ev_air, ev_t = np.concatenate(ev_air), np.concatenate(ev_t)
    ev_kind, ev_seq = np.concatenate(ev_kind), np.concatenate(ev_seq)

    frames = np.zeros((len(ev_t), 14), np.uint8)
    for code, kind in enumerate(KINDS):
        sel = ev_kind == code
        a = ev_air[sel]
        if kind == "position":
            t = ev_t[sel]
            lat = lat0[a] + vn[a] * t / 111_320.0
            lon = lon0[a] + ve[a] * t / (111_320.0 * np.cos(np.radians(lat0[a])))
            odd = (ev_seq[sel] % 2).astype(bool)
            yz, xz = encode_airborne_cpr(lat, lon, odd)
            code_alt = (alt[a] + 1000) // 25
            me = np.zeros((len(a), 7), np.int64)
            me[:, 0] = 11 << 3
            me[:, 1] = ((code_alt >> 4) << 1) | 1
            me[:, 2] = ((code_alt & 0xF) << 4) | (odd.astype(np.int64) << 2) | ((yz >> 15) & 3)
            me[:, 3] = (yz >> 7) & 0xFF
            me[:, 4] = ((yz & 0x7F) << 1) | ((xz >> 16) & 1)
            me[:, 5] = (xz >> 8) & 0xFF
            me[:, 6] = xz & 0xFF
            frames[sel] = df17(icao[a], me.astype(np.uint8))
        elif kind == "velocity":
            frames[sel] = df17(icao[a], velocity_me(np.round(ve * kt).astype(np.int64),
                                                    np.round(vn * kt).astype(np.int64))[a])
        elif kind == "id":
            frames[sel] = df17(icao[a], id_me(callsign)[a])
        elif kind == "df11":
            rows = np.zeros((len(a), 14), np.uint8)
            rows[:, 0] = (11 << 3) | 5
            put24(rows, 1, icao[a])
            put24(rows, 4, crc24_rows(rows[:, :4]))
            frames[sel] = rows
        elif kind == "df4":
            frames[sel] = short_reply((4 << 27) | ac13(alt[a]), icao[a])
        elif kind == "df5":
            frames[sel] = short_reply((5 << 27) | id13(squawk[a]), icao[a])
        elif kind == "df20":
            rows = np.zeros((len(a), 14), np.uint8)
            word = (20 << 27) | ac13(alt[a])
            for j in range(4):
                rows[:, j] = (word >> (24 - 8 * j)) & 0xFF
            rows[:, 4:11] = id_me(callsign)[a]
            put24(rows, 11, crc24_rows(rows[:, :11]) ^ icao[a])
            frames[sel] = rows

    # What reaches the receiver: each frame at its level over the slant
    # range at its time; none from beyond the radio horizon.
    t = ev_t
    a = ev_air
    lat = lat0[a] + vn[a] * t / 111_320.0
    lon = lon0[a] + ve[a] * t / (111_320.0 * np.cos(np.radians(lat0[a])))
    snr_db, heard = link(sky, lat, lon, alt[a] * FEET_M, power_dbw[a], sample_rate_hz)
    order = np.nonzero(heard)[0]
    order = order[np.lexsort((ev_kind[order], t[order]))]
    frames, kinds, senders = frames[order], ev_kind[order], icao[ev_air[order]]
    offsets = np.floor(t[order] * sample_rate_hz).astype(np.int64) % n_samples
    snr_db = snr_db[order]
    phase = rng.uniform(0.0, 2.0 * np.pi, len(order))

    # 1-bit and 2-bit errors in data bits 5-87 of a share of the DF17s.
    is17 = np.isin(kinds, [KINDS.index(k) for k in DF17_KINDS])
    idx17 = np.nonzero(is17)[0]
    n1 = int(round(float(sky["one_bit_error_share"]) * len(idx17)))
    n2 = int(round(float(sky["two_bit_error_share"]) * len(idx17)))
    hit = rng.choice(idx17, n1 + n2, replace=False)
    flips = np.zeros(len(frames), np.int64)
    for j, i in enumerate(hit.tolist()):
        nbits = 1 if j < n1 else 2
        for b in rng.choice(np.arange(5, 88), nbits, replace=False).tolist():
            frames[i, b // 8] ^= np.uint8(1 << (7 - b % 8))
        flips[i] = nbits

    long_mask = np.isin(kinds, [KINDS.index(k) for k in LONG_KINDS])
    noise_std = float(sky["noise_std"])
    amplitude = noise_std * math.sqrt(2.0) * 10.0 ** (snr_db / 20.0)
    iq = modulate(frames, long_mask, offsets, n_samples, amplitude, phase, noise_std, seed, device)
    heard_by = set(senders.tolist())
    aircraft = {int(icao[i]): {"callsign": callsign[i], "altitude_ft": int(alt[i]),
                               "squawk": "".join(str(d) for d in squawk[i])}
                for i in range(n_air) if int(icao[i]) in heard_by}
    return Sky(iq, offsets, frames, kinds, senders, flips, snr_db, aircraft)


def link(sky: dict, lat: np.ndarray, lon: np.ndarray, height_m: np.ndarray, power_dbw: np.ndarray,
         sample_rate_hz: float) -> tuple[np.ndarray, np.ndarray]:
    """(pulse signal-to-noise ratio in dB, heard) of frames sent from
    (lat, lon, height) at `power_dbw`: Friis over the slant range, the
    receiver's thermal noise k T0 B raised by its noise figure, and the
    radio horizon over a 4/3 Earth."""
    rx = sky["receiver"]
    rx_lat, rx_lon, rx_h = float(rx["latitude_deg"]), float(rx["longitude_deg"]), float(rx["antenna_height_m"])
    # Ground distance on the sphere (haversine), then the slant range.
    p1, p2 = np.radians(rx_lat), np.radians(lat)
    h = np.sin((p2 - p1) / 2.0) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(np.radians(lon - rx_lon) / 2.0) ** 2
    ground = 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(h))
    slant = np.hypot(ground, height_m - rx_h)
    k_r = 4.0 / 3.0 * EARTH_RADIUS_M
    horizon = np.sqrt(2.0 * k_r * height_m) + np.sqrt(2.0 * k_r * rx_h)
    wavelength = LIGHT_MPS / float(sky["frequency_hz"])
    path_loss_db = 20.0 * np.log10(4.0 * np.pi * slant / wavelength)
    received_dbw = power_dbw + float(sky["transmit_antenna_gain_dbi"]) + float(sky["receive_antenna_gain_dbi"]) \
        - float(sky["line_loss_db"]) - path_loss_db
    noise_dbw = 10.0 * np.log10(BOLTZMANN * T0_KELVIN * sample_rate_hz) + float(sky["noise_figure_db"])
    return received_dbw - noise_dbw, ground <= horizon


def modulate(frames: np.ndarray, long_mask: np.ndarray, offsets: np.ndarray, n_samples: int,
             amplitude: np.ndarray, phase: np.ndarray, noise_std: float, seed: int, device) -> np.ndarray:
    """PPM over Gaussian noise on both rails, on `device` -> host
    (n_samples, 2) int16: the preamble's 4 pulses, then per bit a pulse in
    its first half for a 1 and in its second for a 0; 112 bits a long frame,
    56 a short one. A frame's pulses have its amplitude and carrier phase;
    overlapping frames add; samples past the end wrap to the start. Rounded
    half to even and clipped to int16."""
    device = torch.device(device)
    bits = np.unpackbits(frames, axis=1).astype(np.int64)  # (n, 112)
    n = len(frames)
    k = np.arange(112)
    pos = PREAMBLE_LEN + 2 * k[None, :] + (1 - bits)
    valid = np.where(long_mask[:, None], True, k[None, :] < 56)
    pre = np.broadcast_to(np.asarray(PREAMBLE_PULSES)[None, :], (n, 4))
    rel = np.concatenate([pre, np.where(valid, pos, -1)], axis=1)
    mask = np.concatenate([np.ones((n, 4), bool), valid], axis=1)
    idx = (offsets[:, None] + rel)[mask] % n_samples
    owner = np.broadcast_to(np.arange(n)[:, None], mask.shape)[mask]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    iq = torch.empty((n_samples, 2), dtype=torch.float32, device=device).normal_(0.0, noise_std, generator=gen)
    touched = torch.as_tensor(idx, device=device)
    who = torch.as_tensor(owner, device=device)
    amp = torch.as_tensor(amplitude, dtype=torch.float32, device=device)[who]
    ph = torch.as_tensor(phase, dtype=torch.float32, device=device)[who]
    iq[:, 0].index_put_((touched,), amp * torch.cos(ph), accumulate=True)
    iq[:, 1].index_put_((touched,), amp * torch.sin(ph), accumulate=True)
    out = iq.round_().clamp_(-32768, 32767).to(torch.int16)
    del iq
    return out.cpu().numpy()
