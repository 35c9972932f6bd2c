"""The plain reference: what a receiver must emit from a capture, and the
aircraft table it must hold, worked out again from the IQ alone.

Plain torch over whole captures (and numpy and Python for the tracker),
written from the reference decoder's scan semantics (the reference Rust
decoder's src/adsb.rs:92-122, demod.rs, crc.rs, cpr.rs and aircraft.rs,
as the program's golden scalar decoder states them), structurally unlike
the program's kernels. It imports nothing of the program and takes
nothing the program made: only the capture the benchmark generated.

At every offset of the capture, read as a loop (the stream replays it),
the magnitude is the u32-truncated float64 modulus; the DF17 gate asks
that each preamble high (0, 2, 7, 9) be >= each low (1, 3-6, 8, 10-15)
and each DF high (16 + 0, 3, 5, 7, 8) >= each DF low (16 + 1, 2, 4, 6,
9); the extended gate asks the preamble part only. Bits are first half >
second half over the 224 samples after the preamble. A frame is kept if
its CRC-24 holds or one data bit's syndrome repairs it (DF17 mode; in
extended mode DF17-19, 22, 23); extended mode also keeps DF11 all-calls
(PI == CRC, or an interrogator code below 80) and the AP-addressed DF0,
4, 5, 16, 20, 21 and 24+ candidates with a nonzero address.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from adsbench.yardstick.traffic import CHARSET, crc_table

HIGHS = (0, 2, 7, 9)
LOWS = (1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15)
DF_HIGHS = (0, 3, 5, 7, 8)
DF_LOWS = (1, 2, 4, 6, 9)
HALO = 239

# Kind codes of an extended candidate.
LONG, DF11, DF11_IC, SHORT_AP, LONG_AP = range(5)


def magnitudes(iq: torch.Tensor) -> torch.Tensor:
    """(L, 2) int16 -> (L,) int32 truncated float64 modulus."""
    x = iq.to(torch.float64)
    return torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]).to(torch.int32)


def _all_ge(m: torch.Tensor, n: int, base: int, highs, lows) -> torch.Tensor:
    lo = m[base + lows[0] : base + lows[0] + n]
    for k in lows[1:]:
        lo = torch.maximum(lo, m[base + k : base + k + n])
    hi = m[base + highs[0] : base + highs[0] + n]
    for k in highs[1:]:
        hi = torch.minimum(hi, m[base + k : base + k + n])
    return hi >= lo


def gate(m: torch.Tensor, n: int, df17: bool) -> torch.Tensor:
    """(n,) bool: the gate at offsets 0..n-1 of magnitudes m (len >= n + 239)."""
    ok = _all_ge(m, n, 0, HIGHS, LOWS)
    if df17:
        ok &= _all_ge(m, n, 16, DF_HIGHS, DF_LOWS)
    return ok


def frame_bytes(m: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(n,) offsets -> (n, 14) uint8 sliced frames."""
    k = torch.arange(112, device=m.device)
    first = offs[:, None] + 16 + 2 * k[None, :]
    bits = (m[first] > m[first + 1]).to(torch.int64).view(-1, 14, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=m.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def crc24(rows: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """CRC-24 of the first n_bytes of each (n, 14) uint8 row -> (n,) int64."""
    table = torch.as_tensor(crc_table(), device=rows.device)
    reg = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for j in range(n_bytes):
        reg = ((reg << 8) & 0xFFFFFF) ^ table[((reg >> 16) ^ rows[:, j].to(torch.int64)) & 0xFF]
    return reg


def field24(rows: torch.Tensor, col: int) -> torch.Tensor:
    r = rows.to(torch.int64)
    return (r[:, col] << 16) | (r[:, col + 1] << 8) | r[:, col + 2]


def syndromes() -> np.ndarray:
    """(88,) int64: the CRC residue a flip of data bit j leaves."""
    rows = np.zeros((88, 14), np.uint8)
    for j in range(88):
        rows[j, j // 8] = 1 << (7 - j % 8)
    return crc24(torch.as_tensor(rows), 11).numpy()


def repair1(rows: torch.Tensor, residue: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-bit repair: where `residue` (CRC ^ the frame's parity) equals a
    data bit's syndrome, that bit flipped -> (rows, repaired mask)."""
    syn = torch.as_tensor(syndromes(), device=rows.device)
    order = torch.argsort(syn)
    s_sorted = syn[order]
    pos = torch.searchsorted(s_sorted, residue).clamp(max=87)
    hit = (s_sorted[pos] == residue) & (residue != 0)
    bit = order[pos]
    fixed = rows.clone()
    idx = torch.nonzero(hit).flatten()
    b = bit[idx]
    fixed[idx, b // 8] ^= (1 << (7 - b % 8)).to(torch.uint8)
    return fixed, hit


def cyclic(iq: torch.Tensor) -> torch.Tensor:
    """The capture with its first 239 samples appended: every offset of the
    loop then has its 240-sample window."""
    return torch.cat([iq, iq[:HALO]], dim=0)


def decode_df17(iq: torch.Tensor, chunk: int = 1 << 24) -> dict:
    """DF17 mode over one loop of the capture (its offsets 0..N-1, the
    windows reading round the loop) -> offsets (int64), frames (n, 14) uint8
    and repaired (bool), numpy, in offset order."""
    n = iq.shape[0]
    ext = cyclic(iq)
    out = {"offsets": [], "frames": [], "repaired": []}
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        m = magnitudes(ext[s : s + c + HALO])
        offs = torch.nonzero(gate(m, c, True)).flatten()
        rows = frame_bytes(m, offs)
        residue = crc24(rows, 11) ^ field24(rows, 11)
        fixed, hit = repair1(rows, residue)
        keep = (residue == 0) | hit
        out["offsets"].append((offs[keep] + s).cpu().numpy())
        out["frames"].append(fixed[keep].cpu().numpy())
        out["repaired"].append(hit[keep].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def decode_extended(iq: torch.Tensor, chunk: int = 1 << 24) -> dict:
    """Extended mode over one loop -> offsets, kinds (LONG ...), frames
    (n, 14) uint8 (a short frame in the first 7 bytes, the rest 0), the AP
    address or interrogator code (0 for LONG and DF11) and repaired."""
    n = iq.shape[0]
    ext = cyclic(iq)
    out = {"offsets": [], "kinds": [], "frames": [], "address": [], "repaired": []}
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        m = magnitudes(ext[s : s + c + HALO])
        offs = torch.nonzero(gate(m, c, False)).flatten()
        rows = frame_bytes(m, offs)
        df = rows[:, 0].to(torch.int64) >> 3
        long_res = crc24(rows, 11) ^ field24(rows, 11)
        short_res = crc24(rows, 4) ^ field24(rows, 4)
        fixed, hit = repair1(rows, long_res)
        is_long = df >= 16
        ap_long = is_long & ((df == 16) | (df == 20) | (df == 21) | (df >= 24))
        sq = is_long & ~ap_long
        kind = torch.full_like(df, -1)
        kind[sq & ((long_res == 0) | hit)] = LONG
        kind[ap_long & (long_res != 0)] = LONG_AP
        short = ~is_long
        kind[short & (df == 11) & (short_res == 0)] = DF11
        kind[short & (df == 11) & (short_res != 0) & (short_res < 80)] = DF11_IC
        kind[short & ((df == 0) | (df == 4) | (df == 5)) & (short_res != 0)] = SHORT_AP
        keep = kind >= 0
        frames = torch.where((kind == LONG)[:, None], fixed, rows)
        frames[short] = torch.cat([frames[short][:, :7], torch.zeros_like(frames[short][:, 7:])], dim=1)
        address = torch.where(kind == LONG_AP, long_res, torch.where(short, short_res, 0))
        address = torch.where(kind == DF11, 0, address)
        out["offsets"].append((offs[keep] + s).cpu().numpy())
        out["kinds"].append(kind[keep].cpu().numpy())
        out["frames"].append(frames[keep].cpu().numpy())
        out["address"].append(address[keep].cpu().numpy())
        out["repaired"].append((hit & (kind == LONG))[keep].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def over_stream(loop: dict, n_loop: int, n_stream: int) -> dict:
    """One loop's frames repeated over a stream of n_stream samples that
    replays the capture: global offsets o + i * n_loop whose window ends
    inside the stream."""
    reps = -(-n_stream // n_loop)
    offs = (loop["offsets"][None, :] + n_loop * np.arange(reps)[:, None]).reshape(-1)
    keep = offs + 240 <= n_stream
    out = {k: np.concatenate([v] * reps)[keep] for k, v in loop.items() if k != "offsets"}
    out["offsets"] = offs[keep]
    return out


# --------------------------------------------------------------------------
# The plain tracker
# --------------------------------------------------------------------------

NZ = 15.0


def nl(lat: float) -> int:
    if lat == 0.0:
        return 59
    if lat in (87.0, -87.0):
        return 2
    if lat < -87.0 or lat > 87.0:
        return 1
    a = 1.0 - math.cos(math.pi / (2.0 * NZ))
    c = math.cos(math.pi / 180.0 * lat)
    return int(math.floor((2.0 * math.pi) / math.acos(1.0 - a / (c * c))))


def cpr_global(even: tuple[int, int], odd: tuple[int, int], newest_odd: bool) -> tuple[float, float] | None:
    """Airborne global decode of an even/odd pair, the newest frame's
    latitude, the reference's NL(lat - 1 degree) for a newest odd frame,
    fmod as the reference's `%`; None where the two latitudes' zone counts
    differ."""
    lat_e, lat_o = even[0] / 131072.0, odd[0] / 131072.0
    j = math.floor(59.0 * lat_e - 60.0 * lat_o + 0.5)
    even_lat = 360.0 / 60.0 * (math.fmod(j, 60.0) + lat_e)
    odd_lat = 360.0 / 59.0 * (math.fmod(j, 59.0) + lat_o)
    lat = odd_lat if newest_odd else even_lat
    if lat > 270.0:
        lat -= 360.0
    if nl(even_lat) != nl(odd_lat):
        return None
    lon_e, lon_o = even[1] / 131072.0, odd[1] / 131072.0
    zones = nl(lat)
    n = float(max(nl(lat - 1.0), 1)) if newest_odd else float(max(zones, 1))
    m = math.floor(lon_e * (zones - 1) - lon_o * zones + 0.5)
    lon = 360.0 / n * (math.fmod(m, n) + (lon_o if newest_odd else lon_e))
    while lon < -180.0:
        lon += 360.0
    while lon > 180.0:
        lon -= 360.0
    return lat, lon


def callsign(me: bytes) -> str:
    v = int.from_bytes(me[1:7], "big")
    return "".join(CHARSET[(v >> (42 - 6 * i)) & 0x3F] for i in range(8))


# DF18 control fields and DF19 application fields whose ME is laid out as
# an ADS-B squitter's (DO-260B 2.2.3.2.1.1: ADS-B from non-transponder
# emitters, fine-format TIS-B, ADS-R; DF19 AF 0).
DF18_ADSB_CF = (0, 1, 2, 5, 6)
VELOCITY_TC = 19


def ac13_altitude(ac13: int) -> int | None:
    """Feet from a 13-bit AC field (ICAO Annex 10 Vol IV 3.1.2.6.5.4):
    bits C1 A1 C2 A2 C4 A4 M B1 Q B2 D2 B4 D4; Q = 1 a binary count of 25
    ft above -1000 ft; Q = 0 the Gillham code in 100 ft steps; M = 1
    (metric) and codes that name no altitude give None."""
    bit = [(ac13 >> (12 - i)) & 1 for i in range(13)]
    c1, a1, c2, a2, c4, a4, m, b1, q, b2, d2, b4, d4 = bit
    if m:
        return None
    if q:
        n = 0
        for b in (c1, a1, c2, a2, c4, a4, b1, b2, d2, b4, d4):
            n = (n << 1) | b
        return n * 25 - 1000

    def gray(bits) -> int:
        n, acc = 0, 0
        for b in bits:
            acc ^= b
            n = (n << 1) | acc
        return n

    fives = gray((d2, d4, a1, a2, a4, b1, b2, b4))
    ones = gray((c1, c2, c4))
    if ones in (0, 5, 6):
        return None
    if ones == 7:
        ones = 5
    if fives % 2:
        ones = 6 - ones
    return fives * 500 + ones * 100 - 1300


def id13_squawk(id13: int) -> int:
    """The Mode A code from a 13-bit ID field (bits C1 A1 C2 A2 C4 A4 X B1
    D1 B2 D2 B4 D4), its four octal digits read as a decimal number."""
    bit = [(id13 >> (12 - i)) & 1 for i in range(13)]
    c1, a1, c2, a2, c4, a4, _, b1, d1, b2, d2, b4, d4 = bit
    return (4 * a4 + 2 * a2 + a1) * 1000 + (4 * b4 + 2 * b2 + b1) * 100 + (4 * c4 + 2 * c2 + c1) * 10 \
        + (4 * d4 + 2 * d2 + d1)


def velocity(me: bytes) -> tuple[float | None, float | None, int | None]:
    """(ground speed kt, track deg, vertical rate ft/min) of an airborne
    velocity ME (TC 19, DO-260B 2.2.3.2.6): subtypes 1 and 2 give the
    east and north speeds (value 0 no data, else value - 1, times 4 in
    subtype 2, sign 1 west or south); every subtype the vertical rate in
    64 ft/min steps (value 0 no data)."""
    subtype = me[0] & 7
    gs = track = None
    if subtype in (1, 2):
        sign_a, val_a = (me[1] >> 2) & 1, ((me[1] & 3) << 8) | me[2]
        sign_b, val_b = (me[3] >> 7) & 1, ((me[3] & 0x7F) << 3) | (me[4] >> 5)
        if val_a and val_b:
            scale = 4 if subtype == 2 else 1
            east = (val_a - 1) * scale * (-1 if sign_a else 1)
            north = (val_b - 1) * scale * (-1 if sign_b else 1)
            gs = math.hypot(east, north)
            track = math.degrees(math.atan2(east, north)) % 360.0
    vr_sign, vr_val = (me[4] >> 3) & 1, ((me[4] & 7) << 6) | (me[5] >> 2)
    vr = None if vr_val == 0 else (vr_val - 1) * 64 * (-1 if vr_sign else 1)
    return gs, track, vr


def is_squitter_me(f: bytes) -> bool:
    """The frame's ME is laid out as an ADS-B squitter's."""
    df = f[0] >> 3
    return df == 17 or (df == 18 and (f[0] & 7) in DF18_ADSB_CF) or (df == 19 and (f[0] & 7) == 0)


def table(frames: np.ndarray, kinds: np.ndarray | None = None, address: np.ndarray | None = None) -> dict:
    """The aircraft table after `frames` (n, 14) uint8, in stream order:
    ICAO -> callsign (of the last identification, or None), altitude (of
    the last airborne position, or AC13 reply), squawk (of the last DF5 or
    DF21 reply), ground speed, track and vertical rate (of the last
    velocity that carries them) and position (of the last even/odd pair
    that decodes). Every pair is in the reference's 10 s: an aircraft sends
    a position every half second of air.

    DF17 mode passes long squitters alone. Extended mode passes every
    frame the tracker takes, with its kind: long squitters and DF11
    all-calls upsert their address; AP-addressed replies (`address`) set
    the altitude (DF0, 4, 16, 20) or the squawk (DF5, 21)."""
    state: dict[int, dict] = {}
    data = frames.tobytes()
    for i in range(len(frames)):
        f = data[14 * i : 14 * i + 14]
        kind = LONG if kinds is None else int(kinds[i])
        icao = int(address[i]) if kind in (SHORT_AP, LONG_AP) else int.from_bytes(f[1:4], "big")
        a = state.setdefault(icao, {"callsign": None, "altitude": 0, "squawk": None, "ground_speed_kt": None,
                                    "track_deg": None, "vertical_rate_fpm": None, "position": None,
                                    "even": None, "odd": None})
        df = f[0] >> 3
        if kind in (SHORT_AP, LONG_AP):
            field = ((f[2] & 0x1F) << 8) | f[3]
            if df in (0, 4, 16, 20):
                alt = ac13_altitude(field)
                if alt is not None:
                    a["altitude"] = alt
            elif df in (5, 21):
                a["squawk"] = id13_squawk(field)
            continue
        if kind != LONG or not (df in (17, 18, 19) if kinds is None else is_squitter_me(f)):
            continue
        tc = f[4] >> 3
        if 1 <= tc <= 4:
            a["callsign"] = callsign(f[4:11])
        elif tc == VELOCITY_TC and kinds is not None:
            gs, track, vr = velocity(f[4:11])
            if gs is not None:
                a["ground_speed_kt"], a["track_deg"] = gs, track
            if vr is not None:
                a["vertical_rate_fpm"] = vr
        elif 9 <= tc <= 18:
            code = ((f[5] >> 1) << 4) | (f[6] >> 4)
            a["altitude"] = code * (25 if f[5] & 1 else 100) - 1000
            odd = bool(f[6] & 0b100)
            cpr = (((f[6] & 3) << 15) | (f[7] << 7) | (f[8] >> 1), ((f[8] & 1) << 16) | (f[9] << 8) | f[10])
            a["odd" if odd else "even"] = cpr
            other = a["even" if odd else "odd"]
            if other is not None:
                pos = cpr_global(other if odd else cpr, cpr if odd else other, odd)
                if pos is not None:
                    a["position"] = pos
    return {icao: {k: v for k, v in a.items() if k not in ("even", "odd")} for icao, a in state.items()}
