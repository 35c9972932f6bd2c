"""Mode S short (56-bit) and AP-addressed frames: the CRC over 32 data
bits and the synthetic frame makers (airjax/protocol/shortframe.py:35-64,
:183-374).

DF11's PI field is the CRC over the first 32 bits XOR'd with the
interrogator code (0 for acquisition squitters, which validate directly).
DF0/4/5/16/20/21/24 overlay the CRC with the aircraft address (AP = CRC
XOR ICAO), so crc_calc XOR parity_field is the transmitting aircraft's
ICAO, accepted only when that ICAO was validated recently
(airjax_torch.track.icao_cache).

A CRC-24 syndrome depends on the message length: data bit j of a 32-bit
message has the syndrome of data bit j + 56 of an 88-bit one (both are
x^(55 - j) mod G), so `_short_tables` equals the tail of the long table
(tests/test_torch_extended.py checks it; csrc/candidate.cu relies on it).

`extract_short_fields(_from_raw)` decode the short-frame fields of a
batch in plain torch; the batched extended decode runs them on the card
as csrc/fields.cu (airjax_torch/kernels/fields.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from airjax_torch.protocol.crc import CRC_BITS, crc24, pack_bits_msbfirst

SHORT_BITS = 56
SHORT_DATA_BITS = 32

DF_SHORT_SET = (0, 4, 5, 11)
DF_LONG_AP_SET = (16, 20, 21)


@functools.cache
def _short_tables() -> tuple[np.ndarray, np.ndarray]:
    """(crc matrix (32,24) uint8, syndromes (32,) uint32) for 4-byte
    messages (56-bit frame = 32 data bits + 24 parity bits)."""
    matrix = np.zeros((SHORT_DATA_BITS, CRC_BITS), dtype=np.uint8)
    syndromes = np.zeros((SHORT_DATA_BITS,), dtype=np.uint32)
    for j in range(SHORT_DATA_BITS):
        msg = bytearray(SHORT_DATA_BITS // 8)
        msg[j // 8] = 1 << (7 - j % 8)
        s = crc24(bytes(msg))
        syndromes[j] = s
        for k in range(CRC_BITS):
            matrix[j, k] = (s >> (CRC_BITS - 1 - k)) & 1
    return matrix, syndromes


def crc24_short_batch(bits32: torch.Tensor) -> torch.Tensor:
    """(..., 32) {0,1} -> (...,) int32 CRC over the data bits of short
    frames. The f32 product is exact: every column sum is <= 32."""
    matrix = torch.as_tensor(_short_tables()[0], dtype=torch.float32, device=bits32.device)
    sums = torch.matmul(bits32.to(torch.float32), matrix).to(torch.int32)
    return pack_bits_msbfirst(sums & 1, CRC_BITS)


def extract_short_fields(bits56: torch.Tensor) -> dict[str, torch.Tensor]:
    """(..., 56) {0,1} bits -> the short-frame fields
    (airjax/protocol/shortframe.py:67-175), (...)-shaped int32 tensors
    (crc_calc, parity_field and icao_ap are airjax's uint32, < 2^24) and
    `altitude_valid` bool. Which are meaningful depends on `df`:
      df, fs, dr, um          header fields (DF4/5)
      vs, cc, sl, ri          DF0/16 ACAS header fields
      capability, icao_aa     the CA and AA fields (DF11)
      crc_calc, parity_field  the CRC over the 32 data bits, the PI/AP field
      icao_ap                 crc_calc ^ parity_field: the address of an
                              AP-addressed DF4/5, the interrogator of a DF11
      altitude_ft / altitude_valid   the AC13 decode (Q=1 binary, Q=0
                              Gillham; M=1 metric unsupported)
      squawk                  ID13 -> the 4-digit octal identity code
    """
    b = bits56.to(torch.int32)

    def field(lo: int, width: int) -> torch.Tensor:
        return pack_bits_msbfirst(b[..., lo : lo + width], width)

    crc_calc = crc24_short_batch(b[..., :SHORT_DATA_BITS])
    parity_field = pack_bits_msbfirst(b[..., SHORT_DATA_BITS:SHORT_BITS], CRC_BITS)

    # AC13 (bits 19..31), transmitted C1 A1 C2 A2 C4 A4 M B1 Q B2 D2 B4 D4.
    ac13 = b[..., 19:32]
    m_bit, q_bit = ac13[..., 6], ac13[..., 8]
    n11 = torch.cat([ac13[..., 0:6], ac13[..., 7:8], ac13[..., 9:13]], dim=-1)
    alt_q1 = pack_bits_msbfirst(n11, 11) * 25 - 1000

    # Gillham (Q=0): the 3-bit reflected gray C1 C2 C4 counts 100s within a
    # 500 ft band; the 8-bit gray D2 D4 A1 A2 A4 B1 B2 B4 counts 500s.
    def gray2bin(g: torch.Tensor) -> torch.Tensor:
        g = g ^ (g >> 4)
        g = g ^ (g >> 2)
        return g ^ (g >> 1)

    c1, a1, c2, a2, c4, a4 = (ac13[..., i] for i in range(6))
    b1, b2, d2, b4, d4 = (ac13[..., i] for i in (7, 9, 10, 11, 12))
    c_gray = (c1 << 2) | (c2 << 1) | c4
    f_gray = (d2 << 7) | (d4 << 6) | (a1 << 5) | (a2 << 4) | (a4 << 3) | (b1 << 2) | (b2 << 1) | b4
    ones = gray2bin(c_gray)
    ones = torch.where((ones & 5) == 5, ones ^ 2, ones)  # 7 <-> 5 remap
    fives = gray2bin(f_gray)
    gillham_ok = (c_gray != 0) & (ones >= 1) & (ones <= 5)
    ones = torch.where((fives & 1) == 1, 6 - ones, ones)  # reflection
    alt_q0 = fives * 500 + ones * 100 - 1300

    # ID13 (the same bit positions): C1 A1 C2 A2 C4 A4 X B1 D1 B2 D2 B4 D4.
    d1 = ac13[..., 8]
    squawk = (((a4 << 2) | (a2 << 1) | a1) * 1000 + ((b4 << 2) | (b2 << 1) | b1) * 100
              + ((c4 << 2) | (c2 << 1) | c1) * 10 + ((d4 << 2) | (d2 << 1) | d1))

    return {
        "df": field(0, 5),
        "fs": field(5, 3),
        "dr": field(8, 5),
        "um": field(13, 6),
        "vs": field(5, 1),  # vertical status (1 = on ground)
        "cc": field(6, 1),  # crosslink capability (DF0)
        "sl": field(8, 3),  # ACAS sensitivity level
        "ri": field(13, 4),  # reply information
        "capability": field(5, 3),  # DF11: CA occupies the FS bits
        "icao_aa": field(8, 24),  # DF11: AA address
        "crc_calc": crc_calc,
        "parity_field": parity_field,
        "icao_ap": crc_calc ^ parity_field,
        "altitude_ft": torch.where(q_bit == 1, alt_q1, alt_q0),
        "altitude_valid": (m_bit == 0) & ((q_bit == 1) | gillham_ok),
        "squawk": squawk,
    }


def extract_short_fields_from_raw(frames_raw: torch.Tensor) -> dict[str, torch.Tensor]:
    """extract_short_fields of the first 7 bytes of raw frames (..., >= 7)
    uint8 (airjax/protocol/shortframe.py:337-349)."""
    raw7 = frames_raw[..., :7].to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=frames_raw.device)
    bits56 = ((raw7[..., None] >> shifts) & 1).reshape(*raw7.shape[:-1], SHORT_BITS)
    return extract_short_fields(bits56)


# ---------------------------------------------------------------------------
# Host-side frame assembly (for synth/tests)
# ---------------------------------------------------------------------------


def make_df11(icao: int, capability: int = 5, interrogator: int = 0) -> bytes:
    """Assemble a 7-byte DF11 all-call reply."""
    b0 = (11 << 3) | capability
    body = bytes([b0, (icao >> 16) & 0xFF, (icao >> 8) & 0xFF, icao & 0xFF])
    pi = crc24(body) ^ interrogator
    return body + bytes([(pi >> 16) & 0xFF, (pi >> 8) & 0xFF, pi & 0xFF])


def _ac13_from_altitude(altitude_ft: int) -> int:
    """Q=1 (25 ft) AC13 encoding."""
    n = (altitude_ft + 1000) // 25
    if not 0 <= n < 2048:
        raise ValueError("altitude out of AC13 Q=1 range")
    hi6 = (n >> 5) & 0x3F  # bits 0..5
    mid1 = (n >> 4) & 1  # bit 7 (M=0 at 6)
    lo4 = n & 0xF  # bits 9..12
    return (hi6 << 7) | (0 << 6) | (mid1 << 5) | (1 << 4) | lo4


def _ac13_gillham_from_altitude(altitude_ft: int) -> int:
    """Q=0 (100 ft Gillham gray) AC13 encoding — inverse of the AC13 decode
    (airjax_torch.extended._gillham_altitude_host). altitude must be a multiple of 100 in
    [-1200, 126700]."""
    if altitude_ft % 100 or not -1200 <= altitude_ft <= 126700:
        raise ValueError("altitude out of Gillham range / not a 100 ft step")
    total = altitude_ft // 100 + 13
    ones = (total - 1) % 5 + 1  # 1..5
    fives = (total - ones) // 5
    c_val = 6 - ones if fives & 1 else ones
    if c_val == 5:
        c_val = 7  # inverse of the decoder's 7->5 remap
    c_gray = c_val ^ (c_val >> 1)
    f_gray = fives ^ (fives >> 1)
    c1, c2, c4 = (c_gray >> 2) & 1, (c_gray >> 1) & 1, c_gray & 1
    d2 = (f_gray >> 7) & 1
    d4 = (f_gray >> 6) & 1
    a1 = (f_gray >> 5) & 1
    a2 = (f_gray >> 4) & 1
    a4 = (f_gray >> 3) & 1
    b1 = (f_gray >> 2) & 1
    b2 = (f_gray >> 1) & 1
    b4 = f_gray & 1
    bits = [c1, a1, c2, a2, c4, a4, 0, b1, 0, b2, d2, b4, d4]  # M=0, Q=0
    v = 0
    for bit in bits:
        v = (v << 1) | bit
    return v


def _id13_from_squawk(squawk: int) -> int:
    digits = [int(d) for d in f"{squawk:04d}"]
    a, b_, c, d = digits
    bits = [
        (c >> 0) & 1, (a >> 0) & 1, (c >> 1) & 1, (a >> 1) & 1,
        (c >> 2) & 1, (a >> 2) & 1, 0,
        (b_ >> 0) & 1, (d >> 0) & 1, (b_ >> 1) & 1, (d >> 1) & 1,
        (b_ >> 2) & 1, (d >> 2) & 1,
    ]
    v = 0
    for bit in bits:
        v = (v << 1) | bit
    return v


def _acas_header_word(
    df: int, altitude_ft: int, vs: int, cc: int, sl: int, ri: int,
    gillham: bool,
) -> int:
    """32-bit DF0/16 data word: DF VS CC _ SL __ RI __ AC13."""
    ac13 = (
        _ac13_gillham_from_altitude(altitude_ft)
        if gillham
        else _ac13_from_altitude(altitude_ft)
    )
    return (
        (df << 27) | (vs << 26) | (cc << 25) | (sl << 21) | (ri << 15) | ac13
    )


def make_df0(
    icao: int, altitude_ft: int, vs: int = 0, cc: int = 1, sl: int = 5,
    ri: int = 3, gillham: bool = False,
) -> bytes:
    """Assemble a 7-byte DF0 ACAS short air-air reply addressed via AP."""
    body = _acas_header_word(0, altitude_ft, vs, cc, sl, ri, gillham).to_bytes(
        4, "big"
    )
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_df16(
    icao: int, altitude_ft: int, mv: bytes = b"\x00" * 7, vs: int = 0,
    sl: int = 5, ri: int = 3, gillham: bool = False,
) -> bytes:
    """Assemble a 14-byte DF16 ACAS long air-air reply addressed via AP.

    `mv` is the 7-byte MV field (see airjax_torch.protocol.acas.make_mv_ra for
    RA reports)."""
    if len(mv) != 7:
        raise ValueError("MV field must be 7 bytes")
    body = (
        _acas_header_word(16, altitude_ft, vs, 0, sl, ri, gillham).to_bytes(
            4, "big"
        )
        + mv
    )
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_df4(
    icao: int, altitude_ft: int, fs: int = 0, dr: int = 0, um: int = 0,
    gillham: bool = False,
) -> bytes:
    """Assemble a 7-byte DF4 altitude reply addressed to `icao` (AP)."""
    ac13 = (
        _ac13_gillham_from_altitude(altitude_ft)
        if gillham
        else _ac13_from_altitude(altitude_ft)
    )
    word = (4 << 27) | (fs << 24) | (dr << 19) | (um << 13) | ac13
    body = word.to_bytes(4, "big")
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_df5(icao: int, squawk: int, fs: int = 0, dr: int = 0, um: int = 0) -> bytes:
    """Assemble a 7-byte DF5 identity reply addressed to `icao` (AP)."""
    id13 = _id13_from_squawk(squawk)
    word = (5 << 27) | (fs << 24) | (dr << 19) | (um << 13) | id13
    body = word.to_bytes(4, "big")
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_df20(
    icao: int, altitude_ft: int, mb: bytes = b"\x00" * 7, fs: int = 0, dr: int = 0, um: int = 0,
    gillham: bool = False,
) -> bytes:
    """Assemble a 14-byte DF20 Comm-B altitude reply addressed via AP."""
    if len(mb) != 7:
        raise ValueError("MB field must be 7 bytes")
    ac13 = (
        _ac13_gillham_from_altitude(altitude_ft)
        if gillham
        else _ac13_from_altitude(altitude_ft)
    )
    word = (20 << 27) | (fs << 24) | (dr << 19) | (um << 13) | ac13
    body = word.to_bytes(4, "big") + mb
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_df24(icao: int, nd: int = 0, md: bytes = b"\x00" * 10, ke: int = 0) -> bytes:
    """Assemble a 14-byte DF24 Comm-D ELM segment addressed via AP
    (first two bits '11', bit 4 KE, bits 5-8 ND, bits 9-88 MD)."""
    if len(md) != 10:
        raise ValueError("MD field must be 10 bytes")
    if not 0 <= nd <= 15:
        raise ValueError("ND must be 0-15")
    body = bytes([0b11000000 | ((ke & 1) << 4) | nd]) + md
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])


def make_df21(
    icao: int, squawk: int, mb: bytes = b"\x00" * 7, fs: int = 0, dr: int = 0, um: int = 0
) -> bytes:
    """Assemble a 14-byte DF21 Comm-B identity reply addressed via AP."""
    if len(mb) != 7:
        raise ValueError("MB field must be 7 bytes")
    id13 = _id13_from_squawk(squawk)
    word = (21 << 27) | (fs << 24) | (dr << 19) | (um << 13) | id13
    body = word.to_bytes(4, "big") + mb
    ap = crc24(body) ^ icao
    return body + bytes([(ap >> 16) & 0xFF, (ap >> 8) & 0xFF, ap & 0xFF])
