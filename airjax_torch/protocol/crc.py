"""Mode S CRC-24 with single-bit syndrome repair, and the opt-in 2-bit
repair (recover2), in numpy and plain torch (airjax/protocol/crc.py).

CRC-24 is linear over GF(2): crc(bits) = XOR of crc(e_i) over the set
data bits i, so a batch of frames is one (N, 88) @ (88, 24) product and a
parity. Flipping data bit j changes the CRC by the syndrome S_j = crc(e_j);
a failed frame is repaired iff its delta equals some S_j with j < 88.
Syndromes are pairwise distinct, so that j is unique, and a flip in the
CRC field can never validate (the reference compares against the original
packet CRC).

The tables are built here in numpy (the airjax module imports jax) and
read through `crc_matrix()` and `syndromes()`, as in airjax;
`load_tables` turns any such numpy pair — ours or airjax's — into the
tensors the torch functions take.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

GENERATOR = 0x1FFF409  # 25-bit polynomial
CRC_BITS = 24
DATA_BITS = 88
FRAME_BITS = 112
FRAME_BYTES = 14


def crc24(data: bytes | list[int] | np.ndarray) -> int:
    """Scalar bit-serial CRC-24 (airjax/protocol/crc.py:38-57)."""
    bits = []
    for byte in bytes(data):
        for i in range(7, -1, -1):
            bits.append((byte >> i) & 1)
    bits.extend([0] * CRC_BITS)

    for i in range(len(bits) - CRC_BITS):
        if bits[i]:
            for j in range(CRC_BITS + 1):
                bits[i + j] ^= (GENERATOR >> (CRC_BITS - j)) & 1

    remainder = 0
    for i in range(CRC_BITS):
        remainder = (remainder << 1) | bits[len(bits) - CRC_BITS + i]
    return remainder


@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(crc_matrix (88, 24) uint8, syndromes (88,) uint32), as
    airjax/protocol/crc.py:60-76 builds them."""
    matrix = np.zeros((DATA_BITS, CRC_BITS), dtype=np.uint8)
    syndromes = np.zeros((DATA_BITS,), dtype=np.uint32)
    for j in range(DATA_BITS):
        msg = bytearray(DATA_BITS // 8)
        msg[j // 8] = 1 << (7 - j % 8)
        s = crc24(bytes(msg))
        syndromes[j] = s
        for k in range(CRC_BITS):
            matrix[j, k] = (s >> (CRC_BITS - 1 - k)) & 1
    return matrix, syndromes


def crc_matrix() -> np.ndarray:
    """(88, 24) uint8: row j is crc24 of the unit message e_j, MSB first
    (airjax/protocol/crc.py:79-80)."""
    return _tables()[0]


def syndromes() -> np.ndarray:
    """(88,) uint32: S_j = crc24(e_j), the single-bit repair syndromes
    (airjax/protocol/crc.py:83-84)."""
    return _tables()[1]


@dataclasses.dataclass(frozen=True)
class CrcTables:
    matrix: torch.Tensor  # (88, 24) float32 {0, 1}
    syndromes: torch.Tensor  # (88,) int32, each < 2^24


def load_tables(
    crc_matrix: np.ndarray, syndromes: np.ndarray, device: torch.device | str
) -> CrcTables:
    """Numpy CRC tables -> the tensors the torch CRC functions take."""
    return CrcTables(
        matrix=torch.as_tensor(np.asarray(crc_matrix, np.float32), device=device),
        syndromes=torch.as_tensor(np.asarray(syndromes, np.int64).astype(np.int32), device=device),
    )


@functools.cache
def tables(device: torch.device | str = "cuda") -> CrcTables:
    """This module's tables on `device` (cached per device; the card
    unless the caller asks for "cpu")."""
    return load_tables(*_tables(), device)


def pack_bits_msbfirst(bits: torch.Tensor, width: int) -> torch.Tensor:
    """Pack a trailing axis of <= 31 {0,1} bits (MSB first) into int32."""
    weights = torch.ones(width, dtype=torch.int32, device=bits.device) << torch.arange(
        width - 1, -1, -1, dtype=torch.int32, device=bits.device
    )
    return (bits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def crc24_batch(bits88: torch.Tensor, tab: CrcTables | None = None) -> torch.Tensor:
    """(..., 88) {0,1} -> (...,) int32 CRC. The f32 product is exact:
    every column sum is an integer <= 88. `tab` defaults to this module's
    tables on the bits' device."""
    tab = tab or tables(bits88.device)
    sums = torch.matmul(bits88.to(torch.float32), tab.matrix).to(torch.int32)
    return pack_bits_msbfirst(sums & 1, CRC_BITS)


def crc_check_and_recover(
    bits112: torch.Tensor, tab: CrcTables | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 112) {0,1} bits -> (corrected bits, good (N,) bool, recovered
    (N,) bool), as airjax/protocol/crc.py:108-135; `tab` as crc24_batch's."""
    tab = tab or tables(bits112.device)
    calced = crc24_batch(bits112[..., :DATA_BITS], tab)
    packet_crc = pack_bits_msbfirst(bits112[..., DATA_BITS:], CRC_BITS)
    delta = calced ^ packet_crc
    ok = delta == 0
    match = delta[..., None] == tab.syndromes  # (N, 88)
    found = match.any(dim=-1) & ~ok
    # Unique match (distinct syndromes); never a flip in the CRC field.
    flip = torch.zeros_like(bits112)
    flip[..., :DATA_BITS] = match
    corrected = torch.where(found[..., None], bits112 ^ flip, bits112)
    return corrected, ok | found, found


def bytes_to_bits(frame_bytes: np.ndarray | bytes) -> np.ndarray:
    """(..., 14) uint8 or bytes -> (..., 112) {0,1} uint8, MSB first; a
    host helper (airjax/protocol/crc.py:192-197)."""
    if isinstance(frame_bytes, (bytes, bytearray)):
        arr = np.frombuffer(bytes(frame_bytes), dtype=np.uint8)
    else:
        arr = np.asarray(frame_bytes, dtype=np.uint8)
    return np.unpackbits(arr, axis=-1)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 112) {0,1} -> (..., 14) uint8, MSB first."""
    shaped = bits.reshape(bits.shape[:-1] + (FRAME_BYTES, 8)).to(torch.int32)
    weights = torch.ones(8, dtype=torch.int32, device=bits.device) << torch.arange(
        7, -1, -1, dtype=torch.int32, device=bits.device
    )
    return (shaped * weights).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


@functools.cache
def _pair_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pairwise-flip syndromes of 2-bit recovery
    (airjax/protocol/crc.py:138-156): S_i ^ S_j for data bits i < j < 88,
    (3828,) uint32, and the (i, j) index arrays.

    A collision between two pairs, or between a pair and a single bit,
    would need a codeword of weight 4 or 3; the Mode S CRC-24 has minimum
    distance 6 at 112 bits, so the table is unique, disjoint from the
    single-bit table and holds no 0 — asserted here."""
    s = _tables()[1].astype(np.uint32)
    i, j = np.triu_indices(DATA_BITS, k=1)
    pair = s[i] ^ s[j]
    assert len(np.unique(pair)) == len(pair), "pair syndrome collision"
    assert not np.intersect1d(pair, s).size, "pair/single syndrome overlap"
    assert not np.any(pair == 0)
    return pair, i.astype(np.int32), j.astype(np.int32)


def crc_check_and_recover2(
    bits112: torch.Tensor, tab: CrcTables | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 112) {0,1} bits -> (corrected bits, good (N,) bool: direct,
    1-flip or 2-flip, recovered (N,) bool: 1-flip, recovered2 (N,) bool:
    2-flip), as airjax/protocol/crc.py:159-189; `tab` as crc24_batch's.

    A >= 3-bit error can sit within distance 2 of a different codeword,
    so callers gate `recovered2` frames on an ICAO already validated
    without it (runner, extended assembly)."""
    corrected, good, recovered = crc_check_and_recover(bits112, tab)
    calced = crc24_batch(bits112[..., :DATA_BITS], tab)
    packet_crc = pack_bits_msbfirst(bits112[..., DATA_BITS:], CRC_BITS)
    delta = calced ^ packet_crc
    pair, pi, pj = _pair_tables()
    device = bits112.device
    match = delta[..., None] == torch.as_tensor(pair.astype(np.int32), device=device)  # (N, 3828)
    found2 = match.any(dim=-1) & ~good
    idx = match.to(torch.uint8).argmax(dim=-1)
    fi = torch.as_tensor(pi, device=device)[idx]
    fj = torch.as_tensor(pj, device=device)[idx]
    pos = torch.arange(FRAME_BITS, device=device)
    flip = (pos == fi[..., None]) | (pos == fj[..., None])
    corrected = torch.where(found2[..., None], bits112 ^ flip.to(bits112.dtype), corrected)
    return corrected, good | found2, recovered, found2


def try_crc_recovery2_scalar(frame: bytes) -> bytes | None:
    """Scalar 2-bit-flip repair from the same pair table
    (airjax/protocol/crc.py:207-224): the repaired 14-byte frame, or None
    when the delta matches no data-bit pair. Callers gate it as the
    batched consumers do."""
    packet_crc = (frame[-3] << 16) | (frame[-2] << 8) | frame[-1]
    delta = crc24(frame[:11]) ^ packet_crc
    pair, pi, pj = _pair_tables()
    hit = np.nonzero(pair == delta)[0]
    if not hit.size:
        return None
    i, j = int(pi[hit[0]]), int(pj[hit[0]])
    buf = bytearray(frame)
    buf[i // 8] ^= 1 << (7 - i % 8)
    buf[j // 8] ^= 1 << (7 - j % 8)
    return bytes(buf)


def try_crc_recovery_scalar(frame: bytes) -> bytes | None:
    """Scalar single-bit repair, every bit of the frame in order (the
    reference's src/adsb/crc.rs:49-65; airjax/protocol/crc.py:227-237):
    the first flip whose CRC then matches the packet's, or None. The
    golden oracle's repair."""
    buf = bytearray(frame)
    packet_crc = (buf[-3] << 16) | (buf[-2] << 8) | buf[-1]
    for num in range(len(buf)):
        for i in range(8):
            augmented = bytearray(buf)
            augmented[num] ^= 1 << (7 - i)
            if crc24(bytes(augmented[:-3])) == packet_crc:
                return bytes(augmented)
    return None
