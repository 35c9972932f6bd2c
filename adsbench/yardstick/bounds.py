"""The least time the card could take for a kernel's work: the bytes it
must move once over HBM's bandwidth (both kernels do a few integer
operations a byte, far from the compute peaks, so bytes bound them). Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
its 700 W limit). The byte counts are this benchmark's own, from the
shapes of a block and the candidates its traffic gives, and do not read
the program."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TILE = 8192  # offsets a tile count covers


def words(n_bits: int) -> int:
    return -(-n_bits // 32)


def front_bytes(n_samples: int, n_off: int) -> int:
    """The front over one block: each sample's 4 bytes of IQ read; per
    offset a gate bit and per sample a compare bit written, as 32-bit words;
    a 4-byte count per tile of offsets."""
    return 4 * n_samples + 4 * words(n_off) + 4 * words(n_samples) + 4 * -(-n_off // TILE)


# Bytes a candidate's row of the decode's dict needs, written once:
# DF17: offset 4, frame 14, valid and repaired flags 1 each.
# Extended adds the raw frame 14, the DF 1, four more class flags 1 each,
# two 24-bit addresses as 4 each. The fields (flag F) add the long frame's
# (ICAO 4, DF, subtype and class 1 each, altitude 4, CPR parity 1 and
# lat / lon 4 each, seven velocity fields 4 each, eight callsign codes 1
# each: 56) and the short frame's (flight status 1, altitude 4 and its
# valid flag 1, squawk 4, VS, SL and RI 1 each: 13).
ROW_BYTES = {
    (False, False): 20,
    (False, True): 20 + 56,
    (True, False): 20 + 27,
    (True, True): 20 + 27 + 56 + 13,
}
# A candidate's 224 compare bits, read as whole words (one more for a
# start inside a word).
CANDIDATE_READ_BYTES = 4 * (words(224) + 1)


def block_decode_bytes(n_off: int, candidates: float, extended: bool, fields: bool) -> float:
    """The block decode over one block with `candidates` gate passes: the
    gate words and tile counts read once, each candidate's compare words
    read and its row written."""
    fixed = 4 * words(n_off) + 4 * -(-n_off // TILE)
    return fixed + candidates * (CANDIDATE_READ_BYTES + ROW_BYTES[(extended, fields)])


def bound_s(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S
