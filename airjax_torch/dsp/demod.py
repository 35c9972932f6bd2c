"""Preamble/DF17 detection, ordered compaction, PPM bit slicing and packed
compares in plain torch (airjax/dsp/demod.py).

An offset i is a detection iff the four preamble highs are all >= the
twelve preamble lows and the five DF17 highs are all >= the five DF17
lows (airjax/dsp/demod.py:44-64). Candidate bit t of a detection at o is
cmp[o + 16 + 2t] with cmp[i] = mag[i] > mag[i+1], read from the compares
packed 32 per word (airjax/dsp/demod.py:222-306).

Magnitudes are int32 (airjax_torch.dsp.magnitude); packed words are held
as int32 with the uint32 bit pattern of airjax's words (compare them
through `.numpy().view(np.uint32)`).

The decode paths run detect / detect_preamble_only, compact_detections,
pack_cmp_words and slice_bits_packed (as plain versions of the kernels);
slice_bits, slice_bits_sparse_bytes and pack_cmp_words_reduce are airjax's
other formulations of the same bits, kept with its names and results.
"""

from __future__ import annotations

import functools

import torch

# Mode S preamble and DF=17 pattern taps (airjax/dsp/demod.py:28-37).
PREAMBLE_HIGHS = (0, 2, 7, 9)
PREAMBLE_LOWS = (1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15)
DF17_HIGHS = (16, 19, 21, 23, 24)
DF17_LOWS = (17, 18, 20, 22, 25)

WINDOW = 240  # 16 preamble + 224 data samples
DATA_OFFSET = 16
FRAME_SAMPLES = 224
FRAME_BITS = 112

WORDS_PER_CAND = 8  # ceil((31 + 223) / 32): any 32-bit alignment of a frame

# airjax's compaction tile (airjax/dsp/demod.py:67); the cumsum form below
# needs none, and gives the same result for every tile.
COMPACT_TILE = 512


def _shifted(mags: torch.Tensor, shift: int, n_off: int) -> torch.Tensor:
    return mags[..., shift : shift + n_off]


def detect(mags: torch.Tensor, n_off: int) -> torch.Tensor:
    """(..., L) int32 magnitudes, L >= n_off + 25 -> (..., n_off) bool
    (airjax/dsp/demod.py:44-64)."""
    if mags.shape[-1] < n_off + DF17_LOWS[-1]:
        raise ValueError(f"detect needs {n_off + 25} samples, got {mags.shape[-1]}")
    hmin = functools.reduce(torch.minimum, (_shifted(mags, s, n_off) for s in PREAMBLE_HIGHS))
    lmax = functools.reduce(torch.maximum, (_shifted(mags, s, n_off) for s in PREAMBLE_LOWS))
    dmin = functools.reduce(torch.minimum, (_shifted(mags, s, n_off) for s in DF17_HIGHS))
    dmax = functools.reduce(torch.maximum, (_shifted(mags, s, n_off) for s in DF17_LOWS))
    return (hmin >= lmax) & (dmin >= dmax)


def detect_preamble_only(mags: torch.Tensor, n_off: int) -> torch.Tensor:
    """The preamble gate alone, without the DF17 check, for the extended
    decode of every downlink format (airjax/dsp/demod.py:70-84): downstream
    CRC and address checks do the filtering. (..., L) -> (..., n_off) bool."""
    hmin = functools.reduce(torch.minimum, (_shifted(mags, s, n_off) for s in PREAMBLE_HIGHS))
    lmax = functools.reduce(torch.maximum, (_shifted(mags, s, n_off) for s in PREAMBLE_LOWS))
    return hmin >= lmax


def compact_detections(
    det: torch.Tensor, max_candidates: int, tile: int = COMPACT_TILE
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n_off,) bool or uint8 mask -> ascending candidate offsets
    (airjax/dsp/demod.py:87-126, same semantics without the TPU tiles).

    Returns (offsets (K,) int32 with invalid slots = n_off, valid (K,)
    bool, n_detections () int32). Detections past capacity are dropped;
    the count still includes them, so callers can flag overflow. A
    cumsum plus one searchsorted: no host synchronisation on either
    device. `tile` is airjax's tile of offsets; its result is the same
    for every tile >= 1, and so is this one's, which checks it and
    otherwise needs none.
    """
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    n_off = det.shape[-1]
    cum = torch.cumsum(det, dim=0, dtype=torch.int32)
    total = cum[-1] if n_off else torch.zeros((), dtype=torch.int32, device=det.device)
    ranks = torch.arange(1, max_candidates + 1, dtype=torch.int32, device=det.device)
    # The rank-th detection is the first position whose running count
    # reaches the rank; ranks past the total search to n_off.
    offsets = torch.searchsorted(cum, ranks, side="left", out_int32=True)
    valid = ranks <= total
    offsets = torch.where(valid, offsets, n_off)
    return offsets, valid, total


def n_words(n_samples: int) -> int:
    """Length of pack_cmp_words' output for n_samples magnitudes: the
    (L-1) compares in whole 128-bit rows, then WORDS_PER_CAND zero words."""
    return 4 * (-(-(n_samples - 1) // 128)) + WORDS_PER_CAND


def pack_cmp_words(mags: torch.Tensor) -> torch.Tensor:
    """(L,) int32 magnitudes -> (n_words(L),) int32 packed compares
    (airjax/dsp/demod.py:222-250's layout; not its MXU formulation).

    Word w holds cmp[32w .. 32w+31], MSB first; compares past L-2 are 0,
    and the last WORDS_PER_CAND words are zero padding for the
    candidate gather.
    """
    return pack_msb_words(mags[:-1] > mags[1:], n_words(mags.shape[0]))


def _msb_weights(device: torch.device) -> torch.Tensor:
    return torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        31, -1, -1, dtype=torch.int64, device=device
    )


def pack_msb_words(bits: torch.Tensor, total: int) -> torch.Tensor:
    """(m,) bool/uint8 bits, m <= 32 * total -> (total,) int32 words: word w
    holds bits[32w .. 32w+31], MSB first; bits past m are 0 (the layout of
    pack_cmp_words, and of the front kernel's detection words)."""
    padded = torch.zeros(total * 32, dtype=torch.int64, device=bits.device)
    padded[: bits.shape[0]] = bits
    words = (padded.view(total, 32) * _msb_weights(bits.device)).sum(dim=1)
    # uint32 bit pattern -> int32 (two's complement), without relying on
    # how an out-of-range int64 -> int32 cast behaves.
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_msb_words(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The inverse of pack_msb_words: (W,) int32 words -> (n_bits,) bool,
    n_bits <= 32 * W."""
    bits = (words.to(torch.int64)[:, None] & _msb_weights(words.device)) != 0
    return bits.reshape(-1)[:n_bits]


def dynamic_start(start: torch.Tensor, length: int, size: int = 1) -> torch.Tensor:
    """Where jax.lax.dynamic_slice starts a `size` slice of a `length` axis
    asked to start at `start`: a negative start counts from the end (its
    default allow_negative_indices), then the start is clamped into
    [0, length - size], so the slice always lies inside. With size 1 it is
    the element a jnp gather reads at an index out of range."""
    return torch.where(start < 0, start + length, start).clamp(0, length - size)


def pack_cmp_words_reduce(mags: torch.Tensor) -> torch.Tensor:
    """(L,) magnitudes -> (ceil((L-1)/32) + WORDS_PER_CAND,) int32 packed
    compares, airjax's reduce form ((N/32, 32) x the MSB weights,
    airjax/dsp/demod.py:272-282). Its words are pack_cmp_words' bit for
    bit, without the padding to whole 128-bit rows: the same
    WORDS_PER_CAND zero words follow the last compare word."""
    return pack_msb_words(mags[:-1] > mags[1:], -(-(mags.shape[0] - 1) // 32) + WORDS_PER_CAND)


def slice_bits(mags: torch.Tensor, offsets) -> torch.Tensor:
    """(L,) magnitudes x (K,) offsets -> (K, 112) uint8 bits, bit_k =
    mag[o+16+2k] > mag[o+16+2k+1] (airjax/dsp/demod.py:129-145): a gather
    of each candidate's window. The window starts where airjax's
    dynamic_slice starts it (dynamic_start): an offset past L - 240 slices
    the last window, and one below -16 counts from the end."""
    if mags.shape[0] < FRAME_SAMPLES:
        raise ValueError(f"slice_bits needs at least {FRAME_SAMPLES} magnitudes, got {mags.shape[0]}")
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=mags.device)
    start = dynamic_start(offsets + DATA_OFFSET, mags.shape[0], FRAME_SAMPLES)
    window = mags[start[:, None] + torch.arange(FRAME_SAMPLES, device=mags.device)].to(torch.int64)
    return (window[:, 0::2] > window[:, 1::2]).to(torch.uint8)


def slice_bits_sparse_bytes(pbytes: torch.Tensor, offsets) -> torch.Tensor:
    """(K,) offsets -> (K, 112) uint8 bits from airjax's sparse byte plane
    (airjax/kernels/magdet.py::magdet_packed; airjax/dsp/demod.py:199-219):
    byte B, the compare bits [8B, 8B+8) MSB first, sits at flat position
    (B >> 4) * 128 + (B & 15) * 8.

    No path of the port writes that layout (its front writes the dense
    words of pack_cmp_words); this reads airjax's plane, given as a
    (n,) uint8 tensor, into the same bits as slice_bits. A position out of
    the plane reads what airjax's gather reads there (dynamic_start)."""
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=pbytes.device)
    t = torch.arange(FRAME_BITS, dtype=torch.int64, device=pbytes.device)
    p = (offsets + DATA_OFFSET)[:, None] + 2 * t[None, :]  # (K, 112) compare bit positions
    byte_idx = p >> 3
    pos = dynamic_start(((byte_idx >> 4) << 7) + ((byte_idx & 15) << 3), pbytes.shape[0])
    byte = pbytes[pos].to(torch.int64)
    return ((byte >> (7 - (p & 7))) & 1).to(torch.uint8)


def slice_bits_packed(words: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(K,) offsets -> (K, 112) uint8 bits via 8 word gathers per candidate
    (airjax/dsp/demod.py:285-306).

    A word index out of the array reads what airjax's gather reads there
    (dynamic_start); in-range offsets (o + WINDOW <= L) never need it.
    """
    d0 = offsets.to(torch.int64) + DATA_OFFSET
    word0 = d0 >> 5
    align = d0 & 31
    j = torch.arange(WORDS_PER_CAND, dtype=torch.int64, device=words.device)
    idx = dynamic_start(word0[:, None] + j[None, :], words.shape[0])
    gathered = words.to(torch.int64)[idx] & 0xFFFFFFFF  # (K, 8) as unsigned
    t = torch.arange(FRAME_BITS, dtype=torch.int64, device=words.device)
    pos = align[:, None] + 2 * t[None, :]  # (K, 112) in [0, 253]
    sel = torch.gather(gathered, 1, pos >> 5)
    return ((sel >> (31 - (pos & 31))) & 1).to(torch.uint8)


def threshold_slice_bits(
    mags: torch.Tensor, offsets: torch.Tensor, high, derate: float = 0.9
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's dead threshold slicer (`extract_manchester_threshold`,
    demod.rs:142-173, #[allow(dead_code)]), in plain torch
    (airjax/dsp/demod.py:148-196). No decode path runs it: the reference's
    author measured it worse than the relative slicer.

    Each half-bit of the frame at offset o is sliced against the derated
    `high` (per offset, or one for all); a pair of equal halves is invalid
    and decodes as 0, and a frame with more than 2 invalid pairs in any
    byte is rejected. A tenth derate is exact in integers (x * 9 // 10
    equals the reference's f64 truncation over the magnitude range, as
    airjax proves), another one goes through float32. Windows start where
    airjax's dynamic_slice starts them (dynamic_start).
    -> (bits (K, 112) uint8, ok (K,) bool)."""
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=mags.device)
    high = torch.as_tensor(high, device=mags.device).to(torch.int64).expand(offsets.shape)
    num = derate * 10.0
    if num == int(num):
        threshold = high * int(num) // 10
    else:
        threshold = (high.to(torch.float32) * derate).to(torch.int64)
    start = dynamic_start(offsets + DATA_OFFSET, mags.shape[0], min(FRAME_SAMPLES, mags.shape[0]))
    window = mags.to(torch.int64)[start[:, None] + torch.arange(FRAME_SAMPLES, device=mags.device)]
    first = window[:, 0::2] > threshold[:, None]
    second = window[:, 1::2] > threshold[:, None]
    valid = first != second
    bits = (first & valid).to(torch.uint8)
    per_byte = (~valid).reshape(-1, FRAME_BITS // 8, 8).sum(dim=2)
    return bits, (per_byte <= 2).all(dim=1)
