"""Block-decode kernel wrapper: what the front kernel writes (detection
bits, packed compares, detections per tile) -> the block's whole candidate
dict, in one launch.

No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
compact_detections (:87-126) with the candidate stage of airjax/
pipeline.py (:82-105 for DF17, :200-270 for the extended decode). Here
it is csrc/block_decode.cu: one block per 8 tiles of TILE offsets ranks
their detections and decodes each where it is found, and the dict's
flags, counts and empty slots are written by the same launch. The staged
chain it replaces on the decode paths, compact_bits ->
decode_candidates(_extended) -> `candidate_dict(_extended)`, is its plain
version and its A/B baseline (without recover2).

recover2=True (`adsb --recover2`) is the kernel's R2 flag in either mode:
a delta that matches no single-bit syndrome is looked up among the 3828
pair syndromes of airjax/protocol/crc.py::crc_check_and_recover2
(:159-189); the dict gains `recovered2`. The lookup is one probe of a
two-choice bucketed hash (`pair_hash_table`): PAIR_BUCKETS = 1024 buckets
of 4 entries {syndrome, i | j << 8}, 32 B a bucket (one sector), 32 KB in
all at load 0.93, each syndrome in bucket h1 or h2 (`pair_buckets`:
(d * m mod 2^32) >> 22, m = 0x9E3779B1 or 0x85EBCA77), placed by cuckoo
displacement from a fixed seed. The kernel loads both buckets at once and
compares 8 keys: one round trip where a binary search of the sorted
table took 12 dependent ones. The table is built on the host and
uploaded once per device.

fields=True is the kernel's F flag, the batched decodes' protocol fields
(airjax/pipeline.py:287-328): the dict gains `fields` (extract_fields of
the frames) and, extended, `short_fields` (extract_short_fields_from_raw
of the raw frames), written by the same launch into the buffers of
kernels/fields.py.

`decode_block_bits` launches the kernel for CUDA tensors and runs
`decode_block_bits_plain` for CPU tensors. `launches` counts kernel
launches, all eight instantiations together; `fields_launches` those of
the four with F.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.kernels import candidate
from airjax_torch.kernels.candidate import CLASSES
from airjax_torch.kernels.compact import Compacted, compact_bits_plain
from airjax_torch.kernels.fields import block_fields_plain, field_sizes, field_views
from airjax_torch.kernels.magdet import n_det_words, n_tiles
from airjax_torch.protocol.crc import FRAME_BYTES, _pair_tables

launches = 0
fields_launches = 0
_pairs_on: dict[torch.device, torch.Tensor] = {}  # device -> pair_hash_table() there

# The pair table's hash, as csrc/candidate.cuh (kPairBuckets, kHashShift,
# kHashM1, kHashM2).
PAIR_BUCKETS = 1024
BUCKET_ENTRIES = 4
HASH_SHIFT = 22
HASH_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77)
_CUCKOO_SEED = 0
_MAX_KICKS = 10_000


def pair_buckets(delta) -> tuple[np.ndarray, np.ndarray]:
    """The two buckets h1, h2 of each 24-bit key: (d * m mod 2^32) >> 22."""
    d = np.asarray(delta, dtype=np.uint64)
    return tuple(((d * np.uint64(m)) & np.uint64(0xFFFFFFFF)) >> np.uint64(HASH_SHIFT) for m in HASH_MULTIPLIERS)


def pair_hash_table() -> np.ndarray:
    """(PAIR_BUCKETS, 4, 2) uint32: each entry {pair syndrome, i | j << 8},
    {0, 0} where empty; every syndrome in bucket h1 or h2 of itself
    (`pair_buckets`), placed by cuckoo displacement from a fixed seed, so
    every build is the same. Raises if a key cannot be placed."""
    pair, pi, pj = _pair_tables()
    h1, h2 = pair_buckets(pair)
    home = {int(d): (int(a), int(b)) for d, a, b in zip(pair, h1, h2)}
    table = np.zeros((PAIR_BUCKETS, BUCKET_ENTRIES, 2), np.uint32)
    fill = [0] * PAIR_BUCKETS
    rng = np.random.default_rng(_CUCKOO_SEED)
    for key, value in zip(pair.tolist(), (pi | pj << 8).tolist()):
        for _ in range(_MAX_KICKS):
            b1, b2 = home[key]
            b = b1 if fill[b1] < BUCKET_ENTRIES else b2 if fill[b2] < BUCKET_ENTRIES else None
            if b is not None:
                table[b, fill[b]] = key, value
                fill[b] += 1
                break
            # Both full: take a random entry's place and move it on.
            b, e = (b1, b2)[int(rng.integers(2))], int(rng.integers(BUCKET_ENTRIES))
            (key, value), table[b, e] = table[b, e].tolist(), (key, value)
        else:
            raise RuntimeError(f"pair table: no place for syndrome {key:#08x} after {_MAX_KICKS} moves")
    return table


def candidate_dict(compacted: Compacted, words, capacity, candidates) -> dict[str, torch.Tensor]:
    """airjax's DF17 dict (airjax/pipeline.py:94-105) from the compaction
    and `candidates` (the candidate kernel's wrapper or its plain version);
    invalid slots decode at offset 0."""
    offsets, valid, n_det, gather = compacted
    frames, crc_ok, recovered, *recovered2 = candidates(words, gather)
    good = crc_ok & valid
    out = {
        "offsets": offsets,
        "valid": valid,
        "good": good,
        "recovered": recovered & valid,
        "frames": frames,
        "n_detections": n_det,
        "n_good": good.sum(dtype=torch.int32),
        "overflow": n_det > capacity,
    }
    if recovered2:  # the recover2 candidate stage's fourth output
        out["recovered2"] = recovered2[0] & valid
    return out


def candidate_dict_extended(compacted: Compacted, words, capacity, candidates) -> dict[str, torch.Tensor]:
    """airjax's extended dict (airjax/pipeline.py:254-270; its AP residuals
    are uint32, int32 here, all < 2^24) from the compaction and
    `candidates` (the extended candidate wrapper or its plain version)."""
    offsets, valid, n_det, gather = compacted
    return {
        "offsets": offsets,
        "valid": valid,
        **candidates(words, gather, valid),
        "n_detections": n_det,
        "overflow": n_det > capacity,
    }


def decode_block_bits_plain(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    *, extended: bool = False, recover2: bool = False, fields: bool = False,
) -> dict[str, torch.Tensor]:
    """Plain torch version: compact_bits_plain, then the plain candidate
    stage and the dict ops, then with fields=True block_fields_plain."""
    compacted = compact_bits_plain(det_words, tile_counts, n_off, capacity)
    if extended:
        plain = functools.partial(candidate.decode_candidates_extended_plain, recover2=recover2)
        out = candidate_dict_extended(compacted, words, capacity, plain)
    else:
        plain = functools.partial(candidate.decode_candidates_plain, recover2=recover2)
        out = candidate_dict(compacted, words, capacity, plain)
    if fields:
        out["fields"], short = block_fields_plain(out["frames"], out["frames_raw"] if extended else None)
        if extended:
            out["short_fields"] = short
    return out


def decode_block_bits(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    *, extended: bool = False, recover2: bool = False, fields: bool = False,
) -> dict[str, torch.Tensor]:
    """(ceil(n_off/32),) int32 detection words (bit 31-k of word w: offset
    32w+k), (W,) int32 packed compares and (ceil(n_off/TILE),) int32 tile
    counts (kernels/magdet.py::magdet_bits) -> airjax's candidate dict for
    capacity K = `capacity`: DF17's (offsets, valid, good, recovered,
    frames, n_detections, n_good, overflow), or with extended=True the
    extended decode's (offsets, valid, df, frames, frames_raw, the six
    classes, icao_ap_short, icao_ap_long, n_detections, overflow); with
    recover2=True also `recovered2` (K,) bool, the 2-flip repairs; with
    fields=True also `fields` and, extended, `short_fields` (the dicts of
    kernels/fields.py::block_fields)."""
    check_tensor(det_words, "det_words", torch.int32, 1)
    check_tensor(words, "words", torch.int32, 1)
    check_tensor(tile_counts, "tile_counts", torch.int32, 1)
    if n_off < 0 or det_words.shape[0] != n_det_words(n_off):
        raise ValueError(f"det_words: expected {n_det_words(max(n_off, 0))} words for n_off={n_off}")
    if tile_counts.shape[0] != n_tiles(n_off):
        raise ValueError(f"tile_counts: expected {n_tiles(n_off)} tiles for n_off={n_off}")
    if words.numel() == 0:
        raise ValueError("words: empty")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if use_kernel(det_words, words, tile_counts):
        if det_words.data_ptr() % 16:
            raise ValueError("det_words: the kernel reads them 16 bytes at a time; pointer not aligned")
        return _block_decode_cuda(det_words, words, tile_counts, n_off, capacity, extended, recover2, fields)
    return decode_block_bits_plain(det_words, words, tile_counts, n_off, capacity, extended=extended,
                                   recover2=recover2, fields=fields)


def _pairs(device: torch.device) -> torch.Tensor:
    """pair_hash_table() on `device` (a tensor's, so with its index),
    uploaded once per device."""
    if device not in _pairs_on:
        _pairs_on[device] = torch.as_tensor(pair_hash_table().reshape(-1).view(np.int32)).to(device)
    return _pairs_on[device]


def _block_decode_cuda(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    extended: bool, recover2: bool = False, fields: bool = False,
) -> dict[str, torch.Tensor]:
    global launches, fields_launches
    from airjax_torch._build import library

    lib = library()
    device = det_words.device
    k = capacity
    # One int32 buffer and one byte buffer, sliced into the outputs: on the
    # card an allocation costs more host time than a slice. The fields'
    # ints follow the dict's, their bytes lead (4-byte aligned).
    n_int = (4 * k + 1) if extended else (k + 2)
    n_byte = k * (2 * FRAME_BYTES + 1 + len(CLASSES)) + 1 if extended else k * (FRAME_BYTES + 3) + 1
    n_byte += k if recover2 else 0  # recovered2, after the mode's outputs
    n_field_int, n_field_byte = field_sizes(k, extended) if fields else (0, 0)
    all_ints = torch.empty(n_int + n_field_int, dtype=torch.int32, device=device)
    all_byts = torch.empty(n_field_byte + n_byte, dtype=torch.uint8, device=device)
    ints, field_ints = all_ints[:n_int], all_ints[n_int:]
    field_byts, byts = all_byts[:n_field_byte], all_byts[n_field_byte:]
    offsets, n_det = ints[:k], ints[-1]
    frames = byts[: FRAME_BYTES * k].view(k, FRAME_BYTES)
    valid = byts[FRAME_BYTES * k : (FRAME_BYTES + 1) * k].view(torch.bool)
    overflow = byts[-1:].view(torch.bool)[0]
    rest = byts[(FRAME_BYTES + 1) * k : n_byte - 1 - (k if recover2 else 0)]
    recovered2 = byts[n_byte - 1 - k : -1].view(torch.bool) if recover2 else None
    if extended:
        frames_raw = rest[: FRAME_BYTES * k].view(k, FRAME_BYTES)
        classes = rest[FRAME_BYTES * k :].view(torch.bool).view(len(CLASSES), k)
        df, icao_long, icao_short = ints[k : 2 * k], ints[2 * k : 3 * k], ints[3 * k : 4 * k]
        mode_out = (None, None, None, frames_raw, df, icao_long, icao_short, classes)
    else:
        good, recovered = rest[:k].view(torch.bool), rest[k:].view(torch.bool)
        n_good = ints[k]
        mode_out = (good, recovered, n_good, None, None, None, None, None)
    with torch.cuda.device(device):
        candidate.load_syndromes(lib)
        rc = lib.airjax_block_decode(
            det_words.data_ptr(), words.data_ptr(), words.numel(), tile_counts.data_ptr(), n_off, k,
            offsets.data_ptr(), valid.data_ptr(), frames.data_ptr(), n_det.data_ptr(), overflow.data_ptr(),
            *(None if t is None else t.data_ptr() for t in mode_out),
            None if recovered2 is None else recovered2.data_ptr(),
            _pairs(device).data_ptr() if recover2 else None,
            field_ints.data_ptr() if fields else None, field_byts.data_ptr() if fields else None,
            int(extended), int(recover2), int(fields),  # the kernel's Mode, R2, F
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "block-decode kernel")
    launches += 1
    fields_launches += fields
    if extended:
        out = {
            "offsets": offsets, "valid": valid, "df": df, "frames": frames, "frames_raw": frames_raw,
            **dict(zip(CLASSES, classes.unbind(0))),
            "icao_ap_short": icao_short, "icao_ap_long": icao_long,
            "n_detections": n_det, "overflow": overflow,
        }
    else:
        out = {
            "offsets": offsets, "valid": valid, "good": good, "recovered": recovered, "frames": frames,
            "n_detections": n_det, "n_good": n_good, "overflow": overflow,
        }
    if recover2:
        out["recovered2"] = recovered2
    if fields:
        out["fields"], short = field_views(field_ints, field_byts, k, extended)
        if extended:
            out["short_fields"] = short
    return out
