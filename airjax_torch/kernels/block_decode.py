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
`decode_block_bits_plain` for CPU tensors; `decode_block_bits_into` does
the same into two buffers the caller keeps (a CUDA graph's outputs,
pipeline.BlockGraphs). `dict_layout` is the one definition of where each
key of the dict lies in those two buffers: the device wrapper's views and
the host's views of a fetched copy are both built from it. `launches` counts kernel
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
from airjax_torch.kernels.fields import (
    DictLayout,
    block_fields_plain,
    check_layout_buffers,
    field_layout,
    field_sizes,
    fill_layout,
    layout_views,
)
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


@functools.cache
def dict_layout(capacity: int, extended: bool = False, recover2: bool = False, fields: bool = False) -> DictLayout:
    """The one definition of the dict's layout in the kernel's buffers
    (csrc/block_decode.cu's Out and Fields), read on the device by
    decode_block_bits and on the host by a fetch of the buffers
    (pipeline.BlockGraphs). The int32 buffer: offsets (K), then DF17's
    n_good or the extended df, icao_ap_long and icao_ap_short (K each),
    then n_detections; the fields' int rows follow. The byte buffer: the
    fields' bytes (4-byte aligned), then frames (K, 14), valid, DF17's good
    and recovered or the extended frames_raw (K, 14) and the six classes,
    recovered2 (R2), and last overflow."""
    k = capacity
    n_int = (4 * k + 1) if extended else (k + 2)
    n_byte = k * (2 * FRAME_BYTES + 1 + len(CLASSES)) + 1 if extended else k * (FRAME_BYTES + 3) + 1
    n_byte += k if recover2 else 0  # recovered2, after the mode's outputs
    n_field_int, b = field_sizes(k, extended) if fields else (0, 0)  # b: where the dict's bytes start
    rest = b + (FRAME_BYTES + 1) * k  # the mode's bytes after frames and valid

    def i(key, start, shape=(k,)):
        return ((key,), "i", start, shape, False)

    def by(key, start, shape=(k,), as_bool=True):
        return ((key,), "b", start, shape, as_bool)

    head = [i("offsets", 0), by("valid", b + FRAME_BYTES * k)]
    frames = by("frames", b, (k, FRAME_BYTES), False)
    if extended:
        classes = [by(name, rest + FRAME_BYTES * k + c * k) for c, name in enumerate(CLASSES)]
        entries = [*head, i("df", k), frames, by("frames_raw", rest, (k, FRAME_BYTES), False), *classes,
                   i("icao_ap_short", 3 * k), i("icao_ap_long", 2 * k), i("n_detections", n_int - 1, ())]
    else:
        entries = [*head, by("good", rest), by("recovered", rest + k), frames,
                   i("n_detections", n_int - 1, ()), i("n_good", k, ())]
    entries.append(by("overflow", b + n_byte - 1, ()))
    if recover2:
        entries.append(by("recovered2", b + n_byte - 1 - k))
    if fields:
        entries += [(path, buf, start + (n_int if buf == "i" else 0), shape, as_bool)
                    for path, buf, start, shape, as_bool in field_layout(k, extended)]
    return DictLayout(n_int + n_field_int, b + n_byte, tuple(entries))


def _check_bits(det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int,
                capacity: int) -> None:
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
    if det_words.device.type == "cuda" and det_words.data_ptr() % 16:
        raise ValueError("det_words: the kernel reads them 16 bytes at a time; pointer not aligned")


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
    kernels/fields.py::block_fields). On the card the dict is views of the
    kernel's two buffers (`dict_layout`)."""
    _check_bits(det_words, words, tile_counts, n_off, capacity)
    if use_kernel(det_words, words, tile_counts):
        return _block_decode_cuda(det_words, words, tile_counts, n_off, capacity, extended, recover2, fields)
    return decode_block_bits_plain(det_words, words, tile_counts, n_off, capacity, extended=extended,
                                   recover2=recover2, fields=fields)


def decode_block_bits_into(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    ints: torch.Tensor, byts: torch.Tensor, *, extended: bool = False, recover2: bool = False, fields: bool = False,
) -> None:
    """decode_block_bits writing its dict into `ints` (int32) and `byts`
    (uint8), buffers of `dict_layout`'s sizes on the inputs' device that
    the caller keeps (a CUDA graph's static outputs, pipeline.BlockGraphs);
    `layout_views` reads the dict back from them. On the card one launch;
    on the CPU the plain version's dict is copied in."""
    _check_bits(det_words, words, tile_counts, n_off, capacity)
    lay = dict_layout(capacity, extended, recover2, fields)
    check_layout_buffers(lay, ints, byts, det_words.device)
    if use_kernel(det_words, words, tile_counts):
        _block_decode_cuda(det_words, words, tile_counts, n_off, capacity, extended, recover2, fields, (ints, byts))
        return
    plain = decode_block_bits_plain(det_words, words, tile_counts, n_off, capacity, extended=extended,
                                    recover2=recover2, fields=fields)
    fill_layout(layout_views(lay.entries, ints, byts), plain)


def _pairs(device: torch.device) -> torch.Tensor:
    """pair_hash_table() on `device` (a tensor's, so with its index),
    uploaded once per device."""
    if device not in _pairs_on:
        _pairs_on[device] = torch.as_tensor(pair_hash_table().reshape(-1).view(np.int32)).to(device)
    return _pairs_on[device]


def _block_decode_cuda(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    extended: bool, recover2: bool = False, fields: bool = False, buffers: tuple | None = None,
) -> dict[str, torch.Tensor]:
    """One launch into `buffers` (ints, byts), or into two it allocates,
    laid out by dict_layout -> the dict's views of them. On the card an
    allocation costs more host time than a slice: two buffers, not a
    tensor a key."""
    global launches, fields_launches
    from airjax_torch._build import library

    lib = library()
    device = det_words.device
    lay = dict_layout(capacity, extended, recover2, fields)
    if buffers is None:
        buffers = (torch.empty(lay.n_int, dtype=torch.int32, device=device),
                   torch.empty(lay.n_byte, dtype=torch.uint8, device=device))
    ints, byts = buffers
    out = layout_views(lay.entries, ints, byts)

    def ptr(key):
        return out[key].data_ptr() if key in out else None

    # The mode's outputs after frames, a null pointer where the mode has none;
    # the six classes are one (6, K) block from the first.
    if extended:
        mode_out = (None, None, None, ptr("frames_raw"), ptr("df"), ptr("icao_ap_long"), ptr("icao_ap_short"),
                    ptr(CLASSES[0]))
    else:
        mode_out = (ptr("good"), ptr("recovered"), ptr("n_good"), None, None, None, None, None)
    # F's two buffers: the fields' int32 rows from the first (df), their bytes
    # from the callsign codes (field_layout).
    field_out = (out["fields"]["df"].data_ptr(), out["fields"]["callsign_codes"].data_ptr()) if fields else (None,) * 2
    with torch.cuda.device(device):
        candidate.load_syndromes(lib)
        rc = lib.airjax_block_decode(
            det_words.data_ptr(), words.data_ptr(), words.numel(), tile_counts.data_ptr(), n_off, capacity,
            ptr("offsets"), ptr("valid"), ptr("frames"), ptr("n_detections"), ptr("overflow"), *mode_out,
            ptr("recovered2"), _pairs(device).data_ptr() if recover2 else None,
            *field_out,
            int(extended), int(recover2), int(fields),  # the kernel's Mode, R2, F
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "block-decode kernel")
    launches += 1
    fields_launches += fields
    return out
