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
(:159-189), held in device memory sorted, with the (i, j) of each pair
beside it, and found by a 12-probe binary search; the dict gains
`recovered2`. The table is uploaded once per device.

`decode_block_bits` launches the kernel for CUDA tensors and runs
`decode_block_bits_plain` for CPU tensors. `launches` counts kernel
launches, all four instantiations together.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.kernels import candidate
from airjax_torch.kernels.candidate import CLASSES
from airjax_torch.kernels.compact import Compacted, compact_bits_plain
from airjax_torch.kernels.magdet import n_det_words, n_tiles
from airjax_torch.protocol.crc import FRAME_BYTES, _pair_tables

launches = 0
_pairs_on: dict[torch.device, torch.Tensor] = {}  # device -> pair_table() there


def pair_table() -> np.ndarray:
    """(2 * 3828,) uint32: the pair syndromes in ascending order, then
    i | j << 8 of each (csrc/block_decode.cu's binary search reads it)."""
    pair, pi, pj = _pair_tables()
    order = np.argsort(pair)
    return np.concatenate([pair[order], (pi[order] | pj[order] << 8).astype(np.uint32)])


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
    *, extended: bool = False, recover2: bool = False,
) -> dict[str, torch.Tensor]:
    """Plain torch version: compact_bits_plain, then the plain candidate
    stage and the dict ops."""
    compacted = compact_bits_plain(det_words, tile_counts, n_off, capacity)
    if extended:
        plain = functools.partial(candidate.decode_candidates_extended_plain, recover2=recover2)
        return candidate_dict_extended(compacted, words, capacity, plain)
    plain = functools.partial(candidate.decode_candidates_plain, recover2=recover2)
    return candidate_dict(compacted, words, capacity, plain)


def decode_block_bits(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    *, extended: bool = False, recover2: bool = False,
) -> dict[str, torch.Tensor]:
    """(ceil(n_off/32),) int32 detection words (bit 31-k of word w: offset
    32w+k), (W,) int32 packed compares and (ceil(n_off/TILE),) int32 tile
    counts (kernels/magdet.py::magdet_bits) -> airjax's candidate dict for
    capacity K = `capacity`: DF17's (offsets, valid, good, recovered,
    frames, n_detections, n_good, overflow), or with extended=True the
    extended decode's (offsets, valid, df, frames, frames_raw, the six
    classes, icao_ap_short, icao_ap_long, n_detections, overflow); with
    recover2=True also `recovered2` (K,) bool, the 2-flip repairs."""
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
        return _block_decode_cuda(det_words, words, tile_counts, n_off, capacity, extended, recover2)
    return decode_block_bits_plain(det_words, words, tile_counts, n_off, capacity, extended=extended,
                                   recover2=recover2)


def _pairs(device: torch.device) -> torch.Tensor:
    """pair_table() on `device` (a tensor's, so with its index), uploaded
    once per device."""
    if device not in _pairs_on:
        _pairs_on[device] = torch.as_tensor(pair_table().view(np.int32)).to(device)
    return _pairs_on[device]


def _block_decode_cuda(
    det_words: torch.Tensor, words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int,
    extended: bool, recover2: bool = False,
) -> dict[str, torch.Tensor]:
    global launches
    from airjax_torch._build import library

    lib = library()
    device = det_words.device
    k = capacity
    # One int32 buffer and one byte buffer, sliced into the outputs: on the
    # card an allocation costs more host time than a slice.
    n_int = (4 * k + 1) if extended else (k + 2)
    n_byte = k * (2 * FRAME_BYTES + 1 + len(CLASSES)) + 1 if extended else k * (FRAME_BYTES + 3) + 1
    n_byte += k if recover2 else 0  # recovered2, after the mode's outputs
    ints = torch.empty(n_int, dtype=torch.int32, device=device)
    byts = torch.empty(n_byte, dtype=torch.uint8, device=device)
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
            int(extended), int(recover2), torch.cuda.current_stream().cuda_stream,  # the kernel's Mode, R2
        )
    check_launch(rc, "block-decode kernel")
    launches += 1
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
    return out
