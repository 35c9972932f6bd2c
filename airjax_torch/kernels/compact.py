"""Compaction kernel wrapper: detection bits + tile counts -> ascending
candidate offsets, capped at a capacity.

No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
compact_detections (:87-126). Here it is csrc/compact.cu, which reads what
the front kernel of the decode paths writes (kernels/magdet.py::
magdet_bits): one detection bit per offset and a count per tile of TILE
offsets. It takes two launches (the scan of the tile counts, then one block
per tile writing its detections in order) and counts as one in
`launches`.

The result is compact_detections' (offsets (K,) int32 with empty slots =
n_off, valid (K,) bool, n_detections () int32 counting every detection)
plus the offsets the candidate kernel reads, empty slots 0
(`torch.where(valid, offsets, 0)`, folded into the kernel).

`compact_bits` launches the kernel for CUDA tensors and runs
`compact_bits_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.dsp.demod import compact_detections, unpack_msb_words
from airjax_torch.kernels.magdet import n_det_words, n_tiles

launches = 0

Compacted = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def compact_for_gather(det: torch.Tensor, capacity: int) -> Compacted:
    """compact_detections of a (n_off,) mask, plus the offsets the
    candidate stage reads: the plain chains' compaction."""
    offsets, valid, n_det = compact_detections(det, capacity)
    return offsets, valid, n_det, torch.where(valid, offsets, 0)


def compact_bits_plain(
    det_words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int
) -> Compacted:
    """Plain torch version: unpack the bits, then compact_for_gather. The tile
    counts are the kernel's index; the plain version needs none."""
    return compact_for_gather(unpack_msb_words(det_words, n_off), capacity)


def compact_bits(
    det_words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int
) -> Compacted:
    """(ceil(n_off/32),) int32 detection words (bit 31-k of word w: offset
    32w+k) and their (ceil(n_off/TILE),) int32 tile counts -> (offsets,
    valid, n_detections, gather offsets) for capacity K = `capacity`."""
    check_tensor(det_words, "det_words", torch.int32, 1)
    check_tensor(tile_counts, "tile_counts", torch.int32, 1)
    if n_off < 0 or det_words.shape[0] != n_det_words(n_off):
        raise ValueError(f"det_words: expected {n_det_words(max(n_off, 0))} words for n_off={n_off}")
    if tile_counts.shape[0] != n_tiles(n_off):
        raise ValueError(f"tile_counts: expected {n_tiles(n_off)} tiles for n_off={n_off}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if use_kernel(det_words, tile_counts):
        return _compact_cuda(det_words, tile_counts, n_off, capacity)
    return compact_bits_plain(det_words, tile_counts, n_off, capacity)


def _compact_cuda(
    det_words: torch.Tensor, tile_counts: torch.Tensor, n_off: int, capacity: int
) -> Compacted:
    global launches
    from airjax_torch._build import library

    lib = library()
    device = det_words.device
    # One int32 buffer for the scan's scratch and the three int32 outputs:
    # on the card an allocation costs more host time than a slice.
    n_t = tile_counts.shape[0]
    buf = torch.empty(n_t + 2 * capacity + 1, dtype=torch.int32, device=device)
    prefix, offsets, gather = buf[:n_t], buf[n_t : n_t + capacity], buf[n_t + capacity : -1]
    n_det = buf[-1]
    valid = torch.empty(capacity, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        rc = lib.airjax_compact(
            det_words.data_ptr(), tile_counts.data_ptr(), n_off, capacity, prefix.data_ptr(),
            offsets.data_ptr(), valid.data_ptr(), gather.data_ptr(), n_det.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "compaction kernel")
    launches += 1
    return offsets, valid, n_det, gather
