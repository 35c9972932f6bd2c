"""Candidate kernel wrapper: packed compares + offsets -> frames, CRC-24
check and single-bit repair.

No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
slice_bits_packed (:285-306) with airjax/protocol/crc.py::
crc_check_and_recover (:108-135) and bits_to_bytes (:200-204). Here that
chain is one hand-written CUDA kernel, csrc/candidate.cu, one thread per
candidate, with the 88 single-bit syndromes in __constant__ memory.

`decode_candidates` launches the kernel for CUDA tensors and runs
`decode_candidates_plain` for CPU tensors. `launches` counts kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.dsp.demod import slice_bits_packed
from airjax_torch.protocol import crc

launches = 0
_syndromes_loaded: set[int] = set()  # CUDA device indices


def decode_candidates_plain(
    words: torch.Tensor, offsets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version: slice_bits_packed -> crc_check_and_recover ->
    bits_to_bytes."""
    bits = slice_bits_packed(words, offsets)
    bits, crc_ok, recovered = crc.crc_check_and_recover(bits, crc.tables(words.device))
    return crc.bits_to_bytes(bits), crc_ok, recovered


def decode_candidates(
    words: torch.Tensor, offsets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W,) int32 packed compares, (K,) int32 offsets (invalid slots
    already replaced by an in-range offset) -> frames (K, 14) uint8,
    crc_ok (K,) bool (validated directly or after a repair), recovered
    (K,) bool (validated after a single-bit repair)."""
    check_tensor(words, "words", torch.int32, 1)
    check_tensor(offsets, "offsets", torch.int32, 1)
    if words.numel() == 0:
        raise ValueError("words: empty")
    if use_kernel(words, offsets):
        return _candidates_cuda(words, offsets)
    return decode_candidates_plain(words, offsets)


def _candidates_cuda(
    words: torch.Tensor, offsets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    from airjax_torch._build import library

    lib = library()
    device = words.device
    k = offsets.shape[0]
    frames = torch.empty((k, crc.FRAME_BYTES), dtype=torch.uint8, device=device)
    crc_ok = torch.empty(k, dtype=torch.bool, device=device)
    recovered = torch.empty(k, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        index = torch.cuda.current_device()
        if index not in _syndromes_loaded:
            syn = np.ascontiguousarray(crc._tables()[1], dtype=np.uint32)
            check_launch(lib.airjax_load_syndromes(syn.ctypes.data), "syndrome upload")
            _syndromes_loaded.add(index)
        rc = lib.airjax_candidates(
            words.data_ptr(), words.numel(), offsets.data_ptr(), k,
            frames.data_ptr(), crc_ok.data_ptr(), recovered.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "candidate kernel")
    if k:
        launches += 1
    return frames, crc_ok, recovered
