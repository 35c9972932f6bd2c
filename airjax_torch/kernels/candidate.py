"""Candidate kernel wrapper: packed compares + offsets -> frames, CRC-24
check and single-bit repair.

No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
slice_bits_packed (:285-306) with airjax/protocol/crc.py::
crc_check_and_recover (:108-135) and bits_to_bytes (:200-204). Here that
chain is one hand-written CUDA kernel, csrc/candidate.cu, one thread per
candidate, with the 88 single-bit syndromes in __constant__ memory.
Its extended mode is the candidate stage of the extended decode of every
downlink format (airjax/pipeline.py:204-270): from the raw bits it adds
the bytes before the repair, the DF field, the long and short AP
residuals, and the candidate classes of each valid slot.

`decode_candidates(_extended)` launches the kernel for CUDA tensors and
runs `decode_candidates(_extended)_plain` for CPU tensors. `launches`
counts kernel launches, both modes together.
"""

from __future__ import annotations

import numpy as np
import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.dsp.demod import slice_bits_packed
from airjax_torch.protocol import crc
from airjax_torch.protocol.shortframe import SHORT_BITS, SHORT_DATA_BITS, crc24_short_batch

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


# The extended mode's class rows, in the kernel's order (csrc/candidate.cu,
# enum Class).
CLASSES = ("good_long", "recovered", "good_df11", "cand_df11_ic", "cand_short_ap", "cand_long_ap")


def decode_candidates_extended_plain(
    words: torch.Tensor, offsets: torch.Tensor, valid: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Plain torch version of the extended mode: airjax/pipeline.py:204-253
    from the slice on, with its expressions."""
    bits = slice_bits_packed(words, offsets)
    tab = crc.tables(words.device)
    long_bits, long_ok, long_rec = crc.crc_check_and_recover(bits, tab)
    df = crc.pack_bits_msbfirst(bits[..., :5], 5)
    is_long = df >= 16
    # AP-addressed long frames: DF16 ACAS, DF20/21 Comm-B, DF24+ Comm-D ELM.
    is_long_ap = (df == 16) | (df == 20) | (df == 21) | (df >= 24)
    good_long = long_ok & is_long & valid & ~is_long_ap
    pcrc_long = crc.pack_bits_msbfirst(bits[..., crc.DATA_BITS :], crc.CRC_BITS)
    icao_ap_long = crc.crc24_batch(bits[..., : crc.DATA_BITS], tab) ^ pcrc_long
    pi = crc.pack_bits_msbfirst(bits[..., SHORT_DATA_BITS:SHORT_BITS], crc.CRC_BITS)
    icao_ap_short = crc24_short_batch(bits[..., :SHORT_DATA_BITS]) ^ pi
    return {
        "df": df,
        "frames": crc.bits_to_bytes(long_bits),
        "frames_raw": crc.bits_to_bytes(bits),
        "good_long": good_long,
        "recovered": long_rec & good_long,
        "good_df11": (df == 11) & (icao_ap_short == 0) & valid,
        # DF11 interrogated all-calls: PI = CRC ^ interrogator code (< 80).
        "cand_df11_ic": (df == 11) & valid & (icao_ap_short != 0) & (icao_ap_short < 80),
        "cand_short_ap": ((df == 0) | (df == 4) | (df == 5)) & valid & (icao_ap_short != 0),
        "cand_long_ap": is_long_ap & valid & (icao_ap_long != 0),
        "icao_ap_short": icao_ap_short,
        "icao_ap_long": icao_ap_long,
    }


def _check(words: torch.Tensor, offsets: torch.Tensor) -> None:
    check_tensor(words, "words", torch.int32, 1)
    check_tensor(offsets, "offsets", torch.int32, 1)
    if words.numel() == 0:
        raise ValueError("words: empty")


def decode_candidates(
    words: torch.Tensor, offsets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W,) int32 packed compares, (K,) int32 offsets (invalid slots
    already replaced by an in-range offset) -> frames (K, 14) uint8,
    crc_ok (K,) bool (validated directly or after a repair), recovered
    (K,) bool (validated after a single-bit repair)."""
    _check(words, offsets)
    if use_kernel(words, offsets):
        return _candidates_cuda(words, offsets)
    return decode_candidates_plain(words, offsets)


def decode_candidates_extended(
    words: torch.Tensor, offsets: torch.Tensor, valid: torch.Tensor
) -> dict[str, torch.Tensor]:
    """(W,) int32 packed compares, (K,) int32 offsets (invalid slots
    already replaced by an in-range offset), (K,) bool valid -> the
    candidate part of airjax's extended dict (airjax/pipeline.py:254-266):
    df (K,) int32 (the first 5 raw bits), frames and frames_raw (K, 14)
    uint8 (after and before the long-frame repair), the (K,) bool classes
    good_long, recovered, good_df11, cand_df11_ic, cand_short_ap,
    cand_long_ap, and icao_ap_long (crc24(bits[:88]) ^ bits[88:112]) and
    icao_ap_short (crc24 of bits[:32] ^ bits[32:56]), (K,) int32."""
    _check(words, offsets)
    check_tensor(valid, "valid", torch.bool, 1)
    if valid.shape != offsets.shape:
        raise ValueError(f"valid: expected shape {tuple(offsets.shape)}, got {tuple(valid.shape)}")
    if use_kernel(words, offsets, valid):
        return _candidates_cuda(words, offsets, valid)
    return decode_candidates_extended_plain(words, offsets, valid)


def load_syndromes(lib) -> None:
    """Upload the 88 single-bit syndromes into every kernel's __constant__
    copy (csrc/candidate.cuh: the candidate and block-decode kernels) on
    the current CUDA device, once per device."""
    index = torch.cuda.current_device()
    if index not in _syndromes_loaded:
        syn = np.ascontiguousarray(crc._tables()[1], dtype=np.uint32)
        check_launch(lib.airjax_load_syndromes(syn.ctypes.data), "syndrome upload")
        _syndromes_loaded.add(index)


def _candidates_cuda(
    words: torch.Tensor, offsets: torch.Tensor, valid: torch.Tensor | None = None
):
    """Mode DF17 without `valid` (-> frames, crc_ok, recovered), mode
    extended with it (-> the dict of decode_candidates_extended)."""
    global launches
    from airjax_torch._build import library

    lib = library()
    device = words.device
    k = offsets.shape[0]

    def empty(*shape, dtype=torch.bool):
        return torch.empty(shape, dtype=dtype, device=device)

    frames = empty(k, crc.FRAME_BYTES, dtype=torch.uint8)
    # The C entry point's arguments after frames, a null pointer for None.
    if valid is None:
        crc_ok, recovered = empty(k), empty(k)
        args = (crc_ok, recovered, None, None, None, None, None, None)
    else:
        frames_raw = empty(k, crc.FRAME_BYTES, dtype=torch.uint8)
        df, icao_ap_long, icao_ap_short = (empty(k, dtype=torch.int32) for _ in range(3))
        classes = empty(len(CLASSES), k)
        args = (None, None, valid, frames_raw, df, icao_ap_long, icao_ap_short, classes)
    with torch.cuda.device(device):
        load_syndromes(lib)
        rc = lib.airjax_candidates(
            words.data_ptr(), words.numel(), offsets.data_ptr(), k, frames.data_ptr(),
            *(None if t is None else t.data_ptr() for t in args),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "candidate kernel")
    if k:
        launches += 1
    if valid is None:
        return frames, crc_ok, recovered
    return {
        "df": df, "frames": frames, "frames_raw": frames_raw,
        **dict(zip(CLASSES, classes.unbind(0))),
        "icao_ap_short": icao_ap_short, "icao_ap_long": icao_ap_long,
    }
