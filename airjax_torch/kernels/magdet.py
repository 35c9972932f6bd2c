"""Front kernel wrapper: int16 IQ -> detection mask + PPM compares.

The port of airjax/kernels/magdet.py (Pallas): `magdet_packed` (:229-277,
the pallas_call at :250) becomes mode packed, `magdet_fused` (:118-165,
the pallas_call at :138) mode planes, of one CUDA kernel,
csrc/magdet.cu. Mode packed emits pack_cmp_words' dense word layout, not
the TPU's sparse byte plane. The TPU's TILE/EXTRA geometry and
`pad_for_kernel` are not ported: the kernel masks the ragged edge itself.
`gate` picks the detector: "df17" (the reference's preamble + DF17 taps,
the main path) or "preamble" (the preamble alone, for the extended decode
of every downlink format).

`magdet` launches the kernel for a CUDA tensor and runs `magdet_plain`
for a CPU tensor. `launches` counts kernel launches.

`magdet_bits` is the front of the decode paths, the same function
redesigned for Hopper (csrc/front.cu): the gate as bits, 32 offsets per
int32 word in pack_cmp_words' layout, the packed compares, and the
detections per tile of TILE offsets, which is what the compaction kernel
(kernels/compact.py) reads. Its plain version `magdet_bits_plain` packs
`magdet_plain`'s mask. `bits_launches` counts its launches. `magdet`
stays as its oracle and for the u8 mask of
pipeline._count_chunked_detections.
"""

from __future__ import annotations

import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.dsp.demod import (
    DF17_LOWS,
    detect,
    detect_preamble_only,
    n_words,
    pack_cmp_words,
    pack_msb_words,
)
from airjax_torch.dsp.magnitude import magnitude_u16

launches = 0
bits_launches = 0
GATES = {"df17": 0, "preamble": 1}  # the kernel's Gate values
TILE = 8192  # offsets per tile count; csrc/front.cu and csrc/compact.cu kTile


def n_det_words(n_off: int) -> int:
    return -(-n_off // 32)


def n_tiles(n_off: int) -> int:
    return -(-n_off // TILE)


def tile_counts(det: torch.Tensor) -> torch.Tensor:
    """(n_off,) bool/uint8 mask -> (n_tiles(n_off),) int32 detections per tile."""
    n_off = det.shape[0]
    padded = torch.zeros(n_tiles(n_off) * TILE, dtype=torch.int32, device=det.device)
    padded[:n_off] = det
    return padded.view(-1, TILE).sum(dim=1, dtype=torch.int32)


def magdet_bits_plain(
    iq: torch.Tensor, n_off: int, gate: str = "df17"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version: magdet_plain, then its mask packed into words
    (pack_msb_words) and counted per tile."""
    det, words = magdet_plain(iq, n_off, True, gate)
    return pack_msb_words(det, n_det_words(n_off)), words, tile_counts(det)


def magdet_bits(
    iq: torch.Tensor, n_off: int, gate: str = "df17"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L, 2) int16 IQ -> (det_words, words, tile_counts) over one block.

    det_words: (ceil(n_off/32),) int32, bit 31-k of word w the `gate` at
    offset 32w+k (needs L >= n_off + 25), 0 past n_off. words:
    (n_words(L),) int32 packed compares (pack_cmp_words). tile_counts:
    (ceil(n_off/TILE),) int32 detections per tile of TILE offsets.
    """
    check_iq(iq, n_off)
    check_gate(gate)
    if use_kernel(iq):
        return _bits_cuda(iq, n_off, gate)
    return magdet_bits_plain(iq, n_off, gate)


def magdet_plain(
    iq: torch.Tensor, n_off: int, packed: bool = True, gate: str = "df17"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: magnitude_u16 -> detect (or
    detect_preamble_only), and pack_cmp_words (packed) or the unpacked
    compares (planes)."""
    mags = magnitude_u16(iq)
    det = (detect if gate == "df17" else detect_preamble_only)(mags, n_off).to(torch.uint8)
    if packed:
        return det, pack_cmp_words(mags)
    return det, (mags[:-1] > mags[1:]).to(torch.uint8)


def magdet(
    iq: torch.Tensor, n_off: int, packed: bool = True, gate: str = "df17"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, 2) int16 IQ -> (det, cmp) over one block.

    det: (n_off,) uint8, the `gate` at offsets [0, n_off) (needs
    L >= n_off + 25). packed: (n_words(L),) int32 packed compares
    (airjax_torch.dsp.demod.pack_cmp_words). planes: (L-1,) uint8
    compares mag[i] > mag[i+1].
    """
    check_iq(iq, n_off)
    check_gate(gate)
    if use_kernel(iq):
        return _magdet_cuda(iq, n_off, packed, gate)
    return magdet_plain(iq, n_off, packed, gate)


def check_gate(gate: str) -> None:
    if gate not in GATES:
        raise ValueError(f"gate: expected one of {sorted(GATES)}, got {gate!r}")


def check_iq(iq: torch.Tensor, n_off: int) -> None:
    """Raise on an IQ block or offset count the front kernels do not take."""
    check_tensor(iq, "iq", torch.int16, 2)
    n_samples = iq.shape[0]
    if iq.shape[1] != 2:
        raise ValueError(f"iq: expected (L, 2), got {tuple(iq.shape)}")
    if n_off < 0 or n_samples < n_off + DF17_LOWS[-1]:
        raise ValueError(f"n_off={n_off} needs at least {n_off + 25} samples, got {n_samples}")
    if iq.device.type == "cuda" and iq.data_ptr() % 4:
        raise ValueError("iq: the kernel reads one 4-byte word per sample; pointer not aligned")


def _magdet_cuda(
    iq: torch.Tensor, n_off: int, packed: bool, gate: str
) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    from airjax_torch._build import library

    lib = library()
    n_samples = iq.shape[0]
    det = torch.empty(n_off, dtype=torch.uint8, device=iq.device)
    if packed:
        out = torch.empty(n_words(n_samples), dtype=torch.int32, device=iq.device)
    else:
        out = torch.empty(n_samples - 1, dtype=torch.uint8, device=iq.device)
    with torch.cuda.device(iq.device):
        rc = lib.airjax_magdet(
            iq.data_ptr(), n_samples, n_off, det.data_ptr(), out.data_ptr(),
            out.numel(), int(packed), GATES[gate], torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "magdet kernel")
    launches += 1
    return det, out


def _bits_cuda(
    iq: torch.Tensor, n_off: int, gate: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global bits_launches
    from airjax_torch._build import library

    lib = library()
    n_samples = iq.shape[0]

    # One allocation, three slices: on the card an allocation costs more
    # host time than a slice.
    a, b = n_det_words(n_off), n_words(n_samples)
    buf = torch.empty(a + b + n_tiles(n_off), dtype=torch.int32, device=iq.device)
    det_words, words, counts = buf[:a], buf[a : a + b], buf[a + b :]
    with torch.cuda.device(iq.device):
        rc = lib.airjax_magdet_bits(
            iq.data_ptr(), n_samples, n_off, det_words.data_ptr(), words.data_ptr(),
            words.numel(), counts.data_ptr(), GATES[gate], torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "magdet_bits kernel")
    bits_launches += 1
    return det_words, words, counts
