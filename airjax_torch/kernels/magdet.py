"""Front kernel wrappers: int16 IQ -> detection mask + PPM compares.

The port of airjax/kernels/magdet.py (Pallas): `magdet_packed` (:229-277,
the pallas_call at :250) becomes mode packed of `magdet`, csrc/magdet.cu,
and `magdet_fused` (:118-165, the pallas_call at :138) mode planes,
csrc/planes.cu (Form::kFront). Mode packed emits pack_cmp_words' dense
word layout, not the TPU's sparse byte plane. The TPU's TILE/EXTRA
geometry and `pad_for_kernel` are not ported: the kernels mask the ragged
edge themselves. `gate` picks the detector: "df17" (the reference's
preamble + DF17 taps, the main path) or "preamble" (the preamble alone,
for the extended decode of every downlink format).

`magdet` launches a kernel for a CUDA tensor and runs `magdet_plain` for
a CPU tensor. `launches` counts the launches of csrc/magdet.cu (mode
packed), `planes_launches` those of csrc/planes.cu (mode planes).

csrc/planes.cu is mode planes redesigned for Hopper on csrc/front.cu's
design (a thread 32 offsets, a register window, paired int16 SIMD,
16-byte stores);
it also carries the stencil variants of kernels/stencil3.py as its other
forms (FORMS). `magdet_planes_baseline` runs the first forms of both,
csrc/magdet.cu's mode planes and its stencil kernel: the A/B baseline and
second oracle of csrc/planes.cu, which no decode path or public function
calls. `baseline_launches` counts its launches.

`magdet_bits` is the front of the decode paths, the same function
redesigned for Hopper (csrc/front.cu): the gate as bits, 32 offsets per
int32 word in pack_cmp_words' layout, the packed compares, and the
detections per tile of TILE offsets, which is what the compaction kernel
(kernels/compact.py) reads. Its plain version `magdet_bits_plain` packs
`magdet_plain`'s mask. `bits_launches` counts its launches. `magdet`
stays as its oracle and A/B baseline.

`chunked_detection_count` is the front's count mode (csrc/front.cu,
kCount): the fused parity decode's detection count
(airjax/pipeline.py::_count_chunked_detections), the DF17 gate over the
first n_chunks * chunk samples at the offsets below chunk - WINDOW of
each chunk, with no bits written: one launch and a sum of its tile
counts. Its plain version `chunked_detection_count_plain` masks
`magdet_bits_plain`'s words. `count_launches` counts its launches.
"""

from __future__ import annotations

import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.dsp.demod import (
    DF17_LOWS,
    WINDOW,
    detect,
    detect_preamble_only,
    n_words,
    pack_cmp_words,
    pack_msb_words,
)
from airjax_torch.dsp.magnitude import magnitude_u16

launches = 0
planes_launches = 0
baseline_launches = 0
bits_launches = 0
count_launches = 0
GATES = {"df17": 0, "preamble": 1}  # the kernel's Gate values
FORMS = {"front": 0, "tree32": 1, "tree16": 2, "flat16": 3}  # csrc/planes.cu's Form values
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


def in_chunk_words(n_off: int, chunk: int, device) -> torch.Tensor:
    """(ceil(n_off/32),) int32 words in the det words' layout: bit 31-k of
    word w set where offset 32w+k < n_off lies below chunk - WINDOW in its
    chunk."""
    o = torch.arange(n_det_words(n_off) * 32, device=device)
    return pack_msb_words((o < n_off) & (o % chunk < chunk - WINDOW), n_det_words(n_off))


def chunked_detection_count_plain(iq: torch.Tensor, chunk: int, n_chunks: int) -> torch.Tensor:
    """Plain torch version: magdet_bits_plain's det words over the first
    n_chunks * chunk samples, ANDed with in_chunk_words, popcounted per
    tile, summed."""
    n_scan = n_chunks * chunk - WINDOW
    det_words, _, _ = magdet_bits_plain(iq[: n_chunks * chunk], n_scan)
    bits = (det_words & in_chunk_words(n_scan, chunk, iq.device)).to(torch.int64) & 0xFFFFFFFF
    per_word = ((bits[:, None] >> torch.arange(32, device=iq.device)) & 1).sum(dim=1)
    return per_word.sum(dtype=torch.int32)


def chunked_detection_count(iq: torch.Tensor, chunk: int, n_chunks: int) -> torch.Tensor:
    """(L, 2) int16 IQ with L >= n_chunks * chunk -> () int32: the DF17
    detections at the offsets o < n_chunks * chunk - WINDOW with o mod chunk
    < chunk - WINDOW (airjax/pipeline.py::_count_chunked_detections). The
    samples past n_chunks * chunk are never read."""
    if chunk <= WINDOW or n_chunks < 1:
        raise ValueError(f"chunked_detection_count: chunk {chunk} (> {WINDOW}), n_chunks {n_chunks} (>= 1)")
    check_iq(iq, n_chunks * chunk - WINDOW)
    if iq.shape[0] < n_chunks * chunk:
        raise ValueError(f"iq: {iq.shape[0]} samples, fewer than {n_chunks} chunks of {chunk}")
    if use_kernel(iq):
        return _count_cuda(iq, chunk, n_chunks)
    return chunked_detection_count_plain(iq, chunk, n_chunks)


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


def magdet_planes_baseline(
    iq: torch.Tensor, n_off: int, form: str = "front", gate: str = "df17"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The planes contract of `magdet(packed=False)` through the first
    Hopper forms: csrc/magdet.cu mode planes (form "front", both gates) or
    its stencil kernel (tree32, tree16, flat16; the DF17 gate). The A/B
    baseline and second oracle of csrc/planes.cu; plain versions
    `magdet_plain(packed=False)` and stencil3.magdet_tree_plain."""
    check_iq(iq, n_off)
    check_gate(gate)
    check_form(form, gate)
    if use_kernel(iq):
        return _baseline_cuda(iq, n_off, form, gate)
    if form == "front":
        return magdet_plain(iq, n_off, False, gate)
    from airjax_torch.kernels.stencil3 import magdet_tree_plain

    return magdet_tree_plain(iq, n_off, form)


def check_form(form: str, gate: str) -> None:
    if form not in FORMS:
        raise ValueError(f"form: expected one of {sorted(FORMS)}, got {form!r}")
    if form != "front" and gate != "df17":
        raise ValueError(f"form {form!r} runs the DF17 gate alone, not {gate!r}")


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
    global launches, planes_launches
    if not packed:
        planes = _planes_cuda(iq, n_off, "front", gate)
        planes_launches += 1
        return planes
    from airjax_torch._build import library

    lib = library()
    n_samples = iq.shape[0]
    det = torch.empty(n_off, dtype=torch.uint8, device=iq.device)
    out = torch.empty(n_words(n_samples), dtype=torch.int32, device=iq.device)
    with torch.cuda.device(iq.device):
        rc = lib.airjax_magdet(
            iq.data_ptr(), n_samples, n_off, det.data_ptr(), out.data_ptr(),
            out.numel(), 1, GATES[gate], torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "magdet kernel")
    launches += 1
    return det, out


def _planes_cuda(iq: torch.Tensor, n_off: int, form: str, gate: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of csrc/planes.cu in `form`; the callers count it."""
    from airjax_torch._build import library

    lib = library()
    n_samples = iq.shape[0]
    det = torch.empty(n_off, dtype=torch.uint8, device=iq.device)
    cmp = torch.empty(n_samples - 1, dtype=torch.uint8, device=iq.device)
    with torch.cuda.device(iq.device):
        rc = lib.airjax_planes(
            iq.data_ptr(), n_samples, n_off, det.data_ptr(), cmp.data_ptr(), FORMS[form], GATES[gate],
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, f"planes kernel ({form}, {gate})")
    return det, cmp


def _baseline_cuda(iq: torch.Tensor, n_off: int, form: str, gate: str) -> tuple[torch.Tensor, torch.Tensor]:
    global baseline_launches
    from airjax_torch._build import library

    lib = library()
    n_samples = iq.shape[0]
    det = torch.empty(n_off, dtype=torch.uint8, device=iq.device)
    cmp = torch.empty(n_samples - 1, dtype=torch.uint8, device=iq.device)
    with torch.cuda.device(iq.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form == "front":
            rc = lib.airjax_magdet(iq.data_ptr(), n_samples, n_off, det.data_ptr(), cmp.data_ptr(), cmp.numel(), 0,
                                   GATES[gate], stream)
        else:
            rc = lib.airjax_magdet_stencil(iq.data_ptr(), n_samples, n_off, det.data_ptr(), cmp.data_ptr(),
                                           FORMS[form], stream)
    check_launch(rc, f"planes baseline ({form}, {gate})")
    baseline_launches += 1
    return det, cmp


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


def _count_cuda(iq: torch.Tensor, chunk: int, n_chunks: int) -> torch.Tensor:
    global count_launches
    from airjax_torch._build import library

    lib = library()
    n_samples = n_chunks * chunk
    n_scan = n_samples - WINDOW
    counts = torch.empty(n_tiles(n_scan), dtype=torch.int32, device=iq.device)
    with torch.cuda.device(iq.device):
        rc = lib.airjax_chunked_count(iq.data_ptr(), n_samples, n_scan, chunk, counts.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "chunked detection count (front, count mode)")
    count_launches += 1
    return counts.sum(dtype=torch.int32)
