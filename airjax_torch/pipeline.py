"""The decode pipeline in torch: IQ blocks -> validated 14-byte frames
(the DF17 main path of airjax/pipeline.py).

  int16 IQ -> exact magnitude -> preamble/DF17 gate at every offset ->
  ordered compaction into a fixed capacity -> packed PPM compares ->
  8-word candidate slice -> CRC-24 + single-bit repair -> frames

`decode_iq_block` runs that chain through the kernel wrappers: on CUDA the
front kernel (csrc/front.cu: detection bits, packed compares, detections
per tile), then the block-decode kernel (csrc/block_decode.cu: the ordered
compaction, the candidate decode and the dict in one launch) — the dataflow
of airjax's `decode_iq_block_kernel` (:140-171) with the dense word layout.
On the CPU the same wrappers run their plain versions. `decode_mags_block`
is the plain torch chain from magnitudes on either device, the counterpart
of airjax's XLA path (:59-108).

`decode_iq_block_extended` is the extended decode of every Mode S
downlink format (airjax/pipeline.py:174-284, recover2=False): the front
kernel with the preamble-only gate, then the block-decode kernel in its
extended mode; `decode_mags_block_extended` is its plain chain from
magnitudes.

`decode_iq_block_staged` keeps the staged chain the block-decode kernel
replaced (front -> compaction kernel -> candidate kernel -> torch dict
ops): the A/B baseline and a second oracle on the card.

Both block decompositions of airjax are kept: parity (reference playback
chunking, applied as an offset filter over one whole-stream scan) and
overlap (every global offset scanned exactly once).

Every dict has airjax's keys and dtypes: offsets int32, valid/good/
recovered/overflow bool, frames uint8 (K, 14), n_detections/n_good int32.
Invalid slots are sliced at offset 0 and their frames left unmasked, as in
airjax (:86), so whole dicts compare equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.dsp.demod import (
    WINDOW,
    detect,
    detect_preamble_only,
    pack_cmp_words,
)
from airjax_torch.kernels.block_decode import (
    candidate_dict,
    candidate_dict_extended,
    decode_block_bits,
)
from airjax_torch.kernels.candidate import (
    decode_candidates,
    decode_candidates_extended,
    decode_candidates_extended_plain,
    decode_candidates_plain,
)
from airjax_torch.kernels.compact import compact_bits, compact_mask
from airjax_torch.kernels.magdet import magdet, magdet_bits

Hit = tuple[int, int, bytes, bool]


def _check_block(n_samples: int, n_off: int) -> None:
    if n_off < 0 or n_off + WINDOW - 1 > n_samples:
        raise ValueError(f"n_off={n_off} needs {n_off + WINDOW - 1} samples, got {n_samples}")


def decode_mags_block(mags: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """(L,) int32 magnitudes, L >= n_off + WINDOW - 1 -> candidate dict,
    in plain torch on either device (airjax/pipeline.py:59-108)."""
    _check_block(mags.shape[0], n_off)
    return candidate_dict(
        compact_mask(detect(mags, n_off), capacity), pack_cmp_words(mags), capacity,
        decode_candidates_plain,
    )


def decode_iq_block(iq: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """(L, 2) int16 IQ -> candidate dict, through the front and block-decode
    kernels on CUDA (airjax/pipeline.py:111-116, :140-171)."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off)
    return decode_block_bits(det_words, words, counts, n_off, capacity)


def decode_iq_block_staged(
    iq: torch.Tensor, n_off: int, capacity: int, *, extended: bool = False
) -> dict[str, torch.Tensor]:
    """decode_iq_block (or, with extended=True, decode_iq_block_extended)
    through the staged chain: the front, compaction and candidate kernels,
    then the dict's torch ops. The same dict."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off, gate="preamble" if extended else "df17")
    compacted = compact_bits(det_words, counts, n_off, capacity)
    if extended:
        return candidate_dict_extended(compacted, words, capacity, decode_candidates_extended)
    return candidate_dict(compacted, words, capacity, decode_candidates)


def decode_mags_block_extended(
    mags: torch.Tensor, n_off: int, capacity: int
) -> dict[str, torch.Tensor]:
    """(L,) int32 magnitudes -> the extended candidate dict, in plain torch
    on either device (airjax/pipeline.py:174-273, recover2=False)."""
    _check_block(mags.shape[0], n_off)
    return candidate_dict_extended(
        compact_mask(detect_preamble_only(mags, n_off), capacity), pack_cmp_words(mags), capacity,
        decode_candidates_extended_plain,
    )


def decode_iq_block_extended(iq: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """(L, 2) int16 IQ -> the extended candidate dict, through the front
    kernel (preamble gate) and the block-decode kernel's extended mode on
    CUDA (airjax/pipeline.py:276-284)."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off, gate="preamble")
    return decode_block_bits(det_words, words, counts, n_off, capacity, extended=True)


def to_host(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def decode_iq_block_adaptive(
    iq_block: np.ndarray, n_off: int, capacity: int, device: torch.device | str
) -> dict[str, np.ndarray]:
    """Decode one block, growing capacity 4x on overflow until it fits
    (airjax/pipeline.py:341-357). Returns host arrays."""
    block = torch.as_tensor(np.asarray(iq_block, dtype=np.int16), device=device)
    out = to_host(decode_iq_block(block, n_off, capacity))
    while bool(out["overflow"]) and capacity < n_off:
        capacity = min(capacity * 4, n_off)
        out = to_host(decode_iq_block(block, n_off, capacity))
    return out


# ---------------------------------------------------------------------------
# Block decompositions
# ---------------------------------------------------------------------------


def pad_iq_non_detecting(iq: np.ndarray, target_len: int) -> np.ndarray:
    """Pad IQ to target_len with a pattern that can never detect
    (airjax/pipeline.py:365-384).

    Never zeros: constant magnitudes pass the equality-tolerant preamble
    gate at every offset, and an all-zero frame has CRC 0. The
    alternating |IQ| = 1, 0, 1, 0, ... gives min(highs) = 0 < max(lows) =
    1 at every pure-pad offset.
    """
    n = len(iq)
    out = np.empty((target_len, 2), dtype=np.int16)
    out[:n] = iq
    pad = target_len - n
    if pad > 0:
        tail = np.zeros((pad, 2), dtype=np.int16)
        tail[::2, 0] = 1
        out[n:] = tail
    return out


def reference_chunk_count(n_samples: int, chunk: int = 20000) -> int:
    """Chunks the reference playback emits (airjax/pipeline.py:387-396):
    it drops the tail, including the final full chunk of an exact
    multiple."""
    if n_samples <= chunk:
        return 0
    return -(-(n_samples - chunk) // chunk)


def decode_capture_parity(
    iq: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG, *, device: torch.device | str
) -> tuple[list[Hit], dict]:
    """Decode a capture with exact reference playback semantics
    (airjax/pipeline.py:399-450, its fused=True form).

    Hits are (chunk_index, offset_in_chunk, frame_bytes, recovered) in
    scan order. The capture is scanned once as large overlap-save blocks;
    the reference's chunking is then the offset filter o < chunk - 240 on
    the whole-stream hits (magnitudes are per sample, so a chunk-local
    detection equals the whole-stream one).
    """
    chunk = cfg.block_len
    n_off = chunk - WINDOW
    n_chunks = reference_chunk_count(len(iq), chunk)
    if n_chunks == 0:
        return [], {"n_detections": 0, "n_good": 0, "overflow": False}

    scan_cfg = dataclasses.replace(cfg, block_len=max(chunk, 1 << 22))
    prep = _prep_overlap(np.asarray(iq[: n_chunks * chunk]), scan_cfg, device)
    whole, scan_stats = _overlap_scan(*prep, scan_cfg)
    hits = []
    for _, g, frame, rec in whole:
        c, o = divmod(g, chunk)
        if o < n_off:
            hits.append((c, o, frame, rec))
    stats = {
        "n_detections": int(_count_chunked_detections(prep[0], chunk, n_chunks)),
        "n_good": len(hits),
        "n_recovered": sum(1 for h in hits if h[3]),
        "overflow": scan_stats.get("overflow", False),
    }
    return hits, stats


def _count_chunked_detections(iq: torch.Tensor, chunk: int, n_chunks: int) -> torch.Tensor:
    """Exact reference-chunked detection count (airjax/pipeline.py:463-482):
    the whole-stream mask over the first n_chunks * chunk samples,
    filtered to in-chunk offsets < chunk - WINDOW. `iq` may be longer."""
    n_scan = n_chunks * chunk - WINDOW
    det, _ = magdet(iq[: n_chunks * chunk], n_scan)
    det = torch.nn.functional.pad(det, (0, n_chunks * chunk - n_scan))
    per_chunk = det.view(n_chunks, chunk)[:, : chunk - WINDOW]
    return per_chunk.sum(dtype=torch.int32)


def decode_capture_overlap(
    iq: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG, *, device: torch.device | str
) -> tuple[list[Hit], dict]:
    """Decode a capture with the overlap-save decomposition, no frame loss
    (airjax/pipeline.py:497-510). Hits are (block_index, global_offset,
    frame_bytes, recovered)."""
    prep = _prep_overlap(iq, cfg, device)
    if prep is None:
        return [], {"n_detections": 0, "n_good": 0, "overflow": False}
    return _overlap_scan(*prep, cfg)


def _prep_overlap(iq: np.ndarray, cfg: PipelineConfig, device: torch.device | str):
    """Pad and upload a capture for the overlap scan; None if too short
    (airjax/pipeline.py:513-539, same decomposition, so that the
    detection counts over the padded tail match too).

    Returns (iq_dev, n, slice_len, scan, n_blocks); iq_dev[:n] is the
    capture itself.
    """
    block = cfg.block_len
    n = len(iq)
    if n < WINDOW:
        return None
    if block >= 4096:
        slice_len = block
        scan = block - 1264
    else:
        slice_len = block + WINDOW - 1
        scan = block
    n_blocks = -(-max(n - WINDOW + 1, 1) // scan)
    padded = pad_iq_non_detecting(np.asarray(iq), (n_blocks - 1) * scan + slice_len)
    return torch.as_tensor(padded, device=device), n, slice_len, scan, n_blocks


def _overlap_scan(
    iq_dev: torch.Tensor, n: int, slice_len: int, scan: int, n_blocks: int, cfg: PipelineConfig
) -> tuple[list[Hit], dict]:
    """airjax/pipeline.py:542-576: decode each block slice of the
    resident capture, regrowing capacity on overflow."""
    max_global = n - WINDOW  # windows past the capture end are not scanned
    hits = []
    stats = {"n_detections": 0, "n_good": 0, "n_recovered": 0, "overflow": False}
    for b in range(n_blocks):
        ext = iq_dev[b * scan : b * scan + slice_len]
        capacity = cfg.max_candidates
        out = to_host(decode_iq_block(ext, scan, capacity))
        while bool(out["overflow"]) and capacity < scan:
            capacity = min(capacity * 4, scan)
            out = to_host(decode_iq_block(ext, scan, capacity))
        for k in np.nonzero(out["good"])[0]:
            g = b * scan + int(out["offsets"][k])
            if g <= max_global:
                hits.append((b, g, out["frames"][k].tobytes(), bool(out["recovered"][k])))
        stats["n_detections"] += int(out["n_detections"])
        stats["n_good"] += int(out["n_good"])
        stats["n_recovered"] += int(np.sum(out["recovered"]))
        stats["overflow"] |= bool(out["overflow"])
    return hits, stats
