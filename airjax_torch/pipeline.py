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
downlink format (airjax/pipeline.py:174-284): the front kernel with the
preamble-only gate, then the block-decode kernel in its extended mode;
`decode_mags_block_extended` is its plain chain from magnitudes.

recover2 (airjax's opt-in 2-bit repair, `decode_iq_block_r2` and the
recover2 argument of the extended decodes) is the block-decode kernel's
R2 flag: the dict gains `recovered2`, and `good` / `good_long` include
the 2-flip repairs, which callers must gate (runner, extended assembly).

The `_with_fields` decodes (airjax/pipeline.py:287-328) add the batched
protocol fields of every slot, `fields` (and for the extended decode
`short_fields`): the block-decode kernel's F flag writes them in the same
launch, so a batched pass is two launches too. They are what the batched
tracker sinks consume.

`decode_iq_block_staged` keeps the staged chain the block-decode kernel
replaced (front -> compaction kernel -> candidate kernel -> torch dict
ops): the A/B baseline and a second oracle on the card.

Both block decompositions of airjax are kept: parity (reference playback
chunking, applied as an offset filter over one whole-stream scan, or with
fused=False the literal per-chunk decode, a front and a block-decode launch
a chunk through `decode_iq_chunks`) and overlap (every global offset
scanned exactly once).

Every dict has airjax's keys and dtypes: offsets int32, valid/good/
recovered/overflow bool, frames uint8 (K, 14), n_detections/n_good int32.
Invalid slots are sliced at offset 0 and their frames left unmasked, as in
airjax (:86), so whole dicts compare equal.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

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
from airjax_torch.kernels.magdet import chunked_detection_count, magdet_bits
from airjax_torch.protocol.packet import AdsbPacket

Hit = tuple[int, int, bytes, bool]


def _check_block(n_samples: int, n_off: int) -> None:
    if n_off < 0 or n_off + WINDOW - 1 > n_samples:
        raise ValueError(f"n_off={n_off} needs {n_off + WINDOW - 1} samples, got {n_samples}")


def decode_mags_block(
    mags: torch.Tensor, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """(L,) int32 magnitudes, L >= n_off + WINDOW - 1 -> candidate dict,
    in plain torch on either device (airjax/pipeline.py:59-108); recover2
    adds the 2-bit repair and `recovered2`."""
    _check_block(mags.shape[0], n_off)
    return candidate_dict(
        compact_mask(detect(mags, n_off), capacity), pack_cmp_words(mags), capacity,
        functools.partial(decode_candidates_plain, recover2=recover2),
    )


def decode_iq_block(
    iq: torch.Tensor, n_off: int, capacity: int, *, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """(L, 2) int16 IQ -> candidate dict, through the front and block-decode
    kernels on CUDA (airjax/pipeline.py:111-116, :140-171)."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off)
    return decode_block_bits(det_words, words, counts, n_off, capacity, recover2=recover2)


def decode_iq_block_r2(iq: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """decode_iq_block with the 2-bit repair (airjax/pipeline.py:119-137):
    `good` includes the frames a unique double flip validated, marked in
    `recovered2`; callers gate them."""
    return decode_iq_block(iq, n_off, capacity, recover2=True)


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
    mags: torch.Tensor, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """(L,) int32 magnitudes -> the extended candidate dict, in plain torch
    on either device (airjax/pipeline.py:174-273)."""
    _check_block(mags.shape[0], n_off)
    return candidate_dict_extended(
        compact_mask(detect_preamble_only(mags, n_off), capacity), pack_cmp_words(mags), capacity,
        functools.partial(decode_candidates_extended_plain, recover2=recover2),
    )


def decode_iq_block_extended(
    iq: torch.Tensor, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """(L, 2) int16 IQ -> the extended candidate dict, through the front
    kernel (preamble gate) and the block-decode kernel's extended mode on
    CUDA (airjax/pipeline.py:276-284)."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off, gate="preamble")
    return decode_block_bits(det_words, words, counts, n_off, capacity, extended=True, recover2=recover2)


def decode_iq_block_with_fields(
    iq: torch.Tensor, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """decode_iq_block(_r2) plus `fields`, the protocol fields of every
    slot (airjax/pipeline.py:287-304): meaningful only where `good`."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off)
    return decode_block_bits(det_words, words, counts, n_off, capacity, recover2=recover2, fields=True)


def decode_iq_block_extended_with_fields(
    iq: torch.Tensor, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """decode_iq_block_extended plus `fields` of the repaired frames
    (meaningful where `good_long`) and `short_fields` of the raw ones (where
    a cand_* class is set), airjax/pipeline.py:307-328."""
    _check_block(iq.shape[0], n_off)
    det_words, words, counts = magdet_bits(iq, n_off, gate="preamble")
    return decode_block_bits(det_words, words, counts, n_off, capacity, extended=True, recover2=recover2,
                             fields=True)


def decode_iq_chunks(iq_chunks: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """(B, L, 2) int16 IQ chunks -> the batched candidate dict, every key
    stacked over the chunks (airjax/pipeline.py:331-338, a vmap): each
    chunk's decode_iq_block, a front and a block-decode launch a chunk on
    CUDA."""
    if iq_chunks.dim() != 3 or iq_chunks.shape[0] == 0:
        raise ValueError(f"iq_chunks: expected (B >= 1, L, 2), got {tuple(iq_chunks.shape)}")
    outs = [decode_iq_block(chunk, n_off, capacity) for chunk in iq_chunks]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def to_host(out: dict) -> dict:
    """A decode's dict (nested field dicts included) as numpy arrays."""
    return {k: to_host(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in out.items()}


@dataclasses.dataclass(eq=False)
class Ticket:
    """A dispatched decode: the event recorded after its launches (None on
    the CPU) and the pinned buffer its block was uploaded from, if any."""

    event: torch.cuda.Event | None
    staging: torch.Tensor | None


class Fetcher:
    """The uploads and result copies of a stream, so that decodes stay in
    flight on a card (runner.run_stream and run_stream_sharded; airjax keeps
    them in flight through JAX's async dispatch, airjax/runner.py:382-388).

    On a card: `stage` copies a block into a pinned buffer, which the
    upload reads with non_blocking=True, so a dispatch does not wait for the
    card; `launched` records an event on the compute stream after a decode's
    launches; `fetch` makes a copy stream of its own wait on that event
    alone, copies the dict there and waits for that stream only, so that
    block k's copy never queues behind block k+1's kernels. The kernels all
    run on the compute stream (the block-decode kernel's per-device
    accumulator allows no other). A staging buffer goes back to the pool in
    `done`, after its block's event has completed; a pool holds one buffer
    per decode in flight. On the CPU `stage` wraps the array, `fetch` is
    to_host, and there are no streams.

    `fetches` counts the decodes done, and `overlapped` those whose fetch
    returned while the next decode's event was still pending: the overlap
    itself, read on the card (0 on the CPU).
    """

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # Made here, on the thread that runs the stream.
        self._copy = torch.cuda.Stream(self.device) if self.cuda else None
        self._free: list[torch.Tensor] = []
        self._pending: collections.deque[Ticket] = collections.deque()
        self.fetches = 0
        self.overlapped = 0

    def stage(self, iq: np.ndarray) -> torch.Tensor:
        """(L, 2) int16 host IQ as a host tensor an upload may read without
        blocking: a pinned buffer of the pool on a card, the array itself on
        the CPU."""
        src = torch.from_numpy(np.ascontiguousarray(iq, dtype=np.int16))
        if not self.cuda:
            return src
        n = src.shape[0]
        buf = next((b for b in self._free if b.shape[0] >= n), None)
        if buf is None:
            self._free.clear()  # the stream's blocks grew: let the smaller buffers go
            buf = torch.empty((n, 2), dtype=torch.int16, pin_memory=True)
        else:
            self._free.remove(buf)
        buf[:n].copy_(src)
        return buf[:n]

    def upload(self, staged: torch.Tensor) -> torch.Tensor:
        """A staged block on the device, its copy queued on the compute stream."""
        return staged.to(self.device, non_blocking=True) if self.cuda else staged

    def launched(self, staged: torch.Tensor | None = None) -> Ticket:
        """The ticket of the decode just launched; `staged` is its block's
        staging buffer, held until the ticket is done."""
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        # stage() hands out a view of a pool buffer: the ticket holds the buffer.
        ticket = Ticket(event, staged._base if self.cuda and staged is not None else None)
        self._pending.append(ticket)
        return ticket

    def fetch(self, out: dict, ticket: Ticket) -> dict:
        """`out` (a decode's dict, or part of it) as numpy arrays, copied
        once the ticket's event has completed, on the copy stream."""
        if not self.cuda:
            return to_host(out)
        self._copy.wait_event(ticket.event)
        with torch.cuda.stream(self._copy):
            host = _copy_to_host(out)
        self._copy.synchronize()
        return _as_numpy(host)

    def done(self, ticket: Ticket) -> None:
        """The decode's results are on the host: its staging buffer goes back
        to the pool, and the overlap is counted."""
        self._pending.remove(ticket)
        if ticket.staging is not None:
            self._free.append(ticket.staging)
        self.fetches += 1
        if self.cuda and self._pending and not self._pending[0].event.query():
            self.overlapped += 1


def _copy_to_host(out: dict) -> dict:
    return {k: _copy_to_host(v) if isinstance(v, dict) else v.to("cpu", non_blocking=True) for k, v in out.items()}


def _as_numpy(out: dict) -> dict:
    return {k: _as_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in out.items()}


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
    iq: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG, fused: bool = True, *, device: torch.device | str
) -> tuple[list[Hit], dict]:
    """Decode a capture with exact reference playback semantics
    (airjax/pipeline.py:399-459).

    Hits are (chunk_index, offset_in_chunk, frame_bytes, recovered) in
    scan order. fused=True (default): the capture is scanned once as large
    overlap-save blocks; the reference's chunking is then the offset filter
    o < chunk - 240 on the whole-stream hits (magnitudes are per sample, so
    a chunk-local detection equals the whole-stream one). fused=False: the
    literal per-chunk decode (decode_iq_chunks), an overflowed chunk decoded
    again at a larger capacity; the golden oracle's structure, kept to hold
    the fused form to it.
    """
    chunk = cfg.block_len
    n_off = chunk - WINDOW
    n_chunks = reference_chunk_count(len(iq), chunk)
    if n_chunks == 0:
        return [], {"n_detections": 0, "n_good": 0, "overflow": False}
    if not fused:
        blocks = np.asarray(iq[: n_chunks * chunk], dtype=np.int16).reshape(n_chunks, chunk, 2)
        out = to_host(decode_iq_chunks(torch.as_tensor(blocks, device=device), n_off, cfg.max_candidates))
        hits = _collect_hits(out, lambda c, o: (c, o), blocks, n_off, cfg.max_candidates, device)
        return hits, _collect_stats(out)

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
    the whole-stream gate over the first n_chunks * chunk samples, filtered
    to in-chunk offsets < chunk - WINDOW; one launch of the front's count
    mode on the card (kernels/magdet.py::chunked_detection_count). `iq` may
    be longer; its tail is never scanned."""
    return chunked_detection_count(iq, chunk, n_chunks)


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


def _collect_hits(
    out: dict, to_global, blocks: np.ndarray | None = None, n_off: int | None = None, capacity: int | None = None,
    device: torch.device | str | None = None,
) -> list[Hit]:
    """A batched host dict's hits in order (airjax/pipeline.py:579-606);
    with the raw blocks given, an overflowed block is decoded again by
    decode_iq_block_adaptive, so that an overflow never loses a hit."""
    hits = []
    for b in range(out["offsets"].shape[0]):
        if blocks is not None and bool(out["overflow"][b]):
            res = decode_iq_block_adaptive(blocks[b], n_off, capacity, device)
        else:
            res = {k: out[k][b] for k in ("good", "offsets", "frames", "recovered")}
        for k in np.nonzero(res["good"])[0]:
            blk, off = to_global(b, int(res["offsets"][k]))
            hits.append((blk, off, res["frames"][k].tobytes(), bool(res["recovered"][k])))
    return hits


def _collect_stats(out: dict) -> dict:
    """A batched host dict's stats (airjax/pipeline.py:609-615)."""
    return {
        "n_detections": int(np.sum(out["n_detections"])),
        "n_good": int(np.sum(out["n_good"])),
        "n_recovered": int(np.sum(out["recovered"])),
        "overflow": bool(np.any(out["overflow"])),
    }


def hits_to_packets(hits: list[tuple[int, int, bytes, float | None]], time_processed: float | None = None):
    """Hits -> AdsbPacket.from_bytes of each frame, lazily (airjax/pipeline.py:618-623)."""
    for _, _, frame, _ in hits:
        yield AdsbPacket.from_bytes(frame, time_processed)
