"""Streaming runner: block source -> torch decode -> packet or batched sink
(airjax/runner.py:38-407).

Two stream modes, as in airjax:
  * parity  — each chunk scanned on its own over offsets [0, len-240),
              like the reference; frames straddling chunk edges are lost.
  * overlap — a carry from the previous chunk is prepended, so every
              global offset is scanned exactly once and no frame is lost
              at a chunk edge.

The sink receives what airjax's receives, in stream order: an
`AdsbPacket.from_bytes(frame, now)` per validated DF17 frame, `now` taken
per block at dispatch. With extended=True every Mode S downlink format is
decoded (airjax/runner.py:182-212, :251-279): the block's candidate dict
goes through airjax_torch.extended.assemble_extended, which seeds the
ICAO cache from the whole block (the padded head of the first block
included) before the packets at global offsets below 0 are skipped.

A batched sink takes a block at a time instead of a packet at a time,
as in airjax (:154-223): one with `on_fields` (track.batch.BatchTracker)
gets the block's protocol fields from decode_iq_block_with_fields (the
block-decode kernel's F flag), one with `on_extended_block`
(ExtendedBatchTracker) the extended dict with its fields. recover2=True
adds the 2-bit repair to every decode and gates its frames: in DF17 mode
the repaired ICAO must have been seen in a clean or 1-flip frame earlier
in the stream (per packet, or `_gate_recover2_batch` for a batched sink);
in extended mode the ICAO cache gates them (assemble_extended pass 1.5,
or the batched sink's own). stats.recovered2 counts the accepted repairs
on every path but the extended batched sink's, as in airjax
(:129-131): there it stays 0. airjax's plot and preamble-dump branches
and its pipeline_depth are not ported.

Blocks are decoded one at a time: each block is uploaded, decoded, and
its results copied back and applied before the next is dispatched. Only
the source read overlaps the decode, on the Prefetcher's thread.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Iterator

import numpy as np
import torch

from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.io.source import Prefetcher
from airjax_torch.dsp.demod import WINDOW
from airjax_torch.observability import StageTimer
from airjax_torch.extended import assemble_extended
from airjax_torch.pipeline import (
    decode_iq_block,
    decode_iq_block_extended,
    decode_iq_block_extended_with_fields,
    decode_iq_block_with_fields,
    to_host,
)
from airjax_torch.protocol.packet import AdsbPacket
from airjax_torch.track.icao_cache import IcaoCache

# Overlap-mode blocks at least this long use the shape-tuned scan
# (airjax/runner.py:31-35): a 1024-aligned slice with n_off = slice - 240.
# Kept so that the stream's blocks, and so its detection counts, match
# airjax's exactly; the emitted frames do not depend on it.
TUNED_STREAM_MIN = 1 << 16


class StreamStats:
    def __init__(self):
        self.blocks = 0
        self.samples = 0
        self.detections = 0
        self.good = 0
        self.recovered = 0
        self.recovered2 = 0  # 2-bit repairs accepted (recover2)
        self.overflow_blocks = 0
        self.started = time.time()
        # Host wall-clock per stage: dispatch (block prep + decode launch),
        # fetch (result copy + overflow regrow), apply (packets + sink).
        self.stages = StageTimer()

    def as_dict(self) -> dict:
        dt = max(time.time() - self.started, 1e-9)
        return {
            "blocks": self.blocks,
            "samples": self.samples,
            "detections": self.detections,
            "good": self.good,
            "recovered": self.recovered,
            "recovered2": self.recovered2,
            "overflow_blocks": self.overflow_blocks,
            "msamples_per_s": round(self.samples / dt / 1e6, 3),
            "stages": self.stages.as_dict(),
        }


def _gate_recover2_batch(
    idx: np.ndarray, icaos: np.ndarray, rec2: np.ndarray, seen: set
) -> tuple[np.ndarray, int]:
    """recover2 acceptance over one block's validated rows, vectorized
    (airjax/runner.py:72-102). `idx` selects the CRC-validated slots in
    ascending offset order; `icaos` / `rec2` are per-slot arrays. A 2-flip
    repair is kept iff its ICAO was seen in a clean or 1-flip row earlier
    in the stream (`seen`, updated here) or earlier in this block, as the
    per-packet gate decides. Returns (kept idx, accepted repairs)."""
    if len(idx) == 0:
        return idx, 0
    ic = np.asarray(icaos)[idx].astype(np.int64)
    r2 = np.asarray(rec2)[idx].astype(bool)
    clean_pos = np.nonzero(~r2)[0]
    earlier_clean = np.zeros(len(ic), bool)
    if len(clean_pos):
        u, first = np.unique(ic[clean_pos], return_index=True)
        first_pos = clean_pos[first]
        j = np.minimum(np.searchsorted(u, ic), len(u) - 1)
        earlier_clean = (u[j] == ic) & (first_pos[j] < np.arange(len(ic)))
    if seen:
        in_seen = np.isin(ic, np.fromiter(seen, np.int64, len(seen)))
    else:
        in_seen = np.zeros(len(ic), bool)
    keep = ~r2 | in_seen | earlier_clean
    if len(clean_pos):
        seen.update(np.unique(ic[clean_pos]).tolist())
    return idx[keep], int(np.sum(r2 & keep))


def _decode_fn(extended: bool, batched: bool, recover2: bool):
    """The block decode for a stream, one of airjax's six
    (airjax/runner.py:204-223): decode(iq, n_off, capacity) -> dict."""
    if extended:
        fn = decode_iq_block_extended_with_fields if batched else decode_iq_block_extended
    else:
        fn = decode_iq_block_with_fields if batched else decode_iq_block
    return functools.partial(fn, recover2=recover2)


def run_stream(
    source: Iterator[np.ndarray],
    on_packet: Callable[[AdsbPacket], None],
    cfg: PipelineConfig = DEFAULT_CONFIG,
    overlap: bool = True,
    extended: bool = False,
    *,
    device: torch.device | str,
    stats: StreamStats | None = None,
    recover2: bool = False,
) -> StreamStats:
    """Consume a block source until exhausted; call on_packet per packet
    (with extended=True, also AllCallReply, SurveillanceReply, AcasReply
    and CommDReply objects), or hand a batched sink each block."""
    stats = stats or StreamStats()
    # A batched sink (track.batch): on_fields in DF17 mode, on_extended_block
    # in extended mode; any other sink takes packets.
    batch_fn = None if extended else getattr(on_packet, "on_fields", None)
    ext_batch_fn = getattr(on_packet, "on_extended_block", None) if extended else None
    decode = _decode_fn(extended, batch_fn is not None or ext_batch_fn is not None, recover2)
    icao_cache = IcaoCache()
    seen_icaos: set[int] = set()  # the DF17 recover2 gate
    halo = WINDOW - 1
    # The initial carry is the non-detecting (1,0)-magnitude pattern: a
    # zero carry passes the equality-tolerant gate at every offset.
    carry = None
    if overlap:
        carry = np.zeros((halo, 2), dtype=np.int16)
        carry[::2, 0] = 1
    global_base = -halo  # global sample index of carry[0]
    pending = np.zeros((0, 2), dtype=np.int16)

    def _decode(ext: np.ndarray, n_off: int, base: int, n_samples: int) -> None:
        with stats.stages.stage("dispatch"):
            block_dev = torch.as_tensor(ext, device=device)
            out_dev = decode(block_dev, n_off, cfg.max_candidates)
            now = time.time()
        with stats.stages.stage("fetch"):
            out = to_host(out_dev)
            # Regrow on overflow: a dropped detection would lose a frame.
            overflowed = bool(out["overflow"])
            capacity = cfg.max_candidates
            while bool(out["overflow"]) and capacity < n_off:
                capacity = min(capacity * 4, n_off)
                out = to_host(decode(block_dev, n_off, capacity))
        t_apply = time.perf_counter()
        emitted = 0
        good = out.get("good")
        if good is not None and overlap:
            # int64 before adding the base: it passes 2^31 after ~18 min of
            # stream (airjax/runner.py:283-289). Offsets below 0 are the
            # padded head of the first block.
            good = good & (out["offsets"].astype(np.int64) + base >= 0)
        if ext_batch_fn is not None:
            # min_offset masks the application (not the cache seeding) of
            # the padded head of the first block, as the per-packet skip.
            emitted = ext_batch_fn(out, now, icao_cache, min_offset=-base if overlap and base < 0 else None)
        elif extended:
            # Offsets of the frames only the gated 2-flip repair validated.
            rec2_offs = set(out["offsets"][out["recovered2"]].tolist()) if recover2 else ()
            for local, packet in assemble_extended(out, now, icao_cache):
                if overlap and base + local < 0:
                    continue  # the padded head of the first block
                if local in rec2_offs:
                    stats.recovered2 += 1
                on_packet(packet)
                emitted += 1
        elif batch_fn is not None:
            idx = np.nonzero(good)[0]
            if recover2:
                idx, n_r2 = _gate_recover2_batch(idx, out["fields"]["icao"], out["recovered2"], seen_icaos)
                stats.recovered2 += n_r2
            emitted = batch_fn(out["fields"], idx, now)
        else:
            for k in np.nonzero(good)[0]:
                frame = out["frames"][k].tobytes()
                if recover2:
                    icao = int.from_bytes(frame[1:4], "big")
                    if out["recovered2"][k]:
                        # A 2-flip repair is trusted only for an aircraft
                        # already validated without one.
                        if icao not in seen_icaos:
                            continue
                        stats.recovered2 += 1
                    else:
                        seen_icaos.add(icao)
                on_packet(AdsbPacket.from_bytes(frame, now))
                emitted += 1
        stats.stages.add("apply", time.perf_counter() - t_apply)
        # The tail flush is an extra decode, not a source block (n_samples=0).
        stats.blocks += 1 if n_samples else 0
        stats.samples += n_samples
        stats.detections += int(out["n_detections"])
        stats.good += emitted
        stats.recovered += int(np.sum(out["recovered"]))
        # Blocks that needed a regrow (the regrown result's flag is clear).
        stats.overflow_blocks += overflowed

    for block in Prefetcher(source, depth=4):
        block = np.asarray(block, dtype=np.int16)
        if overlap and len(pending):
            # Short reads accumulate rather than being dropped.
            block = np.concatenate([pending, block], axis=0)
            pending = pending[:0]
        if block.shape[0] < WINDOW:
            if overlap:
                pending = block
            # parity: the reference cannot scan a block < 240 samples.
            continue
        if overlap:
            full = np.concatenate([carry, block], axis=0)
            if full.shape[0] >= TUNED_STREAM_MIN:
                slice_len = (full.shape[0] // 1024) * 1024
                n_off = slice_len - 240
                ext = full[:slice_len]
            else:
                n_off = full.shape[0] - halo
                ext = full
            carry = full[n_off:].copy()
        else:
            n_off = block.shape[0] - WINDOW
            ext = block
        _decode(ext, n_off, global_base, block.shape[0])
        if overlap:
            global_base += n_off
    if overlap and len(pending):
        # A final short read still ends the stream: frames ending inside
        # it are scannable once appended to the carry.
        carry = np.concatenate([carry, pending], axis=0)
    if overlap and carry.shape[0] > halo:
        # Tail flush: the carry's offsets whose windows end at the stream end.
        _decode(carry, carry.shape[0] - halo, global_base, 0)
    return stats
