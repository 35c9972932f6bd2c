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
(:129-131): there it stays 0. The debug aids of airjax (:268-330) take
every frame one at a time, so they make the sink per packet:
`plot_dir` writes an SVG plot of each decoded frame's magnitudes
(visualise.plot_adsb_frame, DF17), `dump_preamble` prints each frame's
preamble (visualise.dump_preamble), after a DF17 packet's sink call and
before an extended one's, as airjax prints them.

Both runners keep `pipeline_depth` decodes in flight (default 1, as
airjax's, whose `adsb` passes none): block k+1 is uploaded from a pinned
buffer and its kernels launched before block k is fetched, and block k's
results are copied on a copy stream that waits on block k's event alone
(pipeline.Fetcher), so the card decodes block k+1 while the host copies
and applies block k. Entries are fetched and applied first in, first out,
so packets, the recover2 gate, the ICAO cache and the stats follow stream
order at every depth. The source is read on the Prefetcher's thread.
run_stream_sharded decodes the stream over a mesh of devices
(parallel/halo.py), in steps of many blocks.
"""

from __future__ import annotations

import collections
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
    Fetcher,
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
        # Host wall-clock per stage: dispatch (upload + decode launches),
        # fetch (the wait and the result copy + overflow regrow), apply
        # (packets + sink).
        self.stages = StageTimer()
        # Set at the stream's end, not in as_dict (airjax has no such keys):
        # decodes fetched, and those whose fetch returned while the next
        # decode was still running on the card (pipeline.Fetcher).
        self.fetches = 0
        self.overlapped = 0

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


class _Sink:
    """The acceptance policy both runners share: a decoded block's frames
    to a sink, per packet or batched (`on_fields`, `on_extended_block`),
    through the extended ICAO cache and the recover2 gate."""

    def __init__(self, on_packet, extended: bool, recover2: bool, stats: StreamStats, per_packet: bool = False):
        self.on_packet = on_packet
        self.extended = extended
        self.recover2 = recover2
        self.stats = stats
        self.batch_fn = None if extended or per_packet else getattr(on_packet, "on_fields", None)
        self.ext_batch_fn = getattr(on_packet, "on_extended_block", None) if extended and not per_packet else None
        self.batched = self.batch_fn is not None or self.ext_batch_fn is not None
        self.icao_cache = IcaoCache()
        self.seen_icaos: set[int] = set()  # the DF17 recover2 gate

    def apply(self, out: dict, keep: np.ndarray | None, min_offset: int | None, now: float,
              on_frame: Callable[[int], None] | None = None) -> int:
        """One block's host dict to the sink -> the packets emitted. `keep`
        masks the DF17 rows; in extended mode the candidates at local
        offsets below `min_offset` (the padded head of the stream) seed the
        ICAO cache but are not emitted. A per-packet sink calls `on_frame`
        with each emitted frame's local offset (the debug aids)."""
        stats = self.stats
        if self.ext_batch_fn is not None:
            return self.ext_batch_fn(out, now, self.icao_cache, min_offset=min_offset)
        emitted = 0
        if self.extended:
            # Offsets of the frames only the gated 2-flip repair validated.
            offs = np.asarray(out["offsets"])
            rec2_offs = set(offs[np.asarray(out["recovered2"])].tolist()) if self.recover2 else ()
            for local, packet in assemble_extended(out, now, self.icao_cache):
                if min_offset is not None and local < min_offset:
                    continue
                if local in rec2_offs:
                    stats.recovered2 += 1
                if on_frame is not None:
                    on_frame(local)
                self.on_packet(packet)
                emitted += 1
            return emitted
        idx = np.nonzero(keep)[0]
        if self.batch_fn is not None:
            if self.recover2:
                idx, n_r2 = _gate_recover2_batch(idx, out["fields"]["icao"], out["recovered2"], self.seen_icaos)
                stats.recovered2 += n_r2
            return self.batch_fn(out["fields"], idx, now)
        for k in idx:
            frame = out["frames"][k].tobytes()
            if self.recover2:
                icao = int.from_bytes(frame[1:4], "big")
                if out["recovered2"][k]:
                    # A 2-flip repair is trusted only for an aircraft
                    # already validated without one.
                    if icao not in self.seen_icaos:
                        continue
                    stats.recovered2 += 1
                else:
                    self.seen_icaos.add(icao)
            self.on_packet(AdsbPacket.from_bytes(frame, now))
            emitted += 1
            if on_frame is not None:
                on_frame(int(out["offsets"][k]))
        return emitted


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
    plot_dir: str | None = None,
    dump_preamble: bool = False,
    pipeline_depth: int = 1,
    prefetch_depth: int = 4,
) -> StreamStats:
    """Consume a block source until exhausted; call on_packet per packet
    (with extended=True, also AllCallReply, SurveillanceReply, AcasReply
    and CommDReply objects), or hand a batched sink each block. plot_dir
    and dump_preamble are the debug aids (module docstring).

    pipeline_depth decodes stay in flight before the oldest is fetched
    (airjax/runner.py:105-116, :382-407): block k+1's upload and kernels
    overlap block k's fetch and packet assembly. Packets come out in stream
    order at every depth; 0 is the serial form. prefetch_depth bounds the
    source's read-ahead queue (io.source.Prefetcher)."""
    stats = stats or StreamStats()
    # A batched sink (track.batch): on_fields in DF17 mode, on_extended_block
    # in extended mode; any other sink, or the debug aids, take packets.
    debug = plot_dir is not None or dump_preamble
    sink = _Sink(on_packet, extended, recover2, stats, per_packet=debug)
    decode = _decode_fn(extended, sink.batched, recover2)
    fetcher = Fetcher(device)
    halo = WINDOW - 1
    # The initial carry is the non-detecting (1,0)-magnitude pattern: a
    # zero carry passes the equality-tolerant gate at every offset.
    carry = None
    if overlap:
        carry = np.zeros((halo, 2), dtype=np.int16)
        carry[::2, 0] = 1
    global_base = -halo  # global sample index of carry[0]
    pending = np.zeros((0, 2), dtype=np.int16)
    inflight: collections.deque = collections.deque()

    def _dispatch(ext: np.ndarray, n_off: int, base: int, n_samples: int) -> None:
        with stats.stages.stage("dispatch"):
            staged = fetcher.stage(ext)
            block_dev = fetcher.upload(staged)
            out_dev = decode(block_dev, n_off, cfg.max_candidates)
            ticket = fetcher.launched(staged)
        # `now` is stamped at dispatch, as airjax does; the entry keeps the
        # block on the device for a regrow, and `ext` for the debug aids.
        inflight.append((ext, n_off, base, time.time(), n_samples, block_dev, out_dev, ticket))

    def _process(entry) -> None:
        ext, n_off, base, now, n_samples, block_dev, out_dev, ticket = entry
        with stats.stages.stage("fetch"):
            out = fetcher.fetch(out_dev, ticket)
            # Regrow on overflow: a dropped detection would lose a frame.
            overflowed = bool(out["overflow"])
            capacity = cfg.max_candidates
            while bool(out["overflow"]) and capacity < n_off:
                capacity = min(capacity * 4, n_off)
                out_dev = decode(block_dev, n_off, capacity)
                fetcher.done(ticket)
                ticket = fetcher.launched()
                out = fetcher.fetch(out_dev, ticket)
            fetcher.done(ticket)
        t_apply = time.perf_counter()
        good = out.get("good")
        if good is not None and overlap:
            # int64 before adding the base: it passes 2^31 after ~18 min of
            # stream (airjax/runner.py:283-289). Offsets below 0 are the
            # padded head of the first block.
            good = good & (out["offsets"].astype(np.int64) + base >= 0)
        on_frame = functools.partial(_debug_frame, ext, base if overlap else 0, plot_dir, dump_preamble,
                                     extended) if debug else None
        emitted = sink.apply(out, good, -base if overlap and base < 0 else None, now, on_frame)
        stats.stages.add("apply", time.perf_counter() - t_apply)
        # The tail flush is an extra decode, not a source block (n_samples=0).
        stats.blocks += 1 if n_samples else 0
        stats.samples += n_samples
        stats.detections += int(out["n_detections"])
        stats.good += emitted
        stats.recovered += int(np.sum(out["recovered"]))
        # Blocks that needed a regrow (the regrown result's flag is clear).
        stats.overflow_blocks += overflowed

    for block in Prefetcher(source, depth=prefetch_depth):
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
        _dispatch(ext, n_off, global_base, block.shape[0])
        if overlap:
            global_base += n_off
        while len(inflight) > max(pipeline_depth, 0):
            _process(inflight.popleft())
    if overlap and len(pending):
        # A final short read still ends the stream: frames ending inside
        # it are scannable once appended to the carry.
        carry = np.concatenate([carry, pending], axis=0)
    if overlap and carry.shape[0] > halo:
        # Tail flush: the carry's offsets whose windows end at the stream end.
        _dispatch(carry, carry.shape[0] - halo, global_base, 0)
    while inflight:
        _process(inflight.popleft())
    stats.fetches, stats.overlapped = fetcher.fetches, fetcher.overlapped
    return stats


def _debug_frame(ext: np.ndarray, base: int, plot_dir: str | None, dump_preamble: bool, extended: bool,
                 local: int) -> None:
    """The debug aids for the frame at `local` of the block `ext`, whose
    first sample is global sample `base` (airjax/runner.py:268-279,
    :313-330): a DF17 frame's plot (plot_dir) and each frame's preamble dump."""
    from airjax_torch import golden, visualise

    if plot_dir is not None and not extended:
        visualise.plot_adsb_frame(golden.magnitude(ext[local : local + WINDOW]), out_dir=plot_dir,
                                  detection_offset=0, title=f"frame @ {base + local}")
    if dump_preamble:
        print(visualise.dump_preamble(golden.magnitude(ext[local : local + 16]), offset=base + local))


def run_stream_sharded(
    source: Iterator[np.ndarray],
    on_packet: Callable[[AdsbPacket], None],
    mesh=None,
    n_devices: int | None = None,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    stats: StreamStats | None = None,
    extended: bool = False,
    shard_block: int | None = None,
    capacity_per_shard: int | None = None,
    compact_capacity: int | None = None,
    pipeline_depth: int = 1,
    recover2: bool = False,
    *,
    device: torch.device | str | None = None,
) -> StreamStats:
    """The stream decoded over a mesh (airjax/runner.py:410-686): `mesh`, or
    make_mesh(n_devices, device).

    Blocks are gathered into steps of T = shard_block * D samples; a step is
    the compact sharded decode (parallel/halo.py: each shard's front and
    block decode, then one shard gather), and a carry of the last 239
    samples joins each step to the next, so every offset of the stream is
    scanned once and the emitted stream equals run_stream's in overlap mode.
    The last step is padded with the non-detecting pattern and its offsets
    past the stream's end dropped (`max_local`). `pipeline_depth` steps are
    dispatched before the oldest is fetched, each uploaded from a pinned
    buffer and fetched on a copy stream after its own event
    (pipeline.Fetcher), so that step k's copies overlap step k+1's kernels;
    a step that overflows is decoded again with K and C grown 4x. Sinks as
    run_stream: per packet, or a batched one (`on_fields`,
    `on_extended_block`), whose fields the shard gather writes for the
    gathered rows in the same launch (its flag F); recover2 gates as there.

    `detections` counts each step's last 239 offsets twice, by design: a
    step scans them with the wrapped halo (and masks their hits), the next
    one with the real samples. `good` and the packets are exact.
    """
    from airjax_torch.parallel.halo import (
        _EXT_MASK_KEYS,
        EXT_COMPACT_ROW_KEYS,
        HALO,
        _halo_size,
        build_sharded_decoder_compact,
        build_sharded_decoder_extended_compact,
        shard_iq,
        tuned_block,
        unpack_extended_compact,
    )
    from airjax_torch.parallel.mesh import make_mesh
    from airjax_torch.pipeline import pad_iq_non_detecting

    if mesh is None:
        if device is None:
            raise ValueError("run_stream_sharded: give a mesh or a device")
        mesh = make_mesh(n_devices, device)
    n_dev = mesh.size
    axis = mesh.axis
    stats = stats or StreamStats()

    sink = _Sink(on_packet, extended, recover2, stats)

    block = shard_block or tuned_block(max(16384, cfg.block_len))
    halo = _halo_size(block)
    T = block * n_dev  # samples a step
    F = T - HALO  # fresh samples a step
    K = capacity_per_shard or cfg.max_candidates
    C = compact_capacity or max(128 if not extended else 512, K)
    with_fields = sink.batched
    builder = build_sharded_decoder_extended_compact if extended else build_sharded_decoder_compact
    steps: dict[tuple[int, int], Callable] = {}

    def get_step(k: int, c: int):
        if (k, c) not in steps:
            steps[(k, c)] = builder(mesh, T, k, c, axis, with_fields=with_fields, recover2=recover2)
        return steps[(k, c)]

    count_key = "n_candidates" if extended else "n_good"
    scalar_keys = (count_key, "n_detections", "overflow")
    row_keys = EXT_COMPACT_ROW_KEYS if extended else ("offsets", "recovered", "frames")
    if recover2:
        row_keys = row_keys + ("recovered2",)

    # A warm-up step on the non-detecting pattern before the source is read
    # (airjax :521-530): the kernels build and load here, not while frames
    # of the first step age in the ICAO cache's 60 s window.
    warm = np.zeros((T, 2), dtype=np.int16)
    warm[::2, 0] = 1
    int(get_step(K, C)(warm)[count_key])
    fetcher = Fetcher(mesh.devices[0])

    # The initial carry: the non-detecting pattern, its offsets masked by
    # global_base < 0.
    carry = np.zeros((HALO, 2), dtype=np.int16)
    carry[::2, 0] = 1
    global_base = -HALO
    acc = np.zeros((0, 2), dtype=np.int16)
    inflight: collections.deque = collections.deque()

    def _fetch_rows(out: dict, n: int, ticket) -> dict:
        rows = {k: out[k][:n] for k in row_keys}
        if with_fields:
            rows["fields"] = {k: v[:n] for k, v in out["fields"].items()}
            if extended:
                rows["short_fields"] = {k: v[:n] for k, v in out["short_fields"].items()}
        return fetcher.fetch(rows, ticket)

    def _process(entry) -> None:
        nonlocal K, C
        shards, base, now, n_fresh, max_local, out, ticket = entry
        with stats.stages.stage("fetch"):
            # The scalars first, then n rows: both copies wait on this
            # step's event alone.
            scal = fetcher.fetch({k: out[k] for k in scalar_keys}, ticket)
            overflowed = bool(scal["overflow"])
            while bool(scal["overflow"]) and (K < block or C < T):
                K = min(K * 4, block)
                C = min(C * 4, T)
                out = get_step(K, C)(shards)
                fetcher.done(ticket)
                ticket = fetcher.launched()
                scal = fetcher.fetch({k: out[k] for k in scalar_keys}, ticket)
            n = int(scal[count_key])
            rows = _fetch_rows(out, n, ticket)
            fetcher.done(ticket)
        t_apply = time.perf_counter()
        # int64: the stream base passes 2^31 after ~18 min of stream.
        offs = np.asarray(rows["offsets"], dtype=np.int64)
        # The padded head of the first step (base < 0) and, on the padded
        # last step, offsets whose window runs past the stream's end.
        ok = offs + base >= 0
        if max_local is not None:
            ok &= offs <= max_local
        if extended:
            unp = unpack_extended_compact(rows, n)
            if max_local is not None:
                # Padding candidates must not even seed the ICAO cache:
                # run_stream never scans those offsets.
                for k in _EXT_MASK_KEYS + (("recovered2",) if recover2 else ()):
                    unp[k] = unp[k] & (offs <= max_local)
            stats.recovered += int(np.sum(unp["recovered"]))
            if with_fields:
                unp["fields"] = rows["fields"]
                unp["short_fields"] = rows["short_fields"]
            rows = unp
        emitted = sink.apply(rows, ok, -base if base < 0 else None, now)
        stats.stages.add("apply", time.perf_counter() - t_apply)
        stats.blocks += 1 if n_fresh else 0
        stats.samples += n_fresh
        stats.detections += int(scal["n_detections"])
        stats.good += emitted
        if not extended:
            stats.recovered += int(np.sum(np.asarray(rows["recovered"])[ok]))
        stats.overflow_blocks += overflowed

    def _dispatch(fresh: np.ndarray, max_local: int | None) -> None:
        nonlocal carry, global_base
        full = np.concatenate([carry, fresh], axis=0)
        if full.shape[0] < T:
            full = pad_iq_non_detecting(full, T)
        with stats.stages.stage("dispatch"):
            staged = fetcher.stage(full)
            shards = shard_iq(staged, mesh, block, halo, non_blocking=True)
            out = get_step(K, C)(shards)
            ticket = fetcher.launched(staged)
        # The entry keeps the shards on their devices for a regrow.
        inflight.append((shards, global_base, time.time(), fresh.shape[0], max_local, out, ticket))
        carry = full[F:].copy()
        global_base += F
        while len(inflight) > max(pipeline_depth, 0):
            _process(inflight.popleft())

    for blk in Prefetcher(source, depth=4):
        blk = np.asarray(blk, dtype=np.int16)
        acc = np.concatenate([acc, blk], axis=0) if len(acc) else blk
        while acc.shape[0] >= F:
            fresh, acc = acc[:F], acc[F:]
            _dispatch(fresh, None)
    if acc.shape[0] > 0:
        # The last, partial step: only offsets whose window fits in
        # carry + acc are real.
        true_len = HALO + acc.shape[0]
        if true_len >= WINDOW:
            _dispatch(acc, true_len - WINDOW)
    while inflight:
        _process(inflight.popleft())
    stats.fetches, stats.overlapped = fetcher.fetches, fetcher.overlapped
    return stats
