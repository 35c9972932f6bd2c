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

Both runners are one loop (`_run`) over a framing, which cuts the
stream into decodes (`_Blocks`: a block behind the overlap carry;
`_Steps`: a step of many blocks over a mesh), and a decode engine, which
runs each as one program, as airjax's jit does: a CUDA graph per shape
(pipeline.BlockGraphs; parallel/halo.py::StepGraphs, or halo.EagerSteps'
eager launches on a mesh over several cards). An engine holds its
capacity and, in `collect`, decodes a dict that overflowed again from
its own device input at a capacity grown 4x.

The loop keeps up to `pipeline_depth` decodes in flight (default 1, as
airjax's, whose `adsb` passes none): block k+1 is dispatched before block
k is fetched, so the card decodes block k+1 while the host copies and
applies block k. It holds block k so only while the source has a block
ready (io.source.Prefetcher.ready): when it has none, as a paced receiver
has not between blocks, nothing would overlap the decodes in flight, and
they are fetched and applied at once, oldest first, rather than held
until the next block arrives (`stats.early_fetches`). Entries are fetched
and applied first in, first out, so packets, the recover2 gate, the ICAO
cache and the stats follow stream order at every depth. The source is
read on the Prefetcher's thread. Each step of a block is timed as a stage
of `stats.stages` (StreamStats: source, handoff, carry, dispatch, hold,
fetch, apply, sink) and, while an observability.trace is active, kept as
a span with the block's sequence number in the stream.
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Callable, Iterator

import numpy as np
import torch

from airjax_torch import observability
from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.io.source import Prefetcher
from airjax_torch.dsp.demod import WINDOW
from airjax_torch.observability import StageTimer
from airjax_torch.extended import assemble_extended
from airjax_torch.parallel import halo as sharding
from airjax_torch.parallel.halo import HALO as _HALO
from airjax_torch.pipeline import (
    BlockGraphs,
    decode_iq_block,
    decode_iq_block_extended,
    decode_iq_block_extended_with_fields,
    decode_iq_block_with_fields,
    pad_iq_non_detecting,
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
        # Host wall-clock per stage, each on the time.perf_counter clock.
        # The main thread's, disjoint: source (the wait for the next block
        # in the Prefetcher's iteration), carry (the block's asarray, the
        # short-read join, the carry's concatenate and copy), dispatch (the
        # block's copy in + the decode's replay or launches), fetch (the
        # wait and the result copy + overflow regrow), apply (packets +
        # sink). Besides: handoff (from the prefetch thread's getting the
        # block from the source to its receipt), hold (a block's end of
        # dispatch to its start of fetch: the later blocks' work at depth
        # 1 while the source has them ready, else only a look at the
        # source's queue), sink (the sink's own calls inside apply, once a
        # block).
        self.stages = StageTimer()
        # Not in as_dict (airjax has no such keys): decodes fetched, and
        # those whose fetch returned while the next decode was still running
        # on the card (pipeline.GraphRing, pipeline.Fetcher), set at the
        # stream's end; decodes fetched before pipeline_depth were in
        # flight because the source had no block ready (early_fetches /
        # fetches: the share of fetches that skipped the hold).
        self.fetches = 0
        self.overlapped = 0
        self.early_fetches = 0
        # The most blocks the source had ready and the runner not yet taken
        # at a receipt (io.source.Prefetcher.backlog_max): above 0, the
        # runner fell behind its source.
        self.backlog_max = 0
        # The decode engine at the stream's end: first sightings,
        # captures, replays, and the bytes its slots hold.
        self.graphs: dict[str, int] = {}

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
        self._block: int | None = None
        self._sink_s = 0.0

    def _call(self, fn, *args, **kw):
        """A call of the sink, timed into the block's `sink` stage and, while
        a span log is recording, kept as a span inside `apply`."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            t1 = time.perf_counter()
            self._sink_s += t1 - t0
            log = observability.recording
            if log is not None:
                log.add("sink", t0, t1, self._block, "apply")

    def apply(self, out: dict, keep: np.ndarray | None, min_offset: int | None, now: float,
              on_frame: Callable[[int], None] | None = None, block: int | None = None) -> int:
        """One block's host dict to the sink -> the packets emitted. `keep`
        masks the DF17 rows; in extended mode the candidates at local
        offsets below `min_offset` (the padded head of the stream) seed the
        ICAO cache but are not emitted. A per-packet sink calls `on_frame`
        with each emitted frame's local offset (the debug aids). The sink's
        calls add up to one `sink` stage of the block whose sequence
        number is `block`."""
        self._block, self._sink_s = block, 0.0
        emitted = self._apply(out, keep, min_offset, now, on_frame)
        self.stats.stages.add("sink", self._sink_s)
        return emitted

    def _apply(self, out, keep, min_offset, now, on_frame) -> int:
        stats = self.stats
        if self.ext_batch_fn is not None:
            return self._call(self.ext_batch_fn, out, now, self.icao_cache, min_offset=min_offset)
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
                self._call(self.on_packet, packet)
                emitted += 1
            return emitted
        idx = np.nonzero(keep)[0]
        if self.batch_fn is not None:
            if self.recover2:
                idx, n_r2 = _gate_recover2_batch(idx, out["fields"]["icao"], out["recovered2"], self.seen_icaos)
                stats.recovered2 += n_r2
            return self._call(self.batch_fn, out["fields"], idx, now)
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
            self._call(self.on_packet, AdsbPacket.from_bytes(frame, now))
            emitted += 1
            if on_frame is not None:
                on_frame(int(out["offsets"][k]))
        return emitted


def _received(prefetcher: Prefetcher, stages: StageTimer) -> Iterator[tuple[int, np.ndarray]]:
    """The prefetcher's blocks with their sequence numbers; each block's
    wait (`source`) and its handoff from the prefetch thread timed."""
    for seq, block in enumerate(prefetcher):
        asked, received = prefetcher.asked, prefetcher.received
        stages.add("source", received - asked, start=asked, block=seq)
        stages.add("handoff", received - prefetcher.got, start=prefetcher.got, block=seq,
                   thread=prefetcher.thread_name)
        yield seq, block


def _decode_fn(extended: bool, batched: bool):
    """The block decode for a stream, one of airjax's six with its
    recover2 (airjax/runner.py:204-223)."""
    if extended:
        return decode_iq_block_extended_with_fields if batched else decode_iq_block_extended
    return decode_iq_block_with_fields if batched else decode_iq_block


def _run(source: Iterator[np.ndarray], prefetch_depth: int, framing, engine, sink: _Sink, stats: StreamStats,
         depth: int) -> StreamStats:
    """The stream loop of both runners (airjax/runner.py:382-407, :601-686;
    the module docstring says how it keeps decodes in flight). `framing`'s
    `decodes(seq, block)` are a received block's decodes, `tail(seq)` those
    of the source's end after block `seq`: each (sequence number,
    engine.dispatch's arguments, the source samples it holds, the job),
    its carry timed. `framing.rows(out, job)` turns the dict that
    `engine.collect` fetched into _Sink.apply's rows, mask, minimum offset
    and frame callback, and its `recovered` count."""
    stages = stats.stages
    inflight: collections.deque = collections.deque()

    def process(entry) -> None:
        slot, now, n_samples, job, seq, held = entry
        t_fetch = time.perf_counter()
        stages.add("hold", t_fetch - held, start=held, block=seq)
        with stages.stage("fetch", block=seq):
            out, overflowed = engine.collect(slot)
        t_apply = time.perf_counter()
        rows, keep, min_offset, on_frame, recovered = framing.rows(out, job)
        emitted = sink.apply(rows, keep, min_offset, now, on_frame, seq)
        stages.add("apply", time.perf_counter() - t_apply, start=t_apply, block=seq)
        # A tail flush is a decode, not a source block (n_samples=0).
        stats.blocks += 1 if n_samples else 0
        stats.samples += n_samples
        stats.detections += int(out["n_detections"])
        stats.good += emitted
        stats.recovered += recovered
        # Decodes that needed a regrow (the regrown result's flag is clear).
        stats.overflow_blocks += overflowed

    def run(decodes) -> None:
        for seq, args, n_samples, job in decodes:
            with stages.stage("dispatch", block=seq):
                slot = engine.dispatch(*args)
            # `now` is stamped at dispatch, as airjax does; the hold starts here.
            inflight.append((slot, time.time(), n_samples, job, seq, time.perf_counter()))
            while len(inflight) > max(depth, 0):
                process(inflight.popleft())
        # No block ready behind the last: nothing would overlap the decodes
        # in flight, so fetch them now rather than at the next block.
        while inflight and not prefetcher.ready():
            fetched = engine.fetches
            process(inflight.popleft())
            stats.early_fetches += engine.fetches - fetched  # regrows fetch too

    prefetcher = Prefetcher(source, depth=prefetch_depth)
    seq = -1
    for seq, block in _received(prefetcher, stages):
        run(framing.decodes(seq, block))
    run(framing.tail(seq))
    while inflight:
        process(inflight.popleft())
    stats.fetches, stats.overlapped = engine.fetches, engine.overlapped
    stats.backlog_max = prefetcher.backlog_max
    stats.graphs = engine.summary()
    return stats


def _non_detecting(n: int) -> np.ndarray:
    """n samples of the non-detecting (1,0)-magnitude pattern: the initial
    carry (a zero carry passes the equality-tolerant gate at every offset)
    and the warm-up step."""
    return pad_iq_non_detecting(np.zeros((0, 2), dtype=np.int16), n)


class _Blocks:
    """run_stream's framing: a decode a block, alone (parity) or behind the
    carry of the last 239 samples (overlap), short reads joined to the
    next; in overlap mode the carry flushed at the source's end."""

    def __init__(self, cfg: PipelineConfig, overlap: bool, stages: StageTimer, debug: tuple | None):
        self.capacity, self.overlap, self.stages, self.debug = cfg.max_candidates, overlap, stages, debug
        self.carry = _non_detecting(_HALO) if overlap else None
        self.base = -_HALO  # global sample index of carry[0]
        self.pending = np.zeros((0, 2), dtype=np.int16)

    def decodes(self, seq: int, block: np.ndarray):
        t_carry = time.perf_counter()
        block = np.asarray(block, dtype=np.int16)
        if self.overlap and len(self.pending):
            # Short reads accumulate rather than being dropped.
            block = np.concatenate([self.pending, block], axis=0)
            self.pending = self.pending[:0]
        if block.shape[0] < WINDOW:
            if self.overlap:
                self.pending = block
            self.stages.add("carry", time.perf_counter() - t_carry, start=t_carry, block=seq)
            # parity: the reference cannot scan a block < 240 samples.
            return
        if self.overlap:
            full = np.concatenate([self.carry, block], axis=0)
            if full.shape[0] >= TUNED_STREAM_MIN:
                slice_len = (full.shape[0] // 1024) * 1024
                n_off = slice_len - 240
                ext = full[:slice_len]
            else:
                n_off = full.shape[0] - _HALO
                ext = full
            self.carry = full[n_off:].copy()
        else:
            n_off = block.shape[0] - WINDOW
            ext = block
        self.stages.add("carry", time.perf_counter() - t_carry, start=t_carry, block=seq)
        yield self._decode(seq, ext, n_off, block.shape[0])

    def tail(self, seq: int):
        if self.overlap and len(self.pending):
            # A final short read still ends the stream: frames ending inside
            # it are scannable once appended to the carry.
            self.carry = np.concatenate([self.carry, self.pending], axis=0)
        if self.overlap and self.carry.shape[0] > _HALO:
            # The carry's offsets whose windows end at the stream end,
            # numbered as the block after the source's last.
            yield self._decode(seq + 1, self.carry, self.carry.shape[0] - _HALO, 0)

    def _decode(self, seq: int, ext: np.ndarray, n_off: int, n_samples: int) -> tuple:
        base = self.base  # the job keeps `ext` for the debug aids
        if self.overlap:
            self.base += n_off
        return seq, (ext, n_off, self.capacity), n_samples, (ext, base)

    def rows(self, out: dict, job: tuple) -> tuple:
        ext, base = job
        good = out.get("good")
        if good is not None and self.overlap:
            # int64 before adding the base: it passes 2^31 after ~18 min of
            # stream (airjax/runner.py:283-289). Offsets below 0 are the
            # padded head of the first block.
            good = good & (out["offsets"].astype(np.int64) + base >= 0)
        on_frame = self.debug and functools.partial(_debug_frame, ext, base if self.overlap else 0, *self.debug)
        return out, good, -base if self.overlap and base < 0 else None, on_frame, int(np.sum(out["recovered"]))


def run_stream(
    source: Iterator[np.ndarray],
    on_packet: Callable[[AdsbPacket], None],
    cfg: PipelineConfig = DEFAULT_CONFIG,
    overlap: bool = True,
    prefetch_depth: int = 4,
    stats: StreamStats | None = None,
    plot_dir: str | None = None,
    extended: bool = False,
    pipeline_depth: int = 1,
    dump_preamble: bool = False,
    recover2: bool = False,
    *,
    device: torch.device | str = "cuda",
) -> StreamStats:
    """Consume a block source until exhausted; call on_packet per packet
    (with extended=True, also AllCallReply, SurveillanceReply, AcasReply
    and CommDReply objects), or hand a batched sink each block. plot_dir
    and dump_preamble are the debug aids (module docstring).

    Up to pipeline_depth decodes stay in flight before the oldest is
    fetched (airjax/runner.py:105-116, :382-407): block k+1's upload and
    kernels overlap block k's fetch and packet assembly. That holds block k
    only while the source has a block ready; when it has none, the decodes
    in flight are fetched and applied at once, oldest first, so a paced
    receiver's block reaches the sink after its own decode and not a block
    period later (stats.early_fetches counts them). Packets come out in
    stream order at every depth; 0 is the serial form. prefetch_depth
    bounds the source's read-ahead queue (io.source.Prefetcher).

    The parameters are airjax's, in airjax's order; `device`, by keyword,
    is where the blocks decode (the card unless the caller asks for "cpu")."""
    stats = stats or StreamStats()
    # A batched sink (track.batch): on_fields in DF17 mode, on_extended_block
    # in extended mode; any other sink, or the debug aids, take packets.
    debug = (plot_dir, dump_preamble, extended) if plot_dir is not None or dump_preamble else None
    sink = _Sink(on_packet, extended, recover2, stats, per_packet=debug is not None)
    graphs = BlockGraphs(_decode_fn(extended, sink.batched), recover2=recover2, device=device,
                         depth=pipeline_depth)
    return _run(source, prefetch_depth, _Blocks(cfg, overlap, stats.stages, debug), graphs, sink, stats,
                pipeline_depth)


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


class _Steps:
    """run_stream_sharded's framing: steps of F = T - 239 fresh samples
    behind the carry of the last 239, the rest in a padded last step."""

    def __init__(self, T: int, extended: bool, recover2: bool, batched: bool, stages: StageTimer):
        self.T, self.F = T, T - _HALO
        self.extended, self.recover2, self.batched, self.stages = extended, recover2, batched, stages
        self.count_key = "n_candidates" if extended else "n_good"
        # Its offsets masked by base < 0.
        self.carry = _non_detecting(_HALO)
        self.base = -_HALO
        self.acc = np.zeros((0, 2), dtype=np.int16)

    def decodes(self, seq: int, blk: np.ndarray):
        t_carry = time.perf_counter()
        blk = np.asarray(blk, dtype=np.int16)
        self.acc = np.concatenate([self.acc, blk], axis=0) if len(self.acc) else blk
        self.stages.add("carry", time.perf_counter() - t_carry, start=t_carry, block=seq)
        while self.acc.shape[0] >= self.F:
            fresh, self.acc = self.acc[: self.F], self.acc[self.F :]
            yield self._step(seq, fresh, None)

    def tail(self, seq: int):
        # The last, partial step: only offsets whose window fits in carry +
        # acc are real.
        if len(self.acc):
            yield self._step(seq, self.acc, _HALO + len(self.acc) - WINDOW)

    def _step(self, seq: int, fresh: np.ndarray, max_local: int | None) -> tuple:
        """A step of the block numbered `seq`, its carry (the join and the
        pad, the next carry's copy) timed."""
        t_carry = time.perf_counter()
        full = np.concatenate([self.carry, fresh], axis=0)
        if full.shape[0] < self.T:
            full = pad_iq_non_detecting(full, self.T)
        self.carry = full[self.F :].copy()
        self.stages.add("carry", time.perf_counter() - t_carry, start=t_carry, block=seq)
        base = self.base
        self.base += self.F
        return seq, (full,), fresh.shape[0], (base, max_local)

    def rows(self, out: dict, job: tuple) -> tuple:
        base, max_local = job
        n = int(out[self.count_key])
        rows = sharding.compact_rows(out, n)
        # int64: the stream base passes 2^31 after ~18 min of stream.
        offs = rows["offsets"].astype(np.int64)
        # The padded head of the first step (base < 0) and, on the padded
        # last step, offsets whose window runs past the stream's end.
        ok = offs + base >= 0
        if max_local is not None:
            ok &= offs <= max_local
        if self.extended:
            unp = sharding.unpack_extended_compact(rows, n)
            if max_local is not None:
                # Padding candidates must not even seed the ICAO cache:
                # run_stream never scans those offsets.
                for k in sharding._EXT_MASK_KEYS + (("recovered2",) if self.recover2 else ()):
                    unp[k] = unp[k] & (offs <= max_local)
            recovered = int(np.sum(unp["recovered"]))
            if self.batched:
                unp["fields"] = rows["fields"]
                unp["short_fields"] = rows["short_fields"]
            rows = unp
        else:
            recovered = int(np.sum(rows["recovered"][ok]))
        return rows, ok, -base if base < 0 else None, None, recovered


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
    device: torch.device | str = "cuda",
) -> StreamStats:
    """The stream decoded over a mesh (airjax/runner.py:410-686): `mesh`, or
    make_mesh(n_devices, device=device) (the cards, unless device="cpu").

    Blocks are gathered into steps of T = shard_block * D samples
    (`_Steps`); a step is the compact sharded decode (parallel/halo.py:
    each shard's front and block decode, then one shard gather), and a
    carry of the last 239 samples joins each step to the next, so every
    offset of the stream is scanned once and the emitted stream equals
    run_stream's in overlap mode. The last step is padded with the
    non-detecting pattern and its offsets past the stream's end dropped.
    On a mesh of one card a step is one CUDA graph replay (halo.StepGraphs;
    the warm-up step, decoded before the source is read, is its shape's
    first sighting, run eagerly); on a mesh over several cards it launches
    eagerly (halo.EagerSteps). Steps stay in flight as run_stream's blocks
    do: up to `pipeline_depth`, and none once the source has no block ready
    (stats.early_fetches). A step that overflows is decoded again from its
    own device input with K and C grown 4x, and the later steps run at the
    grown K and C. `stats.graphs` counts the step graphs' first sightings,
    captures and replays and the bytes their slots hold. Sinks as
    run_stream: per packet, or a batched one (`on_fields`,
    `on_extended_block`), whose fields the shard gather writes for the
    gathered rows in the same launch (its flag F); recover2 gates as there.

    `detections` counts each step's last 239 offsets twice, by design: a
    step scans them with the wrapped halo (and masks their hits), the next
    one with the real samples. `good` and the packets are exact.
    """
    from airjax_torch.parallel.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh(n_devices, device=device)
    stats = stats or StreamStats()
    sink = _Sink(on_packet, extended, recover2, stats)
    block = shard_block or sharding.tuned_block(max(16384, cfg.block_len))
    T = block * mesh.size  # samples a step
    K = capacity_per_shard or cfg.max_candidates
    C = compact_capacity or max(128 if not extended else 512, K)
    # One card: a graph a step shape; a mesh over several cards launches
    # its steps eagerly (halo.EagerSteps: the peer copies to the first card).
    engine = sharding.StepGraphs if len(set(mesh.devices)) == 1 else sharding.EagerSteps
    steps = engine(mesh, block, K, C, extended=extended, recover2=recover2, with_fields=sink.batched,
                   depth=pipeline_depth)
    # A warm-up step on the non-detecting pattern before the source is read
    # (airjax :521-530), the first sighting of the stream's step shape: the
    # kernels build and load here, not while frames of the first step age
    # in the ICAO cache's 60 s window. It never overflows.
    steps.collect(steps.dispatch(_non_detecting(T)))
    return _run(source, 4, _Steps(T, extended, recover2, sink.batched, stats.stages), steps, sink, stats,
                pipeline_depth)
