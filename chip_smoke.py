#!/usr/bin/env python3
"""Smoke run of the airjax_torch port on one CUDA card.

  python3 chip_smoke.py

Phases; any failure raises and the exit code is nonzero:
  1. environment: a CUDA card, the torch/CUDA/nvcc versions, the card's
     name and power limit;
  2. build: nvcc compiles airjax_torch/csrc/*.cu for sm_90a into
     build/airjax_torch/ (timed);
  3. kernel against plain on the card, bit for bit: the bit-emitting
     front (csrc/front.cu, both gates) against its plain version and
     against the old front's mask packed; the old front (csrc/magdet.cu)
     in mode packed with both gates (DF17, preamble only); the planes
     kernel (csrc/planes.cu: its front form with both gates, its tree32,
     tree16 and flat16 forms) against its plain versions, against the
     first forms it replaced (csrc/magdet.cu mode planes and stencil
     kernel, kernels/magdet.py::magdet_planes_baseline) and, for the
     stencil forms, against its front form, one planes launch a call and
     none of the first forms; the first forms against their plain
     versions; all on int16 extremes, small-range noise (ties and
     detections at every tile edge), the ragged lengths 20239 /
     65536+777 / 2^22+13, the block of phase 4, and three of these from a
     base 4 bytes past a 16-byte boundary; the compaction kernel against its plain version on
     both blocks' bits, an empty mask, a dense random mask with K below the
     total and with K = n_off, and a ragged n_off; the candidate kernel in
     both modes (DF17 frames, and every downlink format, with 1-bit flips
     in the data bits and the CRC field, plus random offsets and the
     blocks' own candidates); the block-decode kernel (csrc/block_decode.cu)
     in both modes against its plain version and the staged chain
     (compaction and candidate kernels, then the dict ops) on the
     compaction's six inputs and the candidate inputs' IQ; each kernel
     timed at the main paths' shapes (CUDA events, and the profiler's
     device time) against its plain version, its bound and, for the
     compaction, torch.nonzero_static;
  4. one block at bench.py's shape (2^24 + 1024 samples, n_off = 2^24 - 240,
     capacity 2048, 1024 DF17 frames at multiples of 300, noise 60):
     every frame decoded, the front and block-decode kernels launched once
     each and no other kernel; kernel path, plain path and the batched
     pass (decode_iq_block_with_fields: two launches, the block decode
     with F, and no fields kernel) timed (median of
     CUDA-event passes), then profiled (torch.profiler, 10 passes each,
     counted by the block-decode kernel): device time per kernel and per
     pass, the busy time against this run's CUDA-event pass time, the
     front kernel's bytes moved per second, and a kernel-path pass that
     runs those two kernels, at most one memset and nothing else;
  5. two A/Bs in turns, in one run: the block pass through the staged
     chain (front, compaction and candidate kernels, dict ops) against the
     front and the block-decode kernel, for the DF17 and the extended
     block (pass time, device busy time, idle share); and the planes A/B
     (airjax's tools/bench_stencil3.py, the path the planes forms serve)
     on the 2^24-sample block: each form of csrc/planes.cu (front with
     both gates, tree32, tree16, flat16), each first form it replaced
     (csrc/magdet.cu) and magdet_bits (the same gate, bits out), in two
     turns of CUDA events and two of profiler device time, with GB/s
     against the planes' 30.05 µs bound;
  6. a 20 M-sample (10 s at 2 MS/s) capture with ~600 frames, some
     straddling the 20,000-sample chunk edges and some corrupted, replayed
     through the CLI (`adsb --playback FILE --fast`): overlap mode emits
     every frame once, in order, its first block eager and every other a
     replay of a captured graph (pipeline.BlockGraphs), a front and a block
     decode counted a block; `--devices 1` (the sharded runner on a
     one-card mesh) the same list; --no-overlap loses the straddlers; the
     hit lists equal the plain path's on the card;
  7. the extended decode of every downlink format on a 2^24 + 1024-sample
     block (1024 aircraft, each a DF17 before its DF0/4/5/11/16/20/21/24
     replies, noise 60; capacity from the plain path's detection count):
     every embedded frame in its class, the dict equal to the plain
     path's, the front and block-decode kernels launched once each, both
     paths timed and profiled as in phase 4;
  8. a 4 M-sample mixed-format capture through
     `adsb --playback FILE --fast --extended`: its packet text equals the
     plain path's assembly on the card (`Processed Time` masked), every
     embedded frame emitted, the corrupted DF17s repaired.
  9. the recover2 block (after phase 4): 2^24 + 1024 samples, 1024 DF17
     frames, 256 of them with a 2-bit flip in bits 5-87:
     decode_iq_block_r2 decodes all 1024 (256 recovered2, repaired to the
     frames as made, == the plain path), decode_iq_block the 768 clean
     ones, decode_iq_block_extended(recover2=True) puts all 1024 in
     good_long; each a pass of the front and the block-decode kernel;
     timed and profiled as phase 4, and both batched passes with recover2
     (two launches each, as phase 4's);
 10. the tracker stream: 300 aircraft over 30 s at 2 MS/s (60 M samples in
     20,000-sample blocks; positions at 2/s, velocities at 1/s, IDs every
     5 s, DF11/DF4/DF5/DF20 replies; 1% of the DF17s with a 1-bit and 1%
     with a 2-bit flip) through run_stream into a per-packet table,
     BatchTracker with and without --recover2, a per-packet extended table
     and ExtendedBatchTracker with --recover2, WebDisplay's batched sink
     in-process (GET /api/aircraft read back, the server shut down), and
     ExtendedBatchTracker without it: the batched tables equal the
     per-packet ones, every aircraft has its callsign, altitude and a
     position within CPR resolution of the truth, recovered2 equals the
     gated 2-flip frames, each batched pass launched the block decode with
     F once and the fields kernel never, every block but the first a graph
     replay; MS/s, msgs/s and stages printed per run;
 11. the mesh paths: a 2^26-sample capture (4096 DF17 frames, one at each
     shard edge and one ending at the capture's end) through
     decode_capture_sharded and decode_capture_sharded_extended on 4 shards
     of the card (2^24 samples each) and on make_mesh(1): hits and packets
     == decode_capture_overlap's == the embedded frames, each step a front
     and a block decode a shard and one shard gather; a sharded step
     profiled (each kernel's device time, launches and bound, and nothing
     else on the card); the shard-gather kernel (csrc/shard_gather.cu)
     against its plain version on the steps' shards and on random ones (D
     1 and 4, both modes, with and without R2, C below and above the
     total), timed at the step's shapes; the gather's flag F (the fields of
     the gathered rows in the same launch) against its plain version and
     against the gather then the fields kernel on the same cases; the
     sharded batched steps (with_fields: DF17, extended, each with and
     without recover2) each profiled (a front and a block decode a shard,
     one gather with F, no fields kernel), their dicts == the plain
     version's == the gather + fields kernel's, and F against that chain
     in turns at the step's shapes; analyze_capture (overlap and
     devices=1) and analyze_capture_extended on the first 2^25 samples of
     phase 10's traffic, their fixes == the per-packet tracker's at the same
     offsets, one fields launch an analysis; decode_channels on 8 channels
     of 2^21 samples; run_stream_sharded with BatchTracker, BatchTracker
     --recover2 and ExtendedBatchTracker on 4 shards, the tables ==
     run_stream's, a gather with F and no fields launch a step; MS/s of
     each path;
 12. the multi-process decode (parallel/multihost.py): one process on 4
     shards, 2 gloo worker processes on card 0, NCCL a rank a card; every
     rank == the one process;
 13. the golden oracle == decode_capture_parity fused and per chunk on 2 M
     samples of phase 10's traffic, the fused form's detection count one
     launch of the front's count mode (csrc/front.cu) and none of
     csrc/magdet.cu; the count mode == its plain version == the first
     front's mask count on 2 M and 2^24 samples, timed in turns against it;
     adsb --dump-preamble card == CPU; adsb --trace names the kernels;
 14. the pipelined stream (run_stream's pipeline_depth, pipeline.Fetcher):
     phase 6's stream at depths 0, 1, 2 and 4 (the embedded frames, in
     order; one eager block, depth + 1 captures, the rest replays),
     ExtendedBatchTracker, BatchTracker --recover2 and
     run_stream_sharded on 4 shards of the card at depths 0 and 1 (tables
     equal), phase 4's block fed 8 times at depths 0 and 1 (block k+1
     pending at block k's fetch in at least half the blocks at depth 1; a
     profiler window: fronts and block decodes, no other kernel); MS/s and
     the dispatch/fetch/apply ms of each;
 15. live input through the fake SoapySDR (native/fake_soapysdr.c): list,
     receive --synthetic and receive write what they should; adsb
     --max-blocks 50 decodes the capture's frames 50 times over through the
     native ring; native.decode_chunk == decode_capture_parity on the card;
 16. airjax_torch/tools as processes, all at once: fuzz_parity,
     fuzz_extended (and --recover2) at 20 iterations, soak 10 s, soak --sdr
     5 s, dryrun_multichip on Mesh([card 0] * 4); each exits 0. Then the
     SNR sweep at BASELINE config 2's size (8 SNRs x 8 captures), --golden,
     --extended --golden and --recover2 at once: each exits 0, wall times
     printed;
 17. modulate_device at phase 4's shape and frames: one seed one capture,
     decode_iq_block finds every frame at its offset, noise_std=0 on the
     card == the CPU's, timed by CUDA events and profiled against its
     bound and against the host `modulate`, its peak memory; the last
     airjax names the port took on (u32 magnitudes, slice_bits, the sparse
     byte reader, pack_cmp_words_reduce, compact_detections' tiles,
     compact_mask, decode_mags_block_r2) on the card == the CPU, and
     decode_iq_block_kernel == decode_iq_block in the same two launches;
     last, airjax's own calls with no device, decode_capture_overlap(iq)
     and run_stream(blocks, cb, DEFAULT_CONFIG, True, 2), run on the card
     (fronts and block decodes launched), == their device="cuda" forms;
 18. the measuring harness: airjax_torch.bench.bench() at its default size
     (R passes in one CUDA graph): the contract's keys, 1024 of 1024 frames
     a pass, the graph's counts == one eager pass's, the wrappers'
     launches, one replay profiled (the fronts, the block decodes and the
     sums' adds, nothing else); n_blocks=2 beside it; then graft_entry,
     bench_stream, bench_host, bench_extended and scaling_sweep --one-card
     at small sizes as processes, all at once; each exits 0;
 19. the pass's cost by nested prefixes (airjax_torch/tools/bench_stages.py,
     airjax's tools/bench_stages.py) on its capture at 2^24 + 1024 samples:
     detect (the count-mode front), compact and pack (the bits front and the
     compaction kernel), full (the front and the block decode): each
     stage's pair == its plain version's on the same card tensor, the
     graph's sums == the eager passes', the launches through the wrappers,
     one replay of the R = 2 graph profiled (the stage's kernels and the
     sums' small kernels, nothing else); each stage's line printed;
 20. one program a block (pipeline.BlockGraphs, run after phase 14): one
     replay of each of the five block decodes on phase 6's block shape ==
     the eager wrappers bit for bit, one front and one block decode
     counted, and under the profiler those two kernels, the block's upload
     and the dict's one download and nothing else (the overlap scan's form:
     a device copy, then the same); phase 6's stream through run_stream
     with the eager form it replaced (the wrappers and pipeline.Fetcher)
     and with the graphs, in turns at depths 0 and 1, then `adsb
     --playback --fast` the same way: dispatch, fetch and apply ms a block
     and MS/s; the 2^24 block: a replay against an eager pass (CUDA events)
     and bench.measure's graph slope, the kernels' device time in each,
     the overlap form's host time a block, the slot's memory;
 21. one program a sharded step (parallel/halo.py::StepGraphs, run after
     phase 20): one replay of each step variant (DF17, --recover2, batched
     with the gather's F, extended, extended batched --recover2) on phase
     14's step shape, on 4 shards of the card and on make_mesh(1) == the
     eager step bit for bit, D fronts, D block decodes and one gather
     counted, and under the profiler one upload, those kernels and one
     download, nothing else; a 4-shard replay against the eager step (CUDA
     events, the kernels' device time); phase 14's sharded stream (depths
     0 and 1) and phase 11's three (depth 1) with the eager step
     (halo.EagerSteps) and the graphs in turns, tables == run_stream's,
     then `adsb --playback --fast --devices 1` the same way: dispatch,
     fetch and apply ms a step, MS/s, the slots' bytes.
`chip_smoke.py --cards` (4 or more cards): the mesh paths across cards,
dryrun_multichip on make_mesh(4), and phase 12 with NCCL across 4 cards.
Phase 3 also holds the block-decode kernel's recover2 (R2) instantiations
to their plain versions, and to the mode without R2 where no pair repair
applied, on its inputs plus the recover2 block and every format with 2-bit
flips anywhere, 3-bit bursts and CRC-field flips (the pair lookup is the
hashed table of kernels/block_decode.py::pair_hash_table); the four F
instantiations (both modes, with and without R2) to their plain versions
and to the chain they replace (the block decode, then the fields kernel)
on the same inputs, each timed against its bound (block_decode_work and
fields_work, less the frames' re-read) and beside the chain's device time;
and the fields kernel (csrc/fields.cu, the A/B baseline), both modes, to
its plain version on the blocks' dicts and on random rows that take every
byte value.

Prints the kernel table as one JSON line (`launches` counted on the path
named in `path`, with every count set to 0 just before it; `bound_ms` the
larger of the bytes moved once over 3.35 TB/s and the operations over 67
TFLOP/s), the card's name and power limit (nvidia-smi), and last
`{"ok": true, "device": {...}}`. Imports no jax. Exits nonzero, before
printing any result, without a CUDA card. Loads no module of the JAX
package `airjax` either.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# torch.profiler keeps CUPTI attached from one window to the next unless
# TEARDOWN_CUPTI is 1; late in a long process a CUPTI kept so misses the
# first launches of a window (up to 6 kernel events), and one attached anew
# for each window misses none. Set before torch is imported.
os.environ["TEARDOWN_CUPTI"] = "1"

import numpy as np
import torch

BLOCK = 1 << 24
HALO = 1024
CAPACITY = 2048
CHUNK = 20000
STREAM_SAMPLES = 20_000_000  # 10 s at 2 MS/s
EXT_STREAM_SAMPLES = 4_000_000  # 2 s at 2 MS/s
# csrc/planes.cu's rows: (form, gate), and the row of the first form each
# replaced (csrc/magdet.cu: mode planes, the stencil kernel), its A/B
# baseline and second oracle.
PLANES = {"planes_front": ("front", "df17"), "planes_front_preamble": ("front", "preamble"),
          "planes_tree32": ("tree32", "df17"), "planes_tree16": ("tree16", "df17"),
          "planes_flat16": ("flat16", "df17")}
BASELINES = {"planes_front": "magdet_front_planes", "planes_front_preamble": "magdet_front_planes_preamble",
             "planes_tree32": "magdet_tree_tree32", "planes_tree16": "magdet_tree_tree16",
             "planes_flat16": "magdet_tree_flat16"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per pass."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over tensor pairs (0 when bit-exact)."""
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {b.shape}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def make_frames(n: int, seed: int) -> list[bytes]:
    from airjax_torch.io import synth

    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        icao = int(rng.integers(1, 1 << 24))
        if i % 2:
            me = synth.make_position_me(
                11, 1000 + 25 * int(rng.integers(0, 1500)), int(rng.integers(0, 1 << 17)),
                int(rng.integers(0, 1 << 17)), bool(i % 4 == 1),
            )
        else:
            me = synth.make_id_me(f"GPU{i % 100000:05d}")
        frames.append(synth.make_df17(icao, me))
    return frames


def phase_env() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    from airjax_torch import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    card = nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"card: {card}; {torch.cuda.device_count()} device(s)")
    return card


def phase_build() -> None:
    from airjax_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def mixed_capture(n_aircraft: int, n_samples: int, span: int, seed: int, flips: int = 0):
    """Every downlink format (synth.make_mixed_frames) at sorted random
    multiples of 300 whose windows end inside the first `span` samples, so
    each aircraft's DF17 precedes its replies; `flips` DF17s sent with a
    data-bit flip past the DF field. Returns (iq, offsets, frames as made,
    indices of the flipped frames)."""
    from airjax_torch.io import synth

    rng = np.random.default_rng(seed)
    frames = synth.make_mixed_frames(n_aircraft, seed)
    slots = (span - 240) // 300
    offsets = np.sort(rng.choice(np.arange(slots) * 300, len(frames), replace=False))
    flipped = sorted(rng.choice(np.arange(0, len(frames), 10), flips, replace=False).tolist())
    sent = list(frames)
    for i in flipped:
        sent[i] = synth.flip_bit(frames[i], int(rng.integers(5, 88)))
    iq = synth.modulate(sent, list(map(int, offsets)), n_samples, noise_std=60.0, seed=seed)
    return iq, offsets, frames, flipped


def flipped_mixed_iq(seed: int):
    """Every downlink format with a third of the frames flipped in the data
    bits (past the DF field) and a third in the CRC field -> (iq, offsets)."""
    from airjax_torch.io import synth

    rng = np.random.default_rng(seed)
    frames = synth.make_mixed_frames(100, seed)
    for i, f in enumerate(frames):
        data = 88 if len(f) == 14 else 32
        if i % 3 == 1:
            frames[i] = synth.flip_bit(f, int(rng.integers(5, data)))
        elif i % 3 == 2:
            frames[i] = synth.flip_bit(f, int(rng.integers(data, 8 * len(f))))
    offs = np.arange(len(frames)) * 301 + 7
    return synth.modulate(frames, list(offs), len(frames) * 301 + 500, seed=seed), offs


# The card's peaks for bound_ms (NVIDIA's data sheet for the H100 SXM):
# HBM bytes/s, and fp32 operations/s outside the
# tensor cores, against which the kernels' integer operations are counted.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time for n_bytes moved once and
    n_ops operations, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def front_work(n_samples: int, n_off: int, gate: str, out_bytes: int) -> tuple[int, int]:
    """Bytes (IQ in, out_bytes out) and operations of a front: per sample
    two products, a sum, a square root and a compare; per offset one per
    tap (a min, max or the gate's compare): 26 with the DF17 taps, 16 with
    the preamble alone."""
    taps = 26 if gate == "df17" else 16
    return 4 * n_samples + out_bytes, 5 * n_samples + taps * n_off


def bits_bytes(n_samples: int, n_off: int) -> int:
    """What the bit-emitting front writes: det words, compare words, tile counts."""
    from airjax_torch.dsp.demod import n_words
    from airjax_torch.kernels.magdet import n_det_words, n_tiles

    return 4 * (n_det_words(n_off) + n_words(n_samples) + n_tiles(n_off))


def compact_work(n_off: int, k: int) -> tuple[int, int]:
    """Bytes of the compaction (det bits and tile counts in; offsets, gather
    offsets, valid and the count out) and its operations (a popcount per
    word, an add per tile, a write per slot)."""
    from airjax_torch.kernels.magdet import n_det_words, n_tiles

    return 4 * n_det_words(n_off) + 4 * n_tiles(n_off) + 9 * k + 4, n_det_words(n_off) + n_tiles(n_off) + k


# Windows a measurement profiles before it fails: a window that lost a
# device event (see TEARDOWN_CUPTI above) is profiled again.
PROFILE_TRIES = 10


def device_events(fn, calls: int) -> list:
    """The device events of `calls` calls of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(events: list) -> float:
    """The union of the events' device intervals, µs."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def device_us(fn, names: tuple[str, ...] = (), calls: int = 10) -> float:
    """Device µs per call of fn under torch.profiler: the kernels whose name
    holds one of `names` (every kernel if none), over `calls` calls. fn
    launches the kernels of each name the same number of times a call; a
    window whose count of a name is no multiple of `calls` is profiled
    again (PROFILE_TRIES windows, then it fails)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        events = [e for e in device_events(fn, calls) if not names or any(n in e.name for n in names)]
        seen = [sum(n in e.name for e in events) for n in names]
        if events and all(n and n % calls == 0 for n in seen):
            return sum(e.time_range.end - e.time_range.start for e in events) / calls
        print(f"device_us: the profiler dropped events ({dict(zip(names, seen))} in {calls} calls); again")
    check(False, f"device_us: the profiler dropped events of {names} in {PROFILE_TRIES} windows")


def library_call():
    """The one PyTorch call that computes the compaction, the yardstick
    `library_ms` (the port never calls it): nonzero_static where this
    torch has it, else nonzero."""
    if hasattr(torch, "nonzero_static"):
        return "torch.nonzero_static", lambda det, k, n_off: torch.nonzero_static(det, size=k, fill_value=n_off)
    return "torch.nonzero", lambda det, k, n_off: torch.nonzero(det)


def planes_fn(form: str, gate: str):
    """The public call that launches csrc/planes.cu in `form`:
    magdet(packed=False) or magdet_tree."""
    from airjax_torch.kernels.magdet import magdet
    from airjax_torch.kernels.stencil3 import magdet_tree

    if form == "front":
        return lambda iq, n_off: magdet(iq, n_off, packed=False, gate=gate)
    return lambda iq, n_off: magdet_tree(iq, n_off, form)


def planes_plain(form: str, gate: str):
    from airjax_torch.kernels.magdet import magdet_plain
    from airjax_torch.kernels.stencil3 import magdet_tree_plain

    if form == "front":
        return lambda iq, n_off: magdet_plain(iq, n_off, packed=False, gate=gate)
    return lambda iq, n_off: magdet_tree_plain(iq, n_off, form)


def planes_counts() -> tuple[int, int]:
    """(launches of csrc/planes.cu, launches of the first forms)."""
    from airjax_torch.kernels import magdet as magdet_mod
    from airjax_torch.kernels import stencil3

    return magdet_mod.planes_launches + stencil3.launches, magdet_mod.baseline_launches


def check_fronts(cases: list[torch.Tensor]) -> tuple[dict, dict, dict, dict, dict]:
    """The old front (mode packed, both gates), the bit-emitting front (both
    gates; against its plain version and against the old front's mask
    packed), the planes kernel (csrc/planes.cu, every form and both gates
    of the front form; against its plain version, the first forms and,
    for the stencil forms, its front form) and the first forms against
    their plain versions, on every case -> max abs errors, and the old
    front's launches by gate. Each planes call launches csrc/planes.cu
    once and no first form; each baseline call the reverse."""
    from airjax_torch.dsp.demod import pack_msb_words
    from airjax_torch.kernels import magdet as magdet_mod
    from airjax_torch.kernels.magdet import (
        GATES, magdet, magdet_bits, magdet_bits_plain, magdet_plain, magdet_planes_baseline, n_det_words,
        tile_counts)

    front_err = dict.fromkeys(GATES, 0)
    bits_err = dict.fromkeys(GATES, 0)
    planes_err = dict.fromkeys(PLANES, 0)
    baseline_err = dict.fromkeys(PLANES, 0)
    front_launches = dict.fromkeys(GATES, 0)
    for iq in cases:
        n_off = iq.shape[0] - 240
        for gate in GATES:
            before = magdet_mod.launches
            got = magdet(iq, n_off, gate=gate)
            front_err[gate] = max(front_err[gate], max_abs_err(zip(got, magdet_plain(iq, n_off, gate=gate))))
            det_old, words_old = got
            old = (pack_msb_words(det_old, n_det_words(n_off)), words_old, tile_counts(det_old))
            got = magdet_bits(iq, n_off, gate)
            err = max(max_abs_err(zip(got, magdet_bits_plain(iq, n_off, gate))), max_abs_err(zip(got, old)))
            bits_err[gate] = max(bits_err[gate], err)
            front_launches[gate] += magdet_mod.launches - before
        front = None
        for name, (form, gate) in PLANES.items():
            c0 = planes_counts()
            got = planes_fn(form, gate)(iq, n_off)
            c1 = planes_counts()
            base = magdet_planes_baseline(iq, n_off, form, gate)
            c2 = planes_counts()
            check((c1[0] - c0[0], c1[1] - c0[1], c2[0] - c1[0], c2[1] - c1[1]) == (1, 0, 0, 1),
                  f"{name}: a planes call launched {c1[0] - c0[0]} planes and {c1[1] - c0[1]} baseline kernels, "
                  f"a baseline call {c2[0] - c1[0]} and {c2[1] - c1[1]}")
            want = planes_plain(form, gate)(iq, n_off)
            err = max(max_abs_err(zip(got, want)), max_abs_err(zip(got, base)))
            if name == "planes_front":
                front = got
            elif form != "front":
                err = max(err, max_abs_err(zip(got, front)))
            planes_err[name] = max(planes_err[name], err)
            baseline_err[name] = max(baseline_err[name], max_abs_err(zip(base, want)))
    torch.cuda.synchronize()
    check(not any(front_err.values()), f"front kernel disagrees with plain (max abs err {front_err})")
    check(not any(bits_err.values()), f"bit-emitting front disagrees (max abs err {bits_err})")
    check(not any(planes_err.values()), f"the planes kernel disagrees (max abs err {planes_err})")
    check(not any(baseline_err.values()), f"a first planes form disagrees with plain (max abs err {baseline_err})")
    misaligned = sum(1 for iq in cases if iq.data_ptr() % 16)
    print(f"front kernel (mode packed) == plain on {len(cases)} inputs ({misaligned} at a 4-byte but not 16-byte "
          f"aligned base), both gates; the bit-emitting front == its plain version == the front's mask packed, "
          f"both gates; the planes kernel (csrc/planes.cu: front both gates, tree32, tree16, flat16) == plain == "
          f"the first forms (csrc/magdet.cu) on the same inputs, the stencil forms == its front form, one planes "
          f"launch a call and none of the first forms; the first forms == plain")
    return front_err, bits_err, planes_err, baseline_err, front_launches


def compaction_inputs(blocks: list[tuple[torch.Tensor, int, int, str]], rng) -> list[tuple]:
    """The compaction's six inputs: the blocks' bits, an empty mask, a dense
    random mask with K below the total and with K = n_off, and a ragged
    n_off -> [(name, det_words, tile_counts, n_off, K, compare words)]; the
    random masks get random compare words."""
    from airjax_torch.dsp.demod import n_words, pack_msb_words
    from airjax_torch.kernels.magdet import magdet_bits, n_det_words, tile_counts

    dev = blocks[0][0].device
    inputs = []
    for iq, n_off, k, gate in blocks:
        det_words, words, counts = magdet_bits(iq, n_off, gate)
        inputs.append((f"{gate} block", det_words, counts, n_off, k, words))
    for name, n_off, p, k in (("empty", 100_000, 0.0, CAPACITY), ("dense, K < total", (1 << 20) + 77, 0.3, 100_000),
                              ("dense, K = n_off", (1 << 20) + 77, 0.3, (1 << 20) + 77),
                              ("ragged", 3 * 8192 + 1007, 0.5, 64)):
        det = torch.as_tensor(rng.random(n_off) < p).to(dev)
        words = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, n_words(n_off + 240), dtype=np.int32)).to(dev)
        inputs.append((name, pack_msb_words(det, n_det_words(n_off)), tile_counts(det), n_off, k, words))
    return inputs


def check_compaction(inputs: list[tuple]) -> int:
    """The compaction kernel against compact_bits_plain on its six inputs
    -> max abs error."""
    from airjax_torch.kernels.compact import compact_bits, compact_bits_plain

    err = 0
    for name, det_words, counts, n_off, k, _ in inputs:
        got = compact_bits(det_words, counts, n_off, k)
        want = compact_bits_plain(det_words, counts, n_off, k)
        e = max_abs_err(zip(got, want))
        check(e == 0, f"compaction kernel disagrees with plain on {name} (max abs err {e})")
        print(f"  compaction == plain: {name}, n_off {n_off}, K {k}, {int(want[2])} detections"
              + (" (overflow)" if int(want[2]) > k else ""))
        err = max(err, e)
    torch.cuda.synchronize()
    return err


def check_block_decode(inputs: list[tuple]) -> dict[str, int]:
    """The block-decode kernel, both modes, against its plain version and
    against the staged chain (the compaction and candidate kernels, then
    the dict ops) on each input -> max abs error by mode."""
    from airjax_torch.kernels.block_decode import (
        candidate_dict, candidate_dict_extended, decode_block_bits, decode_block_bits_plain)
    from airjax_torch.kernels.candidate import decode_candidates, decode_candidates_extended
    from airjax_torch.kernels.compact import compact_bits

    err = {"df17": 0, "extended": 0}
    for name, det_words, counts, n_off, k, words in inputs:
        for mode, extended in (("df17", False), ("extended", True)):
            got = decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
            want = decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended)
            compacted = compact_bits(det_words, counts, n_off, k)
            staged = (candidate_dict_extended(compacted, words, k, decode_candidates_extended) if extended
                      else candidate_dict(compacted, words, k, decode_candidates))
            check(sorted(got) == sorted(want) == sorted(staged), f"block decode keys differ on {name}")
            e = max(max_abs_err((got[key], want[key]) for key in want),
                    max_abs_err((got[key], staged[key]) for key in want))
            check(e == 0, f"block-decode kernel ({mode}) disagrees on {name} (max abs err {e})")
            err[mode] = max(err[mode], e)
        print(f"  block decode == plain == staged chain, both modes: {name}, n_off {n_off}, K {k}, "
              f"{int(got['n_detections'])} detections" + (" (overflow)" if bool(got["overflow"]) else ""))
    torch.cuda.synchronize()
    return err


def check_block_decode_r2(inputs: list[tuple]) -> dict[str, int]:
    """The block-decode kernel's R2 instantiations, both modes, against
    their plain version (crc_check_and_recover2) on each input; and against
    the same mode without R2 on every slot whose frame no pair repair
    changed (the whole dict where none did) -> max abs error by mode."""
    from airjax_torch.kernels.block_decode import decode_block_bits, decode_block_bits_plain

    err = {"df17": 0, "extended": 0}
    for name, det_words, counts, n_off, k, words in inputs:
        n_pairs = []
        for mode, extended in (("df17", False), ("extended", True)):
            got = decode_block_bits(det_words, words, counts, n_off, k, extended=extended, recover2=True)
            want = decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended, recover2=True)
            check(sorted(got) == sorted(want), f"R2 block decode keys differ on {name}")
            e = max_abs_err((got[key], want[key]) for key in want)
            check(e == 0, f"block-decode kernel ({mode}, R2) disagrees with plain on {name} (max abs err {e})")
            err[mode] = max(err[mode], e)
            base = decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
            same = (got["frames"] == base["frames"]).all(dim=1)
            check(not bool(got["recovered2"][same].any()), f"{name}: a recovered2 slot's frame did not change")
            for key, v in base.items():
                if v.dim() and v.shape[0] == k:
                    check(bool(torch.equal(v[same], got[key][same])),
                          f"{name} ({mode}): R2 differs from the mode without it at {key} where no pair applied")
                elif bool(same.all()):
                    check(bool(torch.equal(v, got[key])), f"{name} ({mode}): R2 differs at {key}")
            n_pairs.append(int((~same).sum()))
        print(f"  block decode R2 == plain, both modes; == without R2 where no pair applied: {name}, "
              f"K {k}, slots pair-repaired {n_pairs[0]} (DF17) / {n_pairs[1]} (extended)")
    torch.cuda.synchronize()
    return err


def check_block_decode_fields(inputs: list[tuple]) -> tuple[dict[tuple[str, bool], int], dict[str, int]]:
    """The block-decode kernel's F instantiations (both modes, with and
    without R2) against their plain version (the plain dict, then
    block_fields_plain) and against the chain they replace (the block
    decode without F, then the fields kernel, csrc/fields.cu) on each input,
    bit for bit -> max abs error by (mode, R2), and the fields kernel's
    launches by mode."""
    from airjax_torch.kernels import fields as fields_mod
    from airjax_torch.kernels.block_decode import decode_block_bits, decode_block_bits_plain
    from airjax_torch.kernels.fields import block_fields

    chain_launches = {"df17": 0, "extended": 0}

    def flat(out: dict) -> dict:
        """The dict with its field dicts' entries as `fields.<key>`."""
        res = {}
        for key, v in out.items():
            res.update({f"{key}.{k}": t for k, t in v.items()} if isinstance(v, dict) else {key: v})
        return res

    err = {(m, r2): 0 for m in ("df17", "extended") for r2 in (False, True)}
    for name, det_words, counts, n_off, k, words in inputs:
        for (mode, r2) in err:
            extended = mode == "extended"
            args = (det_words, words, counts, n_off, k)
            got = flat(decode_block_bits(*args, extended=extended, recover2=r2, fields=True))
            want = flat(decode_block_bits_plain(*args, extended=extended, recover2=r2, fields=True))
            chain = decode_block_bits(*args, extended=extended, recover2=r2)
            before = fields_mod.launches
            chain["fields"], short = block_fields(chain["frames"], chain["frames_raw"] if extended else None)
            chain_launches[mode] += fields_mod.launches - before
            if extended:
                chain["short_fields"] = short
            chain = flat(chain)
            check(sorted(got) == sorted(want) == sorted(chain), f"F block decode keys differ on {name}")
            e = max(max_abs_err((got[key], want[key]) for key in want),
                    max_abs_err((got[key], chain[key]) for key in want))
            check(e == 0, f"block-decode kernel ({mode}, R2 {r2}, F) disagrees on {name} (max abs err {e})")
            err[(mode, r2)] = max(err[(mode, r2)], e)
        print(f"  block decode F == plain == block decode + fields kernel, both modes, with and without R2: "
              f"{name}, K {k}")
    torch.cuda.synchronize()
    return err, chain_launches


def pair_flip_iq(seed: int) -> torch.Tensor:
    """Every downlink format with 2-bit flips anywhere (the DF field
    included), 2-bit flips in bits 5-87 of half the DF17s, 1-bit flips,
    3-bit bursts and CRC-field flips -> IQ (host)."""
    from airjax_torch.io import synth

    rng = np.random.default_rng(seed)
    frames = synth.make_mixed_frames(150, seed)
    for i, f in enumerate(frames):
        nbits = 8 * len(f)
        if i % 20 == 0:
            bits = rng.choice(np.arange(5, 88), 2, replace=False)
        else:
            bits = {1: rng.choice(nbits - 24, 2, replace=False), 2: [int(rng.integers(0, nbits - 24))],
                    3: rng.choice(nbits, 3, replace=False), 4: rng.choice(np.arange(nbits - 24, nbits), 2, False),
                    0: []}[i % 5]
        for b in bits:
            f = synth.flip_bit(f, int(b))
        frames[i] = f
    offs = np.arange(len(frames)) * 301 + 7
    return synth.modulate(frames, list(offs), len(frames) * 301 + 500, seed=seed)


def check_fields(dicts: list[tuple[str, torch.Tensor, torch.Tensor | None]]) -> dict[str, int]:
    """The fields kernel, both modes, against its plain version on each
    (name, frames, frames_raw or None) -> max abs error by mode."""
    from airjax_torch.kernels.fields import block_fields, block_fields_plain

    err = {"df17": 0, "extended": 0}
    for name, frames, raw in dicts:
        got, want = block_fields(frames, raw), block_fields_plain(frames, raw)
        pairs = [(got[0][key], want[0][key]) for key in want[0]]
        check(sorted(got[0]) == sorted(want[0]), f"fields keys differ on {name}")
        if raw is not None:
            check(sorted(got[1]) == sorted(want[1]), f"short fields keys differ on {name}")
            pairs += [(got[1][key], want[1][key]) for key in want[1]]
        mode = "df17" if raw is None else "extended"
        e = max_abs_err(pairs)
        check(e == 0, f"fields kernel ({mode}) disagrees with plain on {name} (max abs err {e})")
        err[mode] = max(err[mode], e)
        print(f"  fields == plain ({mode}): {name}, K {frames.shape[0]}")
    torch.cuda.synchronize()
    return err


def fields_work(k: int, extended: bool) -> tuple[int, int]:
    """Bytes of the fields kernel (14 B a frame in, 21 with the raw bytes;
    out 24 int32 rows, the callsign and a flag, 105 B, or 166 B extended)
    and its operations (about 60 integer ops a slot, and the 32-step short
    CRC in the extended mode)."""
    if extended:
        return k * (21 + 4 * 39 + 10), k * (60 + 32 + 40)
    return k * (14 + 4 * 24 + 9), k * 60


def fields_in_block_work(work: tuple[int, int], k: int, extended: bool) -> tuple[int, int]:
    """A block decode's work (bytes, ops) plus the fields of its K slots
    under F: fields_work less the frames' re-read (14 B a slot, 21 with the
    raw bytes), which the F flag computes from registers."""
    f_bytes, f_ops = fields_work(k, extended)
    return work[0] + f_bytes - k * (21 if extended else 14), work[1] + f_ops


def block_decode_work(n_off: int, k: int, extended: bool) -> tuple[int, int]:
    """Bytes of the block-decode kernel (det bits and tile counts in, 32 B of
    compares gathered per slot; out per slot the offset, valid, the frame
    and the flags, 21 B, or 51 B with the extended fields, and the counts)
    and its operations (a popcount per word, an add per tile, a CRC step
    per bit and the 88 syndrome compares per slot)."""
    from airjax_torch.kernels.magdet import n_det_words, n_tiles

    n_in = 4 * n_det_words(n_off) + 4 * n_tiles(n_off) + 32 * k
    n_out = k * (4 + 1 + 14 + 4 + 4 + 4 + 14 + 6) + 5 if extended else k * (4 + 1 + 14 + 1 + 1) + 9
    return n_in + n_out, n_det_words(n_off) + n_tiles(n_off) + k * (112 + 88)


def phase_kernels(
    block_dev: torch.Tensor, ext_block_dev: torch.Tensor, capacity_ext: int, r2_block_dev: torch.Tensor
) -> tuple[list[dict], dict[str, int], dict[str, int]]:
    """Phase 3 -> the kernel table's entries of the decode paths, the
    planes kernel's and its first forms' max abs errors (PLANES' keys),
    and the old front's launches by gate."""
    from airjax_torch.dsp.demod import n_words, unpack_msb_words
    from airjax_torch.io import synth
    from airjax_torch.kernels.candidate import (
        decode_candidates,
        decode_candidates_extended,
        decode_candidates_extended_plain,
        decode_candidates_plain,
    )
    from airjax_torch.kernels.block_decode import decode_block_bits, decode_block_bits_plain
    from airjax_torch.kernels.compact import compact_bits, compact_bits_plain
    from airjax_torch.kernels.fields import block_fields, block_fields_plain
    from airjax_torch.kernels.magdet import magdet, magdet_bits, magdet_bits_plain, magdet_plain

    dev = block_dev.device
    rng = np.random.default_rng(12)

    # Fronts and stencil variants: extremes + full-range random at ragged
    # lengths, small-range noise, the block; and bases 4 bytes past a
    # 16-byte boundary (slices [1:] of the aligned tensors).
    cases = []
    for n in (20239, 65536 + 777, (1 << 22) + 13):
        iq = rng.integers(-32768, 32768, size=(n, 2), dtype=np.int16)
        iq[:8] = [[-32768, -32768], [32767, 32767], [-32768, 32767], [0, 0], [1, 0], [3, 4],
                  [255, 255], [256, 256]]
        cases.append(torch.as_tensor(iq).to(dev))
    cases.append(torch.as_tensor(rng.integers(-2, 3, size=((1 << 20) + 99, 2), dtype=np.int16)).to(dev))
    cases.append(block_dev)
    cases += [cases[1][1:], cases[3][1:], block_dev[1:]]
    front_err, bits_err, planes_err, baseline_err, front_launches = check_fronts(cases)
    n_off = BLOCK - 240
    block_inputs = compaction_inputs(
        [(block_dev, n_off, CAPACITY, "df17"), (ext_block_dev, n_off, capacity_ext, "preamble")], rng)
    compact_err = check_compaction(block_inputs)
    print("compaction kernel == plain on 6 inputs")

    # Candidate kernel: frames with 1-bit flips in the data bits and in the
    # CRC field, random offsets, and the block's own candidates.
    frames = make_frames(300, 3)
    sent = list(frames)
    for i in range(0, 300, 3):
        sent[i] = synth.flip_bit(frames[i], int(rng.integers(0, 88)))
    for i in range(1, 300, 3):
        sent[i] = synth.flip_bit(frames[i], int(rng.integers(88, 112)))
    offs = np.arange(300) * 301 + 7
    iq = torch.as_tensor(synth.modulate(sent, list(offs), 300 * 301 + 500, seed=4)).to(dev)
    det, words = magdet(iq, iq.shape[0] - 240)
    o = np.concatenate([offs, rng.integers(0, iq.shape[0] - 240, 500)]).astype(np.int32)
    inputs = [(words, torch.as_tensor(o).to(dev))]
    det_words_b, words_b, counts_b = magdet_bits(block_dev, n_off)
    inputs.append((words_b, compact_bits(det_words_b, counts_b, n_off, CAPACITY)[3]))
    cand_err = 0
    for w, off in inputs:
        got = decode_candidates(w, off)
        want = decode_candidates_plain(w, off)
        cand_err = max(cand_err, max_abs_err(zip(got, want)))
        if w is words:
            f, ok, rec = (t.cpu().numpy() for t in got)
            check(bool(ok[:300][0::3].all()) and int(rec[:300].sum()) == 100,
                  "data-bit flips not all repaired")
            check(not ok[:300][1::3].any(), "a CRC-field flip validated")
            check([bytes(r) for r in f[:300][0::3]] == frames[0::3], "repaired bytes differ")
    torch.cuda.synchronize()
    check(cand_err == 0, f"candidate kernel disagrees with plain (max abs err {cand_err})")
    print(f"candidate kernel == plain on {len(inputs)} inputs")

    # Extended mode: every downlink format with flips, random offsets, and
    # the extended block's own candidates.
    iq_m, offs_m = flipped_mixed_iq(13)
    iq_m = torch.as_tensor(iq_m).to(dev)
    _, words_m = magdet(iq_m, iq_m.shape[0] - 240, gate="preamble")
    o = np.concatenate([offs_m, rng.integers(0, iq_m.shape[0] - 240, 500)]).astype(np.int32)
    valid_m = torch.as_tensor(rng.random(len(o)) < 0.9).to(dev)  # some invalid slots
    ext_inputs = [(words_m, torch.as_tensor(o).to(dev), valid_m)]
    det_words_e, words_e, counts_e = magdet_bits(ext_block_dev, n_off, "preamble")
    _, valid_e, _, gather_e = compact_bits(det_words_e, counts_e, n_off, capacity_ext)
    ext_inputs.append((words_e, gather_e, valid_e))
    ext_err = 0
    for w, off, valid in ext_inputs:
        got = decode_candidates_extended(w, off, valid)
        want = decode_candidates_extended_plain(w, off, valid)
        check(sorted(got) == sorted(want), "extended candidate keys differ")
        ext_err = max(ext_err, max_abs_err((got[key], want[key]) for key in want))
    torch.cuda.synchronize()
    check(ext_err == 0, f"extended candidate kernel disagrees with plain (max abs err {ext_err})")
    print(f"candidate kernel, mode extended == plain on {len(ext_inputs)} inputs")

    # Block-decode kernel: the compaction's six inputs and the candidate
    # inputs' IQ (DF17 frames with flips, every format with flips), both
    # modes, against its plain version and the staged chain.
    for name, x, gate, k in (("DF17 frames with flips", iq, "df17", 1024),
                             ("every format with flips", iq_m, "preamble", 4096)):
        det_words_c, words_c, counts_c = magdet_bits(x, x.shape[0] - 240, gate)
        block_inputs.append((name, det_words_c, counts_c, x.shape[0] - 240, k, words_c))
    block_err = check_block_decode(block_inputs)
    print(f"block-decode kernel == plain == staged chain on {len(block_inputs)} inputs, both modes")

    # R2 (recover2): the same inputs, the recover2 block's bits, and every
    # format with 2-bit flips anywhere, 1-bit flips, 3-bit bursts and
    # CRC-field flips.
    det_words_r, words_r, counts_r = magdet_bits(r2_block_dev, n_off)
    iq_p = torch.as_tensor(pair_flip_iq(31)).to(dev)
    det_words_p, words_p, counts_p = magdet_bits(iq_p, iq_p.shape[0] - 240, "preamble")
    r2_inputs = block_inputs + [("the recover2 block", det_words_r, counts_r, n_off, CAPACITY, words_r),
                                ("every format with 2-bit flips", det_words_p, counts_p, iq_p.shape[0] - 240, 4096,
                                 words_p)]
    r2_err = check_block_decode_r2(r2_inputs)
    print(f"block-decode kernel, R2 == plain on {len(r2_inputs)} inputs, both modes")
    # F (the batched fields in the same launch): the same inputs, both
    # modes, with and without R2, against plain and the old chain.
    f_err, chain_fields_launches = check_block_decode_fields(r2_inputs)
    print(f"block-decode kernel, F == plain == block decode + fields kernel on {len(r2_inputs)} inputs, "
          f"both modes, with and without R2")

    # The fields kernel: both blocks' dicts, the recover2 block's, and K
    # random rows that take every byte value in every column.
    df17_dict = decode_block_bits(det_words_b, words_b, counts_b, n_off, CAPACITY)
    r2_dict = decode_block_bits(det_words_r, words_r, counts_r, n_off, CAPACITY, recover2=True)
    ext_dict = decode_block_bits(det_words_e, words_e, counts_e, n_off, capacity_ext, extended=True)
    rows = rng.integers(0, 256, (capacity_ext, 14), dtype=np.uint8)
    rows[:256] = np.arange(256, dtype=np.uint8)[:, None]
    rows_dev = torch.as_tensor(rows).to(dev)
    raw_dev = torch.as_tensor(rows[::-1].copy()).to(dev)
    fields_err = check_fields([("the DF17 block's frames", df17_dict["frames"], None),
                               ("the recover2 block's frames", r2_dict["frames"], None),
                               ("random rows", rows_dev, None),
                               ("the extended block's frames and raw frames", ext_dict["frames"],
                                ext_dict["frames_raw"]),
                               ("random rows", rows_dev, raw_dev)])

    # Times at the main paths' shapes: the 2^24-sample blocks, K = CAPACITY
    # (DF17) and K = capacity_ext (extended); the DF17 front also from a
    # base 4 bytes past a 16-byte boundary. ms and plain_ms: CUDA events
    # around each call (the wrapper's host time included); device_us: the
    # profiler's device time of the kernel alone.
    w_b, o_b = inputs[-1]
    w_e, o_e, v_e = ext_inputs[-1]
    det_b = unpack_msb_words(det_words_b, n_off)
    det_e = unpack_msb_words(det_words_e, n_off)
    lib_name, lib = library_call()
    L = block_dev.shape[0]
    old_packed = n_off + 4 * n_words(L)  # the old front's det bytes and compare words
    # name: (kernel, plain, library or None, kernel names for device_us, (bytes, ops))
    timed = {
        "magdet_bits": (lambda: magdet_bits(block_dev, n_off), lambda: magdet_bits_plain(block_dev, n_off), None,
                        ("magdet_bits_kernel",), front_work(L, n_off, "df17", bits_bytes(L, n_off))),
        "magdet_bits_misaligned": (lambda: magdet_bits(block_dev[1:], n_off),
                                   lambda: magdet_bits_plain(block_dev[1:], n_off), None, ("magdet_bits_kernel",),
                                   front_work(L - 1, n_off, "df17", bits_bytes(L - 1, n_off))),
        "magdet_bits_preamble": (lambda: magdet_bits(ext_block_dev, n_off, "preamble"),
                                 lambda: magdet_bits_plain(ext_block_dev, n_off, "preamble"), None,
                                 ("magdet_bits_kernel",), front_work(L, n_off, "preamble", bits_bytes(L, n_off))),
        "compact_bits": (lambda: compact_bits(det_words_b, counts_b, n_off, CAPACITY),
                         lambda: compact_bits_plain(det_words_b, counts_b, n_off, CAPACITY),
                         lambda: lib(det_b, CAPACITY, n_off), ("compact_",), compact_work(n_off, CAPACITY)),
        "compact_bits_extended": (lambda: compact_bits(det_words_e, counts_e, n_off, capacity_ext),
                                  lambda: compact_bits_plain(det_words_e, counts_e, n_off, capacity_ext),
                                  lambda: lib(det_e, capacity_ext, n_off), ("compact_",),
                                  compact_work(n_off, capacity_ext)),
        "magdet_front": (lambda: magdet(block_dev, n_off), lambda: magdet_plain(block_dev, n_off), None,
                         ("magdet_kernel",), front_work(L, n_off, "df17", old_packed)),
        "magdet_front_preamble": (lambda: magdet(ext_block_dev, n_off, gate="preamble"),
                                  lambda: magdet_plain(ext_block_dev, n_off, gate="preamble"), None,
                                  ("magdet_kernel",), front_work(L, n_off, "preamble", old_packed)),
        "candidate_crc": (lambda: decode_candidates(w_b, o_b), lambda: decode_candidates_plain(w_b, o_b), None,
                          ("candidate_kernel",), candidate_work(o_b.shape[0], extended=False)),
        "candidate_extended": (lambda: decode_candidates_extended(w_e, o_e, v_e),
                               lambda: decode_candidates_extended_plain(w_e, o_e, v_e), None,
                               ("candidate_kernel",), candidate_work(o_e.shape[0], extended=True)),
        "block_decode": (lambda: decode_block_bits(det_words_b, words_b, counts_b, n_off, CAPACITY),
                         lambda: decode_block_bits_plain(det_words_b, words_b, counts_b, n_off, CAPACITY), None,
                         ("block_decode_kernel",), block_decode_work(n_off, CAPACITY, extended=False)),
        "block_decode_extended": (
            lambda: decode_block_bits(det_words_e, words_e, counts_e, n_off, capacity_ext, extended=True),
            lambda: decode_block_bits_plain(det_words_e, words_e, counts_e, n_off, capacity_ext, extended=True),
            None, ("block_decode_kernel",), block_decode_work(n_off, capacity_ext, extended=True)),
        "block_decode_r2": (
            lambda: decode_block_bits(det_words_r, words_r, counts_r, n_off, CAPACITY, recover2=True),
            lambda: decode_block_bits_plain(det_words_r, words_r, counts_r, n_off, CAPACITY, recover2=True),
            None, ("block_decode_kernel",), r2_work(n_off, CAPACITY, False, r2_dict)),
        "block_decode_extended_r2": (
            lambda: decode_block_bits(det_words_e, words_e, counts_e, n_off, capacity_ext, extended=True,
                                      recover2=True),
            lambda: decode_block_bits_plain(det_words_e, words_e, counts_e, n_off, capacity_ext, extended=True,
                                            recover2=True),
            None, ("block_decode_kernel",), r2_work(n_off, capacity_ext, True, ext_dict)),
        "fields": (lambda: block_fields(df17_dict["frames"]), lambda: block_fields_plain(df17_dict["frames"]),
                   None, ("fields_kernel",), fields_work(CAPACITY, extended=False)),
        "fields_extended": (lambda: block_fields(ext_dict["frames"], ext_dict["frames_raw"]),
                            lambda: block_fields_plain(ext_dict["frames"], ext_dict["frames_raw"]),
                            None, ("fields_kernel",), fields_work(capacity_ext, extended=True)),
    }
    # The F instantiations on the same blocks, and the chain each replaces.
    f_blocks = {
        "block_decode_fields": ((det_words_b, words_b, counts_b, n_off, CAPACITY), False, False,
                                block_decode_work(n_off, CAPACITY, extended=False)),
        "block_decode_extended_fields": ((det_words_e, words_e, counts_e, n_off, capacity_ext), True, False,
                                         block_decode_work(n_off, capacity_ext, extended=True)),
        "block_decode_r2_fields": ((det_words_r, words_r, counts_r, n_off, CAPACITY), False, True,
                                   r2_work(n_off, CAPACITY, False, r2_dict)),
        "block_decode_extended_r2_fields": ((det_words_e, words_e, counts_e, n_off, capacity_ext), True, True,
                                            r2_work(n_off, capacity_ext, True, ext_dict)),
    }
    chains = {}
    for name, (args, extended, r2, work) in f_blocks.items():
        timed[name] = (
            lambda args=args, extended=extended, r2=r2: decode_block_bits(
                *args, extended=extended, recover2=r2, fields=True),
            lambda args=args, extended=extended, r2=r2: decode_block_bits_plain(
                *args, extended=extended, recover2=r2, fields=True),
            None, ("block_decode_kernel",), fields_in_block_work(work, args[4], extended))

        def chain(args=args, extended=extended, r2=r2):
            out = decode_block_bits(*args, extended=extended, recover2=r2)
            return block_fields(out["frames"], out["frames_raw"] if extended else None)

        chains[name] = chain
    rows = {}
    for name, (kernel, plain, library, names, work) in timed.items():
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
        l_ms = cuda_ms(library) if library else None
        dev_us = device_us(kernel, names)
        b_ms, b_by = bound(*work)
        rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "device_us": dev_us,
                      "bound_ms": b_ms, "bound_by": b_by}
        if library:
            rows[name]["library_device_us"] = device_us(library)
        if name in chains:  # the block decode without F, then the fields kernel
            rows[name]["chain_device_us"] = device_us(chains[name], ("block_decode_kernel", "fields_kernel"))
            rows[name]["chain_ms"] = cuda_ms(chains[name])
        print(f"{name}: kernel {k_ms:.4f} ms by events, {dev_us:.2f} us device; plain {p_ms:.4f} ms; "
              + (f"{lib_name} {l_ms:.4f} ms, {rows[name]['library_device_us']:.2f} us device; " if library else "")
              + (f"block decode + fields kernel {rows[name]['chain_ms']:.4f} ms by events, "
                 f"{rows[name]['chain_device_us']:.2f} us device; " if name in chains else "")
              + f"bound {b_ms * 1e3:.2f} us ({b_by}: {work[0]} bytes, {work[1]} operations)")

    def entry(name, source, replaces, err, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "path": None, "max_abs_err": err, **rows[name], **extra}

    entries = [
        entry("magdet_bits", "airjax_torch/csrc/front.cu", "airjax/kernels/magdet.py:250", bits_err["df17"]),
        entry("magdet_bits_preamble", "airjax_torch/csrc/front.cu", "airjax/dsp/demod.py:70", bits_err["preamble"]),
        entry("compact_bits", "airjax_torch/csrc/compact.cu", "airjax/dsp/demod.py:87", compact_err,
              library=lib_name, extended_path=rows["compact_bits_extended"]),
        entry("magdet_front", "airjax_torch/csrc/magdet.cu", "airjax/kernels/magdet.py:250", front_err["df17"]),
        entry("magdet_front_preamble", "airjax_torch/csrc/magdet.cu", "airjax/dsp/demod.py:70",
              front_err["preamble"]),
        entry("candidate_crc", "airjax_torch/csrc/candidate.cu", "airjax/dsp/demod.py:285", cand_err),
        entry("candidate_extended", "airjax_torch/csrc/candidate.cu", "airjax/pipeline.py:204", ext_err),
        entry("block_decode", "airjax_torch/csrc/block_decode.cu", "airjax/pipeline.py:83",
              max(block_err.values()), extended_path=rows["block_decode_extended"]),
        entry("block_decode_r2", "airjax_torch/csrc/block_decode.cu", "airjax/protocol/crc.py:159",
              r2_err["df17"]),
        entry("block_decode_extended_r2", "airjax_torch/csrc/block_decode.cu", "airjax/pipeline.py:210",
              r2_err["extended"]),
        entry("block_decode_fields", "airjax_torch/csrc/block_decode.cu", "airjax/protocol/fields.py:36",
              f_err[("df17", False)]),
        entry("block_decode_extended_fields", "airjax_torch/csrc/block_decode.cu",
              "airjax/protocol/shortframe.py:337", f_err[("extended", False)]),
        entry("block_decode_r2_fields", "airjax_torch/csrc/block_decode.cu", "airjax/protocol/fields.py:36",
              f_err[("df17", True)]),
        entry("block_decode_extended_r2_fields", "airjax_torch/csrc/block_decode.cu",
              "airjax/protocol/shortframe.py:337", f_err[("extended", True)]),
        entry("fields", "airjax_torch/csrc/fields.cu", "airjax/protocol/fields.py:36", fields_err["df17"]),
        entry("fields_extended", "airjax_torch/csrc/fields.cu", "airjax/protocol/shortframe.py:337",
              fields_err["extended"]),
    ]
    return entries, (planes_err, baseline_err), front_launches, chain_fields_launches


def r2_work(n_off: int, k: int, extended: bool, out: dict) -> tuple[int, int]:
    """block_decode_work plus recovered2 (1 B a slot), the 32 KB pair table
    read once, and the pair lookup this block's data needs: two hashes and
    8 key compares for each slot whose delta is nonzero and matched no
    single syndrome (counted from the mode's dict without R2; in the
    extended mode a single repair is seen only where it made a good_long,
    so a few more are counted)."""
    n_bytes, n_ops = block_decode_work(n_off, k, extended)
    n_slots = min(int(out["n_detections"]), k)
    ok = (out["icao_ap_long"] == 0) | out["recovered"] if extended else out["good"]
    searched = n_slots - int(ok[:n_slots].sum())
    return n_bytes + k + 32768, n_ops + 10 * searched


def candidate_work(k: int, extended: bool) -> tuple[int, int]:
    """Bytes of the candidate kernel (per slot the offset, 8 packed words,
    valid in mode extended; out the frame bytes and flags) and operations
    (a CRC step per bit, the 88 syndrome compares)."""
    if extended:
        return k * (4 + 32 + 1) + k * (14 + 14 + 4 + 4 + 4 + 6), k * (112 + 88)
    return k * (4 + 32) + k * (14 + 1 + 1), k * (112 + 88)


def phase_block(block_dev: torch.Tensor, frames: list[bytes], offsets: np.ndarray) -> None:
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16

    n_off = BLOCK - 240
    with counted() as launches:
        out = pipeline.to_host(pipeline.decode_iq_block(block_dev, n_off, CAPACITY))
    check(launches == ONE_PASS, f"the block did not run the front and block-decode kernels once each, and "
                                f"nothing else: {launches}")
    good = out["good"]
    check(not bool(out["overflow"]), "capacity overflow")
    check(int(out["n_good"]) == len(frames), f"n_good {int(out['n_good'])} != {len(frames)} embedded")
    check(out["offsets"][good].tolist() == offsets.tolist(), "offsets differ")
    check([bytes(r) for r in out["frames"][good]] == frames, "frame bytes differ")

    paths = {
        "kernel path": lambda: pipeline.decode_iq_block(block_dev, n_off, CAPACITY),
        "plain path": lambda: pipeline.decode_mags_block(magnitude_u16(block_dev), n_off, CAPACITY),
    }
    for name, fn in paths.items():
        ms = cuda_ms(fn, reps=15)
        print(f"block decode, {name}: {ms:.4f} ms median of 15 = "
              f"{BLOCK / ms / 1e3:.1f} MS/s, {len(frames) / ms * 1e3:.1f} msgs/s")
        profile_pass(name, fn, ms * 1e3, block_dev.shape[0], n_off, kernel_path=name == "kernel path")
    batched_pass("batched kernel path", lambda: pipeline.decode_iq_block_with_fields(block_dev, n_off, CAPACITY),
                 block_dev.shape[0], n_off, len(frames))


def batched_pass(name: str, fn, n_samples: int, n_off: int, n_frames: int) -> None:
    """One batched pass (a `_with_fields` decode): two launches, the front
    and the block decode with F, and no fields kernel; timed and profiled
    as a block pass."""
    with counted() as launches:
        fn()
        torch.cuda.synchronize()
    check(launches == BATCHED_PASS, f"{name}: not the front and the block decode with F alone: {launches}")
    ms = cuda_ms(fn, reps=15)
    print(f"block decode, {name}: {ms:.4f} ms median of 15 = {BLOCK / ms / 1e3:.1f} MS/s, "
          f"{n_frames / ms * 1e3:.1f} msgs/s; launches {json.dumps(launches)}")
    profile_pass(name, fn, ms * 1e3, n_samples, n_off, kernel_path=True)


@contextlib.contextmanager
def counted():
    """Every kernel wrapper's launch count set to 0 on entry; on exit the
    dict holds the launches made inside."""
    from airjax_torch.kernels import block_decode, candidate, compact, fields, magdet, shard_gather

    magdet.launches = magdet.bits_launches = magdet.count_launches = block_decode.launches = 0
    compact.launches = candidate.launches = 0
    fields.launches = block_decode.fields_launches = shard_gather.launches = shard_gather.fields_launches = 0
    got: dict[str, int] = {}
    yield got
    got.update(magdet_bits=magdet.bits_launches, block_decode=block_decode.launches,
               block_decode_fields=block_decode.fields_launches, compact_bits=compact.launches,
               candidate=candidate.launches, magdet_front=magdet.launches, fields=fields.launches,
               shard_gather=shard_gather.launches, shard_gather_fields=shard_gather.fields_launches,
               chunked_count=magdet.count_launches)


# A block decode's launches: the front and the block-decode kernel once each;
# a batched one's: the same, the block decode with F.
ONE_PASS = {"magdet_bits": 1, "block_decode": 1, "block_decode_fields": 0, "compact_bits": 0, "candidate": 0,
            "magdet_front": 0, "fields": 0, "shard_gather": 0, "shard_gather_fields": 0, "chunked_count": 0}
BATCHED_PASS = {**ONE_PASS, "block_decode_fields": 1}


def device_profile(fn, marker: str, passes: int = 10) -> tuple[dict[str, float], float, int, dict[str, float]]:
    """torch.profiler over `passes` calls of fn: device µs per pass by
    kernel name, the device's busy µs per pass (union of the device
    intervals), the passes it recorded: the count of the kernel named by
    `marker`, which fn launches once (the profiler can lose whole passes),
    and the launches per pass by kernel name; ({}, 0.0, 0, {}) if it
    recorded no device activity."""
    events = device_events(fn, passes)
    seen = sum(marker in e.name for e in events)
    if not seen:
        return {}, 0.0, 0, {}
    per_kernel: dict[str, float] = {}
    per_pass: dict[str, float] = {}
    for e in events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / seen
        per_pass[e.name] = per_pass.get(e.name, 0.0) + 1 / seen
    return per_kernel, busy_us(events) / seen, seen, per_pass


# The kernel once a pass by which the profiler's passes are counted: the
# block-decode kernel on the kernel path, the compaction kernel's scan on
# the staged chain, the plain compaction's searchsorted on the plain path.
KERNEL_MARKER = "block_decode_kernel"
STAGED_MARKER = "compact_scan_kernel"
PLAIN_MARKER = "searchsorted"
PASS_KERNELS = ("magdet_bits_kernel", "block_decode_kernel")  # a kernel-path pass, one launch each


def profile_pass(name: str, fn, pass_us: float, n_samples: int, n_off: int, kernel_path: bool,
                 kernels: tuple[str, ...] = None) -> None:
    """Where one block decode's device time goes: device time per kernel
    and the busy time per pass under torch.profiler, against the pass time
    that CUDA events measured just before without it. On the kernel path,
    also that the pass ran `kernels` (the front and block-decode kernels
    unless given) once each, at most one memset, and nothing else."""
    kernels = kernels or PASS_KERNELS
    for attempt in range(PROFILE_TRIES):
        per_kernel, busy, seen, per_pass = device_profile(fn, KERNEL_MARKER if kernel_path else PLAIN_MARKER)
        # The profiler can drop single kernel events of a window (a count a
        # pass below 1, never above): profile that window again.
        if not kernel_path or not any(0 < round(n, 6) < 1 for n in per_pass.values()):
            break
        counts = {k[:60]: round(n, 3) for k, n in per_pass.items()}
        print(f"profile, {name}: the profiler dropped events ({json.dumps(counts)}); again")
    if not per_kernel:
        print(f"profile, {name}: the profiler recorded no device activity (not measured)")
        return
    print(f"profile, {name}: {pass_us:.1f} us/pass by CUDA events, device busy "
          f"{busy:.1f} us/pass under the profiler ({seen} of 10 passes recorded), "
          f"idle share {1 - busy / pass_us:.3f}")
    for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us:9.2f} us/pass  {k[:100]}")
    if kernel_path:
        memsets = round(sum(n for k, n in per_pass.items() if "memset" in k.lower()), 6)
        other = [k for k in per_pass if "memset" not in k.lower() and not any(m in k for m in kernels)]
        once = all(round(sum(n for k, n in per_pass.items() if m in k), 6) == 1 for m in kernels)
        check(once and memsets <= 1 and not other,
              f"{name}: a pass should run {kernels} once each, at most one memset, and nothing else: "
              f"{json.dumps(per_pass)}")
        print(f"  kernels per pass: {json.dumps({k[:60]: round(n, 3) for k, n in per_pass.items()})}")
    from airjax_torch.dsp.demod import n_words

    for marker, moved in (("magdet_bits_kernel", bits_bytes(n_samples, n_off)),
                          ("magdet_kernel", n_off + 4 * n_words(n_samples))):
        front = [us for k, us in per_kernel.items() if marker in k]
        if front:
            moved += 4 * n_samples  # the IQ read
            print(f"  front kernel: {moved} bytes in {front[0]:.2f} us = {moved / front[0] / 1e3:.1f} GB/s")


def phase_block_ab(block_dev: torch.Tensor, ext_block_dev: torch.Tensor,
                   capacity_ext: int) -> dict[str, int]:
    """The block pass, the staged chain against the fused one, in turns
    (staged, fused, fused, staged) for the DF17 and the extended block:
    the front, compaction and candidate kernels and the dict's torch ops
    (decode_iq_block_staged) against the front and the block-decode kernel
    (decode_iq_block(_extended)). Per pass the CUDA-event time, the device
    busy time and the idle share. Returns the staged kernels' launches in
    it."""
    from airjax_torch import pipeline
    from airjax_torch.kernels import candidate as candidate_mod
    from airjax_torch.kernels import compact as compact_mod

    n_off = BLOCK - 240
    pairs = {
        "DF17": {"staged": lambda: pipeline.decode_iq_block_staged(block_dev, n_off, CAPACITY),
                 "fused": lambda: pipeline.decode_iq_block(block_dev, n_off, CAPACITY)},
        "extended": {"staged": lambda: pipeline.decode_iq_block_staged(ext_block_dev, n_off, capacity_ext,
                                                                       extended=True),
                     "fused": lambda: pipeline.decode_iq_block_extended(ext_block_dev, n_off, capacity_ext)},
    }
    for path, fns in pairs.items():
        staged, fused = pipeline.to_host(fns["staged"]()), pipeline.to_host(fns["fused"]())
        check(sorted(staged) == sorted(fused) and all(np.array_equal(staged[k], fused[k]) for k in staged),
              f"block A/B, {path}: the chains' dicts differ")
    launches = {}
    for path, fns in pairs.items():
        compact_mod.launches = candidate_mod.launches = 0
        runs: dict[str, list[tuple[float, float]]] = {"staged": [], "fused": []}
        for key in ("staged", "fused", "fused", "staged"):
            ms = cuda_ms(fns[key], reps=15)
            per_kernel, busy, seen, _ = device_profile(fns[key], STAGED_MARKER if key == "staged" else KERNEL_MARKER)
            runs[key].append((ms * 1e3, busy))
            print(f"block A/B, {path}, {key} chain: {ms * 1e3:.1f} us/pass by CUDA events, device busy "
                  f"{busy:.1f} us/pass ({seen} of 10 passes), idle share {1 - busy / (ms * 1e3):.3f}")
            if len(runs[key]) == 1:
                for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]:
                    print(f"  {us:9.2f} us/pass  {k[:100]}")
        means = {k: tuple(statistics.mean(x) for x in zip(*v)) for k, v in runs.items()}
        print(f"block A/B, {path}: staged chain {means['staged'][0]:.1f} us/pass, busy {means['staged'][1]:.1f} us "
              f"(idle {1 - means['staged'][1] / means['staged'][0]:.3f}); fused {means['fused'][0]:.1f} us/pass, "
              f"busy {means['fused'][1]:.1f} us (idle {1 - means['fused'][1] / means['fused'][0]:.3f})")
        launches["compact_bits"] = launches.get("compact_bits", 0) + compact_mod.launches
        launches["candidate_crc" if path == "DF17" else "candidate_extended"] = candidate_mod.launches
    return launches


def phase_planes_ab(block_dev: torch.Tensor) -> dict[str, dict]:
    """The planes A/B on the 2^24-sample block (airjax's
    tools/bench_stencil3.py, the path the planes forms serve), in turns:
    each form of csrc/planes.cu (PLANES), each first form it replaced
    (csrc/magdet.cu, BASELINES) and magdet_bits (csrc/front.cu: the same
    gate, bits out, the yardstick of what the planes' bytes cost). Two
    turns of CUDA-event medians (the list, then the list reversed), then
    two turns of profiler device time; the plain versions once. Every
    count is set to 0 just before the A/B. Returns per row: events ms and
    device µs (means of the turns), plain ms, launches in the A/B."""
    from airjax_torch.kernels import magdet as magdet_mod
    from airjax_torch.kernels import stencil3

    n_off = BLOCK - 240
    L = block_dev.shape[0]
    planes_bytes = front_work(L, n_off, "df17", n_off + L - 1)[0]
    # name: (call, kernel name for device_us, the wrapper's count, bytes moved)
    runs = {}
    for name, (form, gate) in PLANES.items():
        runs[name] = (lambda f=planes_fn(form, gate): f(block_dev, n_off), "planes_kernel",
                      lambda form=form: magdet_mod.planes_launches if form == "front" else stencil3.launches,
                      planes_bytes)
        runs[BASELINES[name]] = (
            lambda form=form, gate=gate: magdet_mod.magdet_planes_baseline(block_dev, n_off, form, gate),
            "magdet_kernel" if form == "front" else "magdet_stencil_kernel",
            lambda: magdet_mod.baseline_launches, planes_bytes)
    runs["magdet_bits"] = (lambda: magdet_mod.magdet_bits(block_dev, n_off), "magdet_bits_kernel",
                           lambda: magdet_mod.bits_launches, front_work(L, n_off, "df17", bits_bytes(L, n_off))[0])
    order = list(runs)
    ms: dict[str, list[float]] = {name: [] for name in order}
    device: dict[str, list[float]] = {name: [] for name in order}
    launches = dict.fromkeys(order, 0)
    magdet_mod.planes_launches = stencil3.launches = magdet_mod.baseline_launches = magdet_mod.bits_launches = 0
    for name in order + order[::-1]:
        fn, _, count, _ = runs[name]
        before, kinds = count(), planes_counts()
        ms[name].append(cuda_ms(fn))
        n = count() - before
        launches[name] += n
        moved = tuple(b - a for a, b in zip(kinds, planes_counts()))
        want = (0, 0) if name == "magdet_bits" else (n, 0) if name in PLANES else (0, n)
        check(n > 0 and moved == want, f"planes A/B {name}: {n} launches, {moved} (planes, first forms)")
    for name in order + order[::-1]:
        fn, kernel, count, _ = runs[name]
        before = count()
        device[name].append(device_us(fn, (kernel,)))
        launches[name] += count() - before
    plain = {}
    for name, (form, gate) in PLANES.items():
        plain[name] = plain[BASELINES[name]] = cuda_ms(lambda f=planes_plain(form, gate): f(block_dev, n_off))
    plain["magdet_bits"] = cuda_ms(lambda: magdet_mod.magdet_bits_plain(block_dev, n_off))
    print("planes A/B (2^24 samples, in turns; CUDA events ms, median of 20 a turn): " + ", ".join(
        f"{name} {statistics.mean(ms[name]):.4f} ({' / '.join(f'{t:.4f}' for t in ms[name])})" for name in order))
    print("planes A/B, device time (profiler, 10 calls a turn; GB/s of the bytes moved once; planes bound "
          f"{bound(planes_bytes, 0)[0] * 1e3:.2f} us): " + ", ".join(
              f"{name} {statistics.mean(device[name]):.2f} us ({' / '.join(f'{t:.2f}' for t in device[name])}; "
              f"{runs[name][3] / statistics.mean(device[name]) / 1e3:.1f} GB/s)" for name in order))
    print("planes A/B, plain versions: " + ", ".join(f"{name} {plain[name]:.4f} ms" for name in PLANES)
          + f", magdet_bits {plain['magdet_bits']:.4f} ms")
    return {name: {"ms": statistics.mean(ms[name]), "device_us": statistics.mean(device[name]),
                   "plain_ms": plain[name], "launches": launches[name]} for name in order}


def planes_rows(ab: dict[str, dict], planes_err: dict, baseline_err: dict, n_samples: int,
                n_off: int) -> list[dict]:
    """The kernel table's planes rows: csrc/planes.cu's forms, then the
    first forms (csrc/magdet.cu), each from the phase 5 A/B with its max
    abs error from phase 3."""
    replaces = {"front": "airjax/kernels/magdet.py:138", "tree32": "airjax/kernels/stencil3.py:148",
                "tree16": "airjax/kernels/stencil3.py:157", "flat16": "airjax/kernels/stencil3.py:169"}
    rows = []
    for first, source, errs, path in (
            (False, "airjax_torch/csrc/planes.cu", planes_err,
             "phase 5 planes A/B: magdet(packed=False) / magdet_tree on the 2^24 block; no decode path"),
            (True, "airjax_torch/csrc/magdet.cu", baseline_err,
             "phase 5 planes A/B: magdet_planes_baseline (the first forms) on the 2^24 block; no decode path")):
        for name, (form, gate) in PLANES.items():
            row = BASELINES[name] if first else name
            b_ms, b_by = bound(*front_work(n_samples, n_off, gate, n_off + n_samples - 1))
            rows.append({"name": row, "route": "cuda", "source": source,
                         "replaces": "airjax/dsp/demod.py:70" if gate == "preamble" else replaces[form],
                         "launches": ab[row]["launches"], "path": path, "max_abs_err": errs[name],
                         "ms": ab[row]["ms"], "plain_ms": ab[row]["plain_ms"], "library_ms": None,
                         "device_us": ab[row]["device_us"], "bound_ms": b_ms, "bound_by": b_by})
    return rows


def embedded_class(frame: bytes) -> str:
    """The extended dict's class of a frame sent clean."""
    from airjax_torch.protocol.crc import crc24

    df = frame[0] >> 3
    if df == 17:
        return "good_long"
    if df == 11:
        return "good_df11" if crc24(frame[:4]) == int.from_bytes(frame[4:7], "big") else "cand_df11_ic"
    return "cand_short_ap" if df in (0, 4, 5) else "cand_long_ap"


def ext_capacity(iq_dev: torch.Tensor, n_off: int) -> int:
    """The preamble-only gate's detection count on this block by the plain
    path, rounded up to a multiple of 1024: the capacity that holds it."""
    from airjax_torch.dsp.demod import detect_preamble_only
    from airjax_torch.dsp.magnitude import magnitude_u16

    n_det = int(detect_preamble_only(magnitude_u16(iq_dev), n_off).sum())
    return -(-n_det // 1024) * 1024


def phase_extended_block(block_dev: torch.Tensor, capacity: int, frames: list[bytes],
                         offsets: np.ndarray) -> None:
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16
    from airjax_torch.extended import assemble_extended
    from airjax_torch.track.icao_cache import IcaoCache

    n_off = BLOCK - 240
    with counted() as launches:
        out = pipeline.to_host(pipeline.decode_iq_block_extended(block_dev, n_off, capacity))
    check(launches == ONE_PASS, f"the extended block did not run the front and block-decode kernels once each: "
                                f"{launches}")
    check(not bool(out["overflow"]), "extended capacity overflow")
    plain = pipeline.to_host(pipeline.decode_mags_block_extended(magnitude_u16(block_dev), n_off, capacity))
    check(sorted(plain) == sorted(out), "extended dict keys differ")
    for key in plain:
        check(plain[key].dtype == out[key].dtype and np.array_equal(plain[key], out[key]),
              f"extended dict differs from the plain path at {key}")
    at = {int(o): k for k, o in enumerate(out["offsets"]) if out["valid"][k]}
    for frame, off in zip(frames, offsets):
        k = at.get(int(off))
        check(k is not None and bool(out[embedded_class(frame)][k]), f"frame at {off} not in its class")
        raw = out["frames" if frame[0] >> 3 == 17 else "frames_raw"][k].tobytes()
        check(raw[: len(frame)] == frame, f"frame at {off}: bytes differ")
    packets = assemble_extended(out, time.time(), IcaoCache())
    emitted = {o for o, _ in packets}
    check(all(int(o) in emitted for o in offsets), "an embedded frame emitted no packet")
    kinds = {}
    for _, p in packets:
        kinds[type(p).__name__] = kinds.get(type(p).__name__, 0) + 1
    print(f"extended block: {len(frames)} frames in their classes, {int(out['n_detections'])} detections "
          f"(capacity {capacity}), dict == plain path; packets {json.dumps(kinds)}")

    paths = {
        "extended kernel path": lambda: pipeline.decode_iq_block_extended(block_dev, n_off, capacity),
        "extended plain path": lambda: pipeline.decode_mags_block_extended(
            magnitude_u16(block_dev), n_off, capacity),
    }
    for name, fn in paths.items():
        ms = cuda_ms(fn, reps=15)
        print(f"block decode, {name}: {ms:.4f} ms median of 15 = "
              f"{BLOCK / ms / 1e3:.1f} MS/s, {len(frames) / ms * 1e3:.1f} msgs/s")
        profile_pass(name, fn, ms * 1e3, block_dev.shape[0], n_off, kernel_path=name == "extended kernel path")
    batched_pass("extended batched kernel path",
                 lambda: pipeline.decode_iq_block_extended_with_fields(block_dev, n_off, capacity),
                 block_dev.shape[0], n_off, len(frames))


def plain_extended_packets(iq: np.ndarray, dev: torch.device, now: float):
    """The whole capture's extended packets through the plain torch path on
    the card and one ICAO cache (overlap-save slices of 2^22 offsets,
    independent of the CLI's 20k blocks): [(global offset, packet)]."""
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16
    from airjax_torch.extended import assemble_extended
    from airjax_torch.track.icao_cache import IcaoCache

    scan = 1 << 22
    cache = IcaoCache()
    packets = []
    for start in range(0, len(iq) - 239, scan):
        sl = torch.as_tensor(iq[start : start + scan + 239]).to(dev)
        n_off = min(scan, sl.shape[0] - 239)
        out = pipeline.to_host(pipeline.decode_mags_block_extended(
            magnitude_u16(sl), n_off, ext_capacity(sl, n_off)))
        packets += [(start + o, p) for o, p in assemble_extended(out, now, cache)]
    return packets


def masked(text: str) -> list[str]:
    """Printed packets without their wall-clock lines."""
    return [ln for ln in text.splitlines() if not ln.startswith("Processed Time  : ")]


def phase_extended_stream(dev: torch.device) -> dict[str, int]:
    from airjax_torch.io.c16 import save_c16
    from airjax_torch.ui.stream import stream_printer

    iq, offsets, frames, flipped = mixed_capture(200, EXT_STREAM_SAMPLES + 10_000, EXT_STREAM_SAMPLES, 40, flips=12)
    straddle = sum(1 for o in offsets if o % CHUNK > CHUNK - 240)
    print(f"extended stream: {len(frames)} frames of every format, {straddle} straddling chunk edges, "
          f"{len(flipped)} DF17s corrupted")
    # Playback drops its tail: only the first EXT_STREAM_SAMPLES are replayed.
    plain = plain_extended_packets(iq[:EXT_STREAM_SAMPLES], dev, time.time())
    check([o for o, _ in plain] == offsets.tolist(), "plain extended packets differ from the embedded offsets")
    want = io.StringIO()
    sink = stream_printer(want)
    for _, packet in plain:
        sink(packet)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mixed.c16")
        save_c16(iq, path)
        with counted() as n:
            text, stats, wall = run_cli(["adsb", "--playback", path, "--fast", "--extended"])
    check(min(n["magdet_bits"], n["block_decode"]) > 0
          and n["compact_bits"] == n["candidate"] == n["magdet_front"] == n["fields"] == 0,
          f"the extended stream did not run the front and block-decode kernels alone: {n}")
    launches = {"magdet_bits_preamble": n["magdet_bits"], "block_decode": n["block_decode"]}
    check(masked(text[: text.rindex("\nstats: ")]) == masked(want.getvalue()),
          "extended stream text differs from the plain path's assembly")
    check(stats["recovered"] == len(flipped), f"recovered {stats['recovered']} != {len(flipped)}")
    check(stats["good"] == len(frames) and stats["overflow_blocks"] == 0, f"stats {stats}")
    print(f"extended stream: {stats['good']} packets == the plain path's text; {wall:.2f} s wall, "
          f"stats {json.dumps({k: v for k, v in stats.items() if k != 'stages'})}")
    print(f"extended stream stages: {json.dumps(stats['stages'])}")
    return launches


def plain_stream_hits(iq: np.ndarray, dev: torch.device) -> list[tuple[int, bytes]]:
    """The whole-capture hit list through the plain torch path on the card
    (overlap-save slices of 2^22 offsets, independent of the CLI's 20k blocks)."""
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16

    scan = 1 << 22
    hits = []
    n = len(iq)
    for start in range(0, n - 239, scan):
        sl = torch.as_tensor(iq[start : start + scan + 239]).to(dev)
        n_off = min(scan, sl.shape[0] - 239)
        out = pipeline.to_host(pipeline.decode_mags_block(magnitude_u16(sl), n_off, 4096))
        check(not bool(out["overflow"]), "plain stream capacity overflow")
        for k in np.nonzero(out["good"])[0]:
            hits.append((start + int(out["offsets"][k]), out["frames"][k].tobytes()))
    return hits


def cli_out(argv: list[str]) -> tuple[str, float]:
    """The CLI's standard output and its wall time; it must exit 0."""
    from airjax_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} returned {rc}")
    return buf.getvalue(), wall


def run_cli(argv: list[str]) -> tuple[str, dict, float]:
    """The CLI's standard output, its final stats and its wall time."""
    text, wall = cli_out(argv)
    stats = ast.literal_eval([ln for ln in text.splitlines() if ln.startswith("stats: ")][-1][len("stats: "):])
    return text, stats, wall


def hexes(text: str) -> list[str]:
    """The `== <hex> ==` first lines of the printed DF17 packets."""
    return [ln[3:-3] for ln in text.splitlines() if ln.startswith("== ") and ln.endswith(" ==")]


def phase_stream(dev: torch.device) -> dict[str, int]:
    from airjax_torch.io import synth
    from airjax_torch.io.c16 import save_c16

    rng = np.random.default_rng(20)
    n_chunks = STREAM_SAMPLES // CHUNK
    last = STREAM_SAMPLES - 10_000
    straddle = {c * CHUNK - 120 for c in rng.choice(np.arange(1, n_chunks - 1), n_chunks // 10, replace=False)}
    inside = set(rng.choice(np.arange(0, last // 300), n_chunks * 52 // 100, replace=False) * 300)
    inside = {o for o in inside if all(abs(o - s) >= 300 for s in straddle)}
    offsets = sorted(int(o) for o in straddle | inside)
    frames = make_frames(len(offsets), 21)
    corrupt = set(rng.choice(len(offsets), 12, replace=False).tolist())
    # Data bits 5..87: a flip in the DF field (bits 0-4) fails the DF17 gate,
    # so such a frame is never a candidate at all.
    sent = [synth.flip_bit(f, int(rng.integers(5, 88))) if i in corrupt else f
            for i, f in enumerate(frames)]
    # 10,000 samples past 20 M: playback drops its tail, so the 1000 full
    # chunks are all replayed.
    iq = synth.modulate(sent, offsets, STREAM_SAMPLES + 10_000, seed=22)
    print(f"stream: {len(offsets)} frames, {len(straddle)} straddling chunk edges, "
          f"{len(corrupt)} corrupted")

    plain = plain_stream_hits(iq[:STREAM_SAMPLES], dev)
    check([g for g, _ in plain] == offsets, "plain path hits differ from the embedded offsets")
    check([f for _, f in plain] == frames, "plain path frames differ from the embedded frames")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.c16")
        save_c16(iq, path)
        with counted() as n, replayed() as g:
            text, stats, wall = run_cli(["adsb", "--playback", path, "--fast"])
        got = hexes(text)
        check(min(n["magdet_bits"], n["block_decode"]) > 0
              and n["compact_bits"] == n["candidate"] == n["magdet_front"] == n["fields"] == 0,
              f"the stream did not run the front and block-decode kernels alone: {n}")
        # One block shape: the first block eager, the others replays of its
        # graphs (pipeline.BlockGraphs), a front and a block decode counted each.
        check(n["magdet_bits"] == n["block_decode"] == n_chunks and g["eager"] == 1
              and g["replays"] == n_chunks - 1, f"the stream did not replay its graphs: launches {n}, graphs {g}")
        launches = {"magdet_bits": n["magdet_bits"], "block_decode": n["block_decode"]}
        check(got == [f.hex() for _, f in plain], "overlap stream differs from the plain path")
        check(stats["recovered"] == len(corrupt), f"recovered {stats['recovered']} != {len(corrupt)}")
        check(stats["blocks"] == n_chunks and stats["overflow_blocks"] == 0, f"stats {stats}")
        print(f"stream overlap: {len(got)} frames, each once, in order; {wall:.2f} s wall, "
              f"stats {json.dumps({k: v for k, v in stats.items() if k != 'stages'})}; graphs {json.dumps(g)}")
        print(f"stream stages: {json.dumps(stats['stages'])}")

        # The sharded runner on a one-card mesh: the same hit list.
        with counted() as n_sh:
            text_s, stats_s, wall_s = run_cli(["adsb", "--playback", path, "--fast", "--devices", "1"])
        check(hexes(text_s) == got and stats_s["good"] == stats["good"] and stats_s["recovered"] == len(corrupt),
              f"adsb --devices 1 differs from overlap mode: stats {stats_s}")
        check(n_sh["shard_gather"] > 0 and n_sh["magdet_bits"] == n_sh["block_decode"] == n_sh["shard_gather"]
              and n_sh["compact_bits"] == n_sh["candidate"] == n_sh["fields"] == 0,
              f"adsb --devices 1: not a front, a block decode and a shard gather a step: {n_sh}")
        launches["shard_gather"] = n_sh["shard_gather"]
        print(f"stream --devices 1: {len(hexes(text_s))} frames == overlap mode; {STREAM_SAMPLES / wall_s / 1e6:.2f} "
              f"MS/s ({wall_s:.2f} s wall); launches {json.dumps(n_sh)}; "
              f"stats {json.dumps({k: v for k, v in stats_s.items() if k != 'stages'})}")

        text_p, _, wall_p = run_cli(["adsb", "--playback", path, "--fast", "--no-overlap"])
        hexes_p = hexes(text_p)
        want = [f.hex() for g, f in plain if g % CHUNK < CHUNK - 240]
        check(hexes_p == want, "no-overlap stream differs from the plain path's chunk filter")
        lost = len(got) - len(hexes_p)
        check(lost >= len(straddle), f"no-overlap lost {lost} < {len(straddle)} straddlers")
        print(f"stream no-overlap: {len(hexes_p)} frames ({lost} lost at chunk edges); {wall_p:.2f} s wall")
    return launches, (iq, frames)


R2_FLIPS = 256  # DF17 frames of the recover2 block sent with a 2-bit flip


def flip_two(frame: bytes, rng) -> bytes:
    """Two distinct data bits flipped past the DF field (bits 5-87): a flip
    in bits 0-4 fails the DF17 gate, so such a frame is never a candidate."""
    from airjax_torch.io import synth

    for b in rng.choice(np.arange(5, 88), 2, replace=False):
        frame = synth.flip_bit(frame, int(b))
    return frame


def recover2_block(seed: int) -> tuple[np.ndarray, list[bytes], np.ndarray, list[int]]:
    """2^24 + 1024 samples, 1024 DF17 frames at multiples of 300, R2_FLIPS
    of them sent with a 2-bit flip, each from an aircraft that also sends a
    clean frame in the block (so that the extended assembly's gate accepts
    its repair) -> (iq, frames as made, offsets, flipped indices)."""
    from airjax_torch.io import synth

    rng = np.random.default_rng(seed)
    offsets = np.sort(rng.choice(np.arange(0, (BLOCK - 240) // 300) * 300, size=1024, replace=False))
    frames = make_frames(len(offsets), seed)
    flipped = sorted(rng.choice(len(frames), R2_FLIPS, replace=False).tolist())
    clean = sorted(set(range(len(frames))) - set(flipped))
    for n, i in enumerate(flipped):
        frames[i] = synth.make_df17(int.from_bytes(frames[clean[n]][1:4], "big"), frames[i][4:11])
    sent = list(frames)
    for i in flipped:
        sent[i] = flip_two(frames[i], rng)
    iq = synth.modulate(sent, list(map(int, offsets)), BLOCK + HALO, noise_std=60.0, seed=seed)
    return iq, frames, offsets, flipped


def phase_recover2_block(block_dev: torch.Tensor, frames: list[bytes], offsets: np.ndarray,
                         flipped: list[int]) -> None:
    """decode_iq_block_r2 decodes all 1024 frames (R2_FLIPS of them by the
    pair repair, back to the frames as made), decode_iq_block the clean
    ones, decode_iq_block_extended(recover2=True) puts all in good_long;
    each a pass of the front and the block-decode kernel; then timed and
    profiled as phase 4."""
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16

    n_off = BLOCK - 240
    flip_offsets = set(offsets[flipped].tolist())
    with counted() as launches:
        out = pipeline.to_host(pipeline.decode_iq_block_r2(block_dev, n_off, CAPACITY))
    check(launches == ONE_PASS, f"the recover2 block did not run the front and block-decode kernels once each: "
                                f"{launches}")
    good = out["good"]
    check(not bool(out["overflow"]) and int(out["n_good"]) == len(frames),
          f"decode_iq_block_r2: n_good {int(out['n_good'])} != {len(frames)}")
    check(out["offsets"][good].tolist() == offsets.tolist(), "recover2 offsets differ")
    check([bytes(r) for r in out["frames"][good]] == frames, "recover2 frames differ from the frames as made")
    check(set(out["offsets"][out["recovered2"]].tolist()) == flip_offsets, "recovered2 marks other slots")
    plain = pipeline.to_host(pipeline.decode_mags_block(magnitude_u16(block_dev), n_off, CAPACITY, recover2=True))
    check(all(np.array_equal(plain[k], out[k]) for k in plain), "decode_iq_block_r2 differs from the plain path")
    base = pipeline.to_host(pipeline.decode_iq_block(block_dev, n_off, CAPACITY))
    check(int(base["n_good"]) == len(frames) - R2_FLIPS
          and set(base["offsets"][base["good"]].tolist()) == set(offsets.tolist()) - flip_offsets,
          "decode_iq_block: not exactly the clean frames")
    cap = ext_capacity(block_dev, n_off)
    with counted() as launches:
        ext = pipeline.to_host(pipeline.decode_iq_block_extended(block_dev, n_off, cap, recover2=True))
    check(launches == ONE_PASS, f"the extended recover2 block: {launches}")
    # The embedded frames: all in good_long, repaired, recovered2 exactly
    # where flipped. The preamble-only gate also passes ~20k offsets of
    # noise and frame edges; a few of those deltas are pair syndromes of a
    # DF >= 16 frame (airjax's reason to gate recovered2): they must all be
    # recovered2, and the assembly must emit none of them.
    at = {int(o): k for k, o in enumerate(ext["offsets"]) if ext["valid"][k]}
    ks = [at.get(int(o)) for o in offsets]
    check(None not in ks and all(bool(ext["good_long"][k]) for k in ks)
          and [bytes(ext["frames"][k]) for k in ks] == frames
          and {int(ext["offsets"][k]) for k in ks if ext["recovered2"][k]} == flip_offsets,
          "extended recover2: the embedded frames are not all in good_long, repaired, recovered2 where flipped")
    aliases = sorted(set(np.nonzero(ext["good_long"])[0].tolist()) - set(ks))
    check(not bool(ext["overflow"]) and all(bool(ext["recovered2"][k]) for k in aliases),
          "extended recover2: a good_long slot off the embedded frames validated without the pair repair")
    from airjax_torch.extended import assemble_extended
    from airjax_torch.track.icao_cache import IcaoCache

    emitted = {o for o, _ in assemble_extended(ext, time.time(), IcaoCache())}
    check(not emitted & {int(ext["offsets"][k]) for k in aliases} and emitted == set(offsets.tolist()),
          "extended recover2: the assembly's gate let an alias through, or dropped an embedded frame")
    print(f"recover2 block: decode_iq_block_r2 {int(out['n_good'])}/{len(frames)} frames "
          f"({int(out['recovered2'].sum())} recovered2, {int(out['recovered'].sum())} recovered), == plain path; "
          f"decode_iq_block {int(base['n_good'])}; extended recover2: the {len(frames)} frames in good_long "
          f"({len(flip_offsets)} recovered2), {len(aliases)} more 2-flip repairs of noise detections, all gated "
          f"off by the assembly (capacity {cap}); one front and one block-decode launch each")
    paths = {
        "recover2 kernel path": lambda: pipeline.decode_iq_block_r2(block_dev, n_off, CAPACITY),
        "recover2 plain path": lambda: pipeline.decode_mags_block(magnitude_u16(block_dev), n_off, CAPACITY,
                                                                  recover2=True),
        "extended recover2 kernel path": lambda: pipeline.decode_iq_block_extended(block_dev, n_off, cap,
                                                                                  recover2=True),
    }
    for name, fn in paths.items():
        ms = cuda_ms(fn, reps=15)
        print(f"block decode, {name}: {ms:.4f} ms median of 15 = "
              f"{BLOCK / ms / 1e3:.1f} MS/s, {len(frames) / ms * 1e3:.1f} msgs/s")
        profile_pass(name, fn, ms * 1e3, block_dev.shape[0], n_off, kernel_path="kernel" in name)
    batched_pass("recover2 batched kernel path",
                 lambda: pipeline.decode_iq_block_with_fields(block_dev, n_off, CAPACITY, recover2=True),
                 block_dev.shape[0], n_off, len(frames))
    batched_pass("extended recover2 batched kernel path",
                 lambda: pipeline.decode_iq_block_extended_with_fields(block_dev, n_off, cap, recover2=True),
                 block_dev.shape[0], n_off, len(frames))


# The tracker stream: 300 aircraft over 30 s at 2 MS/s.
TRACK_AIRCRAFT = 300
TRACK_SECONDS = 30
TRACK_SAMPLES = TRACK_SECONDS * 2_000_000
TRACK_GRID = 300  # frames start on this grid, so no two overlap


def tracker_traffic(seed: int):
    """What a receiver hears from TRACK_AIRCRAFT aircraft in level flight
    over TRACK_SECONDS: each sends even/odd airborne positions at 2/s, a
    velocity at 1/s and its ID every 5 s (DF17), and answers with DF11
    all-calls at 1/s, DF4 altitudes every 2 s, DF5 identities and DF20
    Comm-B callsigns every 5 s. 1% of the DF17s carry a 1-bit and 1% a
    2-bit flip in bits 5-87 (never an aircraft's last position, which is
    an even frame). Each
    frame starts at the first free grid slot at or after its time.
    -> (iq, truth per ICAO, the DF17s in stream order as (icao, flips))."""
    from airjax_torch.io import synth
    from airjax_torch.protocol import shortframe

    rng = np.random.default_rng(seed)
    icaos = rng.choice(np.arange(1, 1 << 24), TRACK_AIRCRAFT, replace=False).tolist()
    events = []  # (time s, icao, kind, frame)
    truth = {}
    for n, icao in enumerate(icaos):
        lat0, lon0 = float(rng.uniform(50.0, 54.0)), float(rng.uniform(2.0, 7.0))
        speed, heading = float(rng.uniform(200.0, 250.0)), float(rng.uniform(0.0, 2 * np.pi))
        vn, ve = speed * np.cos(heading), speed * np.sin(heading)  # m/s
        alt = 25 * int(rng.integers(400, 1520))
        squawk = int("".join(str(d) for d in rng.integers(0, 8, 4)))
        callsign = f"TRK{n:04d}"
        truth[icao] = {"callsign": callsign.ljust(8, "_"), "altitude": alt, "squawk": squawk,
                       "pos": lambda t, lat0=lat0, lon0=lon0, vn=vn, ve=ve: (
                           lat0 + vn * t / 111_320.0, lon0 + ve * t / (111_320.0 * np.cos(np.radians(lat0))))}
        kt = 1.0 / 0.514444  # knots per m/s
        phase = rng.uniform(0.0, 1.0, 7)
        times = np.arange(phase[0] * 0.5, TRACK_SECONDS - 0.01, 0.5)
        for k, t in enumerate(times):
            lat, lon = truth[icao]["pos"](t)
            # Even and odd in turn, the last one even: with an odd frame
            # newest the reference's decode takes NL(lat - 1 degree) for the
            # longitude zones (airjax/track/cpr.py:95-99), off the truth.
            odd = bool((len(times) - 1 - k) % 2)
            me = synth.make_position_me(11, alt, *synth.encode_airborne_cpr(lat, lon, odd), odd)
            events.append((t, icao, "position", synth.make_df17(icao, me)))
        # The other messages do not change in level flight: one frame each.
        for kind, start, period, frame in (
            ("velocity", phase[1], 1.0, synth.make_df17(icao, synth.make_velocity_me(round(ve * kt), round(vn * kt), 0))),
            ("id", phase[2] * 5.0, 5.0, synth.make_df17(icao, synth.make_id_me(callsign))),
            ("df11", phase[3], 1.0, shortframe.make_df11(icao)),
            ("df4", phase[4] * 2.0, 2.0, shortframe.make_df4(icao, alt)),
            ("df5", phase[5] * 5.0, 5.0, shortframe.make_df5(icao, squawk)),
            ("df20", phase[6] * 5.0, 5.0, shortframe.make_df20(icao, alt, mb=synth.make_id_me(callsign))),
        ):
            events += [(t, icao, kind, frame) for t in np.arange(start, TRACK_SECONDS - 0.01, period)]
    events.sort(key=lambda e: e[0])
    n_slots = (TRACK_SAMPLES - 240) // TRACK_GRID
    used = np.zeros(n_slots + 1, bool)
    placed = []  # (offset, icao, kind, frame, time)
    for t, icao, kind, frame in events:
        slot = min(int(np.ceil(t * 2e6 / TRACK_GRID)), n_slots - 1)
        while used[slot]:
            slot += 1
        check(slot < n_slots, "tracker traffic does not fit its grid")
        used[slot] = True
        placed.append((slot * TRACK_GRID, icao, kind, frame, t))
    placed.sort(key=lambda e: e[0])
    last_pos = {}
    for i, (_, icao, kind, _, _) in enumerate(placed):
        if kind == "position":
            last_pos[icao] = i
    keep_clean = set(last_pos.values())
    df17 = [i for i, e in enumerate(placed) if e[3][0] >> 3 == 17 and i not in keep_clean]
    corrupt = rng.choice(df17, 2 * (len(df17) // 100), replace=False)
    flips = dict.fromkeys(corrupt[: len(corrupt) // 2].tolist(), 1) | dict.fromkeys(corrupt[len(corrupt) // 2 :].tolist(), 2)
    sent = []
    for i, (_, _, _, frame, _) in enumerate(placed):
        if flips.get(i) == 1:
            frame = synth.flip_bit(frame, int(rng.integers(5, 88)))
        elif flips.get(i) == 2:
            frame = flip_two(frame, rng)
        sent.append(frame)
    iq = synth.modulate(sent, [e[0] for e in placed], TRACK_SAMPLES, noise_std=60.0, seed=seed)
    for icao, i in last_pos.items():
        truth[icao]["last_position_t"] = placed[i][4]
    stream = [(e[1], flips.get(i, 0)) for i, e in enumerate(placed) if e[3][0] >> 3 == 17]
    return iq, truth, stream, len(placed)


def table_view(aircrafts: dict, extended: bool) -> dict:
    """A tracker's table as its summaries (lastContact is wall clock)."""
    out = {}
    for icao, a in aircrafts.items():
        summary = a.get_summary().to_json(extended=extended)
        summary.pop("lastContact")
        out[icao] = summary
    return out


def same_table(a: dict, b: dict) -> bool:
    """Equal summaries; floats to 1e-9 (numpy's vectorized hypot and CPR
    against the scalar math of the per-packet path, as airjax's tests)."""
    def same(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return abs(x - y) <= 1e-9
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list) and isinstance(y, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return x == y

    return same(a, b)


def phase_tracker_stream(dev: torch.device) -> dict[str, int]:
    """The tracker path on the card: run_stream over the tracker traffic in
    20,000-sample blocks into (1) a per-packet handle_aircraft_update table
    with --recover2, (2) BatchTracker with --recover2 and (3) without, (4) a
    per-packet extended table and (5) ExtendedBatchTracker, both with
    --recover2, (6) WebDisplay's batched sink in-process, read back through
    GET /api/aircraft, (7) ExtendedBatchTracker without --recover2. The
    batched tables equal the per-packet ones, every aircraft has its
    callsign, altitude and a position within CPR resolution of the truth,
    recovered2 counts the gated 2-flip frames (0 on the extended batched
    sink, as in airjax), and each batched pass launched the block decode
    with F once and the fields kernel never. Returns the launches of the
    kernels line and the traffic's IQ."""
    import urllib.request

    from airjax_torch.extended import handle_extended_update
    from airjax_torch.runner import run_stream
    from airjax_torch.track.aircraft import handle_aircraft_update
    from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker
    from airjax_torch.ui.web import WebDisplay

    t0 = time.perf_counter()
    iq, truth, stream, n_frames = tracker_traffic(50)
    n_df17 = len(stream)
    n_two = sum(1 for _, f in stream if f == 2)
    seen, gated = set(), 0  # the DF17 recover2 gate, in stream order
    for icao, f in stream:
        if f == 2:
            gated += icao in seen
        else:
            seen.add(icao)
    print(f"tracker stream: {TRACK_AIRCRAFT} aircraft, {TRACK_SECONDS} s, {TRACK_SAMPLES} samples, {n_frames} frames "
          f"({n_df17} DF17, {sum(1 for _, f in stream if f == 1)} with a 1-bit and {n_two} with a 2-bit flip; "
          f"{gated} 2-flips of an aircraft seen before); made in {time.perf_counter() - t0:.2f} s")

    def blocks():
        return (iq[i : i + CHUNK] for i in range(0, TRACK_SAMPLES, CHUNK))

    def run(name, sink, extended, recover2):
        with counted() as n, replayed() as g:
            t = time.perf_counter()
            stats = run_stream(blocks(), sink, extended=extended, recover2=recover2, device=dev).as_dict()
            wall = time.perf_counter() - t
        check(n["magdet_bits"] == n["block_decode"] > 0 and n["compact_bits"] == n["candidate"] == 0,
              f"{name}: not a front and a block-decode launch a pass: {n}")
        check(g["eager"] == 1 and g["eager"] + g["replays"] == stats["blocks"],
              f"{name}: not one eager block and replays of its graphs: launches {n}, graphs {g}")
        print(f"tracker stream, {name}: {TRACK_SAMPLES / wall / 1e6:.3f} MS/s, {stats['good'] / wall:.1f} msgs/s "
              f"({wall:.2f} s wall); stats {json.dumps({k: v for k, v in stats.items() if k != 'stages'})}; "
              f"launches {json.dumps(n)}; graphs {json.dumps(g)}")
        print(f"  stages: {json.dumps(stats['stages'])}")
        return stats, n

    per: dict = {}
    s1, n1 = run("per-packet table, --recover2", lambda p: handle_aircraft_update(p, per), False, True)
    bt2 = BatchTracker()
    s2, n2 = run("BatchTracker, --recover2", bt2, False, True)
    bt0 = BatchTracker()
    s3, n3 = run("BatchTracker", bt0, False, False)
    per_ext: dict = {}
    s4, n4 = run("per-packet extended table, --recover2", lambda p: handle_extended_update(p, per_ext), True, True)
    ebt = ExtendedBatchTracker()
    s5, n5 = run("ExtendedBatchTracker, --recover2", ebt, True, True)
    display = WebDisplay(port=0, quiet=True)
    server = display.start_background()
    for _ in range(200):
        if display._httpd is not None:
            break
        server.join(0.05)
    check(display._httpd is not None, "the web server did not start")
    try:
        s6, n6 = run("WebDisplay batched sink, --recover2", display.batched_sink(), False, True)
        port = display._httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/aircraft", timeout=30) as r:
            snapshot = json.load(r)
    finally:
        display.shutdown()
        server.join(30)
    check(not server.is_alive(), "the web server did not shut down")
    ebt0 = ExtendedBatchTracker()
    _, n7 = run("ExtendedBatchTracker", ebt0, True, False)

    for name, n in (("per-packet", n1), ("per-packet extended", n4)):
        check(n["fields"] == n["block_decode_fields"] == 0, f"{name}: the fields ran: {n}")
    for name, n in (("BatchTracker --recover2", n2), ("BatchTracker", n3), ("ExtendedBatchTracker --recover2", n5),
                    ("WebDisplay", n6), ("ExtendedBatchTracker", n7)):
        check(n["block_decode_fields"] == n["block_decode"] and n["fields"] == 0,
              f"{name}: not one block decode with F a pass and no fields kernel: {n}")
    check(s1["recovered2"] == s2["recovered2"] == s6["recovered2"] == gated,
          f"recovered2 {s1['recovered2']}, {s2['recovered2']}, {s6['recovered2']} != {gated} gated 2-flips")
    check(s1["good"] == s2["good"] == n_df17 - n_two + gated and s3["good"] == n_df17 - n_two
          and s3["recovered2"] == 0, f"good {s1['good']}, {s2['good']}, {s3['good']} of {n_df17} DF17s")
    check(s5["recovered2"] == 0 and 0 < s4["recovered2"] <= n_two,
          f"extended recovered2: per-packet {s4['recovered2']}, batched {s5['recovered2']} (airjax's quirk: 0)")
    table = table_view(per, False)
    check(same_table(table_view(bt2.aircrafts, False), table), "BatchTracker --recover2 != the per-packet table")
    check(same_table(table_view(ebt.aircrafts, True), table_view(per_ext, True)),
          "ExtendedBatchTracker != the per-packet extended table")
    web = {a["icao"]: {k: v for k, v in a.items() if k != "lastContact"} for a in snapshot}
    check(same_table(web, table), "GET /api/aircraft != the per-packet table")
    for name, tab in (("per-packet", per), ("BatchTracker", bt0.aircrafts), ("extended", per_ext),
                      ("ExtendedBatchTracker", ebt0.aircrafts)):
        check(set(tab) == set(truth), f"{name}: {len(tab)} aircraft, not the {len(truth)} sent")
        worst = 0.0
        for icao, a in tab.items():
            want = truth[icao]
            check(a.callsign == want["callsign"] and a.altitude == want["altitude"],
                  f"{name} {icao:06x}: callsign {a.callsign!r}, altitude {a.altitude}")
            lat, lon = want["pos"](want["last_position_t"])
            g = a.geo_position
            check(g is not None, f"{name} {icao:06x}: no position")
            # CPR resolution: a 17-bit fraction of a 6-degree latitude zone,
            # of a 360/NL-degree longitude zone (NL >= 30 below 54 degrees).
            err = max(abs(g.latitude - lat) / (6.0 / 131072), abs(g.longitude - lon) / (12.0 / 131072))
            check(err <= 1.0, f"{name} {icao:06x}: position {g} vs truth ({lat:.6f}, {lon:.6f})")
            worst = max(worst, err)
        print(f"  {name}: {len(tab)} aircraft with their callsign and altitude, positions within "
              f"{worst:.3f} CPR cells of the truth")
    check(all(per_ext[ic].squawk == truth[ic]["squawk"] for ic in truth), "extended: a squawk differs")
    print(f"tracker stream: the batched tables == the per-packet tables ({len(table)} aircraft), "
          f"GET /api/aircraft == the per-packet table, recovered2 {gated} == the gated 2-flips")
    return {"block_decode_r2": n1["block_decode"], "block_decode_extended_r2": n4["block_decode"],
            "block_decode_fields": n3["block_decode_fields"], "block_decode_r2_fields": n2["block_decode_fields"],
            "block_decode_extended_fields": n7["block_decode_fields"],
            "block_decode_extended_r2_fields": n5["block_decode_fields"]}, iq


# Phase 11: the sharded decode over a mesh, the analyses, the channels.
SHARD_SAMPLES = 1 << 26  # 33.6 s at 2 MS/s, 256 MB of IQ
SHARDS = 4  # shards of the mesh on the one card: 2^24 samples each
SHARD_FRAMES = 4096
ANALYTICS_SAMPLES = 1 << 25  # the first 16.8 s of the tracker traffic: one block of <= 2^25 offsets
N_CHANNELS, CHANNEL_SAMPLES, CHANNEL_FRAMES = 8, 1 << 21, 128


def sharded_capture(seed: int):
    """SHARD_SAMPLES samples: SHARD_FRAMES DF17 frames at multiples of 300,
    one straddling each shard edge of the SHARDS-shard mesh (padded to
    tuned_block), one straddling each edge of the multi-process decode's
    SHARDS shards (not padded, so the rank boundaries of phase 12) and one
    whose window ends at the capture's end -> (iq, offsets, frames)."""
    from airjax_torch.io import synth
    from airjax_torch.parallel.halo import tuned_block

    rng = np.random.default_rng(seed)
    block = tuned_block(-(-SHARD_SAMPLES // SHARDS))
    unpadded = SHARD_SAMPLES // SHARDS
    special = np.array([i * b - 120 for b in (block, unpadded) for i in range(1, SHARDS)] + [SHARD_SAMPLES - 240])
    grid = np.arange(0, (SHARD_SAMPLES - 240) // 300) * 300
    grid = grid[np.abs(grid[:, None] - special[None]).min(axis=1) >= 300]
    offsets = np.sort(np.concatenate([rng.choice(grid, SHARD_FRAMES - len(special), replace=False), special]))
    frames = make_frames(len(offsets), seed)
    return synth.modulate(frames, list(map(int, offsets)), SHARD_SAMPLES, noise_std=60.0, seed=seed), offsets, frames


def gather_work(shards: list[dict], out: dict, extended: bool) -> tuple[int, int]:
    """Bytes and operations of one shard gather on these inputs: every
    slot's flags (valid, and good or the six classes), the offset of each
    slot those flags pass (its range test, and the output's offset), the
    other columns of the rows written (the classmask is computed, not read),
    the C rows and the scalars written; a compare and an add a flag or
    offset read, a copy a payload byte."""
    from airjax_torch.kernels.shard_gather import MASK_KEYS

    d, k, c = len(shards), shards[0]["offsets"].shape[0], out["offsets"].shape[0]
    total = min(int(out["n_candidates" if extended else "n_good"]), c)
    row = 4 + 14 + (1 + 14 + 12 if extended else 1) + (1 if "recovered2" in out else 0)
    payload = row - 4 - (1 if extended else 0)
    flags = 1 + (len(MASK_KEYS) if extended else 1)
    passed = 0
    for s in shards:
        sel = torch.stack([s[key] for key in MASK_KEYS]).any(0) if extended else s["good"]
        passed += int((s["valid"] & sel).sum())
    n_bytes = d * k * flags + 4 * passed + d * 5 + total * payload + c * row + 9
    return n_bytes, 2 * (d * k * flags + passed) + total * payload


def gather_fields_work(shards: list[dict], out: dict, extended: bool) -> tuple[int, int]:
    """gather_work plus flag F: the fields of the C rows written (105 B a
    row, 166 extended) and computed (fields_work's operations); the frames
    they come from are the bytes the gather copies, read once."""
    g_bytes, g_ops = gather_work(shards, out, extended)
    c = out["offsets"].shape[0]
    f_bytes, f_ops = fields_work(c, extended)
    return g_bytes + f_bytes - c * (21 if extended else 14), g_ops + f_ops


def flat(out: dict) -> dict:
    """A dict with its field dicts spread out ("fields.df", ...)."""
    got = {}
    for key, v in out.items():
        if isinstance(v, dict):
            got.update({f"{key}.{f}": t for f, t in v.items()})
        else:
            got[key] = v
    return got


def dict_err(got: dict, want: dict, what: str) -> int:
    """max_abs_err over two (flat) dicts with the same keys."""
    got, want = flat(got), flat(want)
    check(sorted(got) == sorted(want), f"{what}: the keys differ: {sorted(set(got) ^ set(want))}")
    return max_abs_err((got[key], want[key]) for key in want)


def gather_then_fields(args: tuple, **kw) -> dict:
    """The gather without F, then the fields kernel (csrc/fields.cu) over its
    C rows: the chain flag F replaces, its baseline and second oracle."""
    from airjax_torch.kernels.fields import block_fields
    from airjax_torch.kernels.shard_gather import shard_gather

    out = shard_gather(*args, **kw)
    out["fields"], short = block_fields(out["frames"], out["frames_raw"] if kw.get("extended") else None)
    if kw.get("extended"):
        out["short_fields"] = short
    return out


def check_shard_gather(dev: torch.device, real: list[tuple[str, list, int, int, int, bool]]) -> int:
    """The shard-gather kernel against its plain version: random shard
    outputs (K = 2048, D 1 and 4, both modes, with and without R2, C below
    and above the total, and as the shards of a process of the
    multi-process decode, from global shard 2) and the sharded steps' own
    (without R2) -> max abs error."""
    from airjax_torch.kernels.candidate import CLASSES
    from airjax_torch.kernels.shard_gather import shard_gather, shard_gather_plain

    rng = np.random.default_rng(111)
    cases = list(real)
    for d in (1, SHARDS):
        for extended in (False, True):
            k, block = CAPACITY, 1 << 24
            shards = []
            for _ in range(d):
                valid = rng.random(k) < 0.9
                s = {"offsets": torch.as_tensor(np.where(valid, np.sort(rng.integers(0, block, k)), 0).astype(np.int32)),
                     "valid": torch.as_tensor(valid), "frames": torch.as_tensor(rng.integers(0, 256, (k, 14), np.uint8)),
                     "n_detections": torch.tensor(int(rng.integers(0, 2 * k)), dtype=torch.int32),
                     "overflow": torch.tensor(False), "recovered2": torch.as_tensor(rng.random(k) < 0.2)}
                if extended:
                    s.update(frames_raw=torch.as_tensor(rng.integers(0, 256, (k, 14), np.uint8)),
                             **{key: torch.as_tensor(rng.integers(0, 1 << 24, k).astype(np.int32))
                                for key in ("df", "icao_ap_short", "icao_ap_long")})
                else:
                    s.update(good=torch.as_tensor(valid & (rng.random(k) < 0.5)),
                             recovered=torch.as_tensor(rng.random(k) < 0.2))
                s = {key: v.to(dev) for key, v in s.items()}
                if extended:  # one (6, K) block, as the block decode writes them
                    s.update(zip(CLASSES, torch.as_tensor(rng.random((6, k)) < 0.2).to(dev).unbind(0)))
                shards.append(s)
            for c in (d * k // 4, d * k + 100):
                cases.append((f"random, D {d}, C {c}", shards, block, d * block - 240 - 77, c, extended))
            cases.append((f"random, D {d} from shard 2, C {d * k}", shards, block, (2 + d) * block - 240 - 77,
                          d * k, extended))
    err = f_err = 0
    for name, shards, block, max_offset, c, extended in cases:
        first = 2 if "from shard 2" in name else 0
        for r2 in (False, True) if "recovered2" in shards[0] else (False,):
            kw = dict(extended=extended, recover2=r2, first_shard=first)
            got = shard_gather(shards, block, max_offset, c, **kw)
            want = shard_gather_plain(shards, block, max_offset, c, **kw)
            e = dict_err(got, want, f"shard gather, {name}")
            check(e == 0, f"shard-gather kernel disagrees with plain on {name}, R2 {r2} (max abs err {e})")
            err = max(err, e)
            # Flag F: against its plain version and against the gather then the fields kernel.
            got = shard_gather(shards, block, max_offset, c, with_fields=True, **kw)
            e = max(dict_err(got, shard_gather_plain(shards, block, max_offset, c, with_fields=True, **kw),
                             f"shard gather F, {name}"),
                    dict_err(got, gather_then_fields((shards, block, max_offset, c), **kw), f"F chain, {name}"))
            check(e == 0, f"shard-gather kernel's F disagrees on {name}, R2 {r2} (max abs err {e})")
            f_err = max(f_err, e)
        total = int(want["n_candidates" if extended else "n_good"])
        print(f"  shard gather == plain, with and without R2, with F == plain == gather + fields kernel: {name}, "
              f"{'extended' if extended else 'DF17'}, total {total}" + (" > C" if total > c else ""))
    torch.cuda.synchronize()
    return err, f_err


def sharded_step_profile(name: str, step, shards: list, d: int, n_off: int, k: int, gate: str,
                         with_fields: bool = False) -> dict:
    """One sharded step (pre-sharded input): its launches (a front and a
    block decode a shard, one shard gather, with_fields its flag F, nothing
    else: no fields kernel), its time by CUDA events, and under the
    profiler the device time of each kernel against its bound ->
    {kernel: (launches a step, device µs a step, bound µs a step)}."""
    with counted() as n:
        step(shards)
        torch.cuda.synchronize()
    check(n == {**ONE_PASS, "magdet_bits": d, "block_decode": d, "shard_gather": 1,
                "shard_gather_fields": int(with_fields)},
          f"{name}: not a front and a block decode a shard and one shard gather: {n}")
    ms = cuda_ms(lambda: step(shards), reps=10)
    want = {"magdet_bits_kernel": d, "block_decode_kernel": d, "shard_gather_kernel": 1}
    for _ in range(PROFILE_TRIES):
        per_kernel, busy, seen, per_pass = device_profile(lambda: step(shards), "shard_gather_kernel")
        counts = {m: round(sum(c for key, c in per_pass.items() if m in key), 6) for m in want}
        if counts == want and seen == 10:
            break
        print(f"profile, {name}: the profiler dropped events ({json.dumps(counts)}, {seen} of 10 steps); again")
    other = [key for key in per_pass if "memset" not in key.lower() and not any(m in key for m in want)]
    check(counts == want and seen == 10 and not other,
          f"{name}: a step should run {d} fronts, {d} block decodes, one shard gather and nothing else, "
          f"each recorded: {json.dumps(per_pass)} ({seen} of 10 steps recorded)")
    L = n_off + 240
    bounds = {"magdet_bits_kernel": bound(*front_work(L, n_off, gate, bits_bytes(L, n_off)))[0] * 1e3,
              "block_decode_kernel": bound(*block_decode_work(n_off, k, gate == "preamble"))[0] * 1e3}
    table = {}
    for m in want:
        dev_us = sum(us for key, us in per_kernel.items() if m in key)
        table[m] = (want[m], dev_us, want[m] * bounds.get(m, float("nan")))
    print(f"sharded step, {name}: {ms * 1e3:.1f} us by CUDA events, device busy {busy:.1f} us ({seen} of 10 steps "
          f"recorded), idle share {1 - busy / (ms * 1e3):.3f}, {d * n_off / ms / 1e3:.1f} MS/s a step by "
          f"events; kernels {sum(us for _, us, _ in table.values()):.1f} us device a step")
    for m, (c, us, b) in table.items():
        print(f"  {m}: {c} a step, {us:.2f} us device a step" + (f", bound {b:.2f} us" if b == b else ""))
    return table


def step_turn(fn, names: tuple[str, ...]) -> tuple[float, float]:
    """A step under the profiler, 10 steps recorded: (device busy µs a step,
    µs a step of the kernels named)."""
    for _ in range(PROFILE_TRIES):
        per_kernel, busy, seen, _ = device_profile(fn, "shard_gather_kernel")
        if seen == 10:
            return busy, sum(us for key, us in per_kernel.items() if any(n in key for n in names))
        print(f"step_turn: the profiler recorded {seen} of 10 steps; again")
    check(False, f"step_turn: the profiler dropped steps in {PROFILE_TRIES} windows")


def batched_steps(mesh, shards: list, block: int, steps: dict) -> tuple[dict, int]:
    """The sharded batched steps (with_fields; DF17 and extended, each with
    and without recover2) at the 4-shard decode's capacities: each profiled
    (a front and a block decode a shard and one gather with F; no fields
    kernel in the window), its dict == the plain gather's with the fields
    on the same shard dicts == the gather then the fields kernel. Then F
    against that chain at the step's shapes, device µs in turns (F, chain,
    chain, F), alone and in a step (the step with F against the step
    without it and then the fields kernel) -> ({extended: the F row of the
    kernel table}, max abs err)."""
    from airjax_torch.kernels.fields import block_fields
    from airjax_torch.kernels.shard_gather import shard_gather, shard_gather_plain
    from airjax_torch.parallel import halo

    rows, err = {}, 0
    for extended in (False, True):
        stats = steps[("4 shards of the card", extended)][1]
        k, c = stats["capacity_per_shard"], stats["compact_capacity"]
        build = halo.build_sharded_decoder_extended_compact if extended else halo.build_sharded_decoder_compact
        mode = "extended" if extended else "DF17"
        step_us = None
        for r2 in (False, True):
            name = f"{mode}{' --recover2' if r2 else ''} batched, {SHARDS} shards of {block}"
            step = build(mesh, block * SHARDS, k, c, with_fields=True, recover2=r2)
            table = sharded_step_profile(name, step, shards, SHARDS, block, k, "preamble" if extended else "df17",
                                         with_fields=True)
            step_us = step_us or table["shard_gather_kernel"][1]
            outs = halo._decode_shards(mesh, shards, block, halo._halo_size(block), k, extended, r2)
            args = (outs, block, block * SHARDS - 240, c)
            got = step(shards)
            e = max(dict_err(got, shard_gather_plain(*args, extended=extended, recover2=r2, with_fields=True), name),
                    dict_err(got, gather_then_fields(args, extended=extended, recover2=r2), name))
            check(e == 0, f"{name}: the step's dict differs from the plain version's or the chain's (max abs err {e})")
            err = max(err, e)
            print(f"  {name}: the step's dict == the plain gather with fields == the gather + fields kernel")
        outs = halo._decode_shards(mesh, shards, block, halo._halo_size(block), k, extended)
        args = (outs, block, block * SHARDS - 240, c)

        def with_f(args=args, extended=extended):
            return shard_gather(*args, extended=extended, with_fields=True)

        def chain(args=args, extended=extended):
            return gather_then_fields(args, extended=extended)

        f_us, chain_us = [], []
        for turn in ("F", "chain", "chain", "F"):
            if turn == "F":
                f_us.append(device_us(with_f, ("shard_gather_kernel",)))
            else:
                chain_us.append(device_us(chain, ("shard_gather_kernel", "fields_kernel")))
        f_step = build(mesh, block * SHARDS, k, c, with_fields=True)
        bare_step = build(mesh, block * SHARDS, k, c)

        def chain_step(extended=extended):
            out = bare_step(shards)
            out["fields"], short = block_fields(out["frames"], out["frames_raw"] if extended else None)
            return out

        in_step = {"F": [], "chain": []}
        for turn in ("F", "chain", "chain", "F"):
            fn = (lambda: f_step(shards)) if turn == "F" else chain_step
            busy, kernels = step_turn(fn, ("shard_gather_kernel", "fields_kernel"))
            in_step[turn].append({"busy_us": busy, "gather_and_fields_us": kernels, "ms": cuda_ms(fn, reps=10)})
        b_ms, b_by = bound(*gather_fields_work(outs, with_f(), extended))
        row = {"ms": cuda_ms(with_f), "chain_ms": cuda_ms(chain),
               "plain_ms": cuda_ms(lambda: shard_gather_plain(*args, extended=extended, with_fields=True)),
               "device_us": statistics.median(f_us), "device_us_turns": f_us, "step_device_us": step_us,
               "chain_device_us": statistics.median(chain_us), "chain_device_us_turns": chain_us,
               "step_turns": in_step,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": f"D {SHARDS}, K {k}, C {c}"}
        rows[extended] = row
        print(f"shard gather with F, {mode} ({row['shape']}): device us in turns F {f_us[0]:.2f}, gather + fields "
              f"kernel {chain_us[0]:.2f}, {chain_us[1]:.2f}, F {f_us[1]:.2f}; in a step {step_us:.2f}; by events F "
              f"{row['ms']:.4f} ms, gather + fields kernel {row['chain_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms; "
              f"bound {b_ms * 1e3:.3f} us ({b_by})")
        for turn, runs in in_step.items():
            print(f"  a batched step, {'gather with F' if turn == 'F' else 'gather + fields kernel'}, in turns: "
                  + "; ".join(f"{r['ms'] * 1e3:.1f} us by events, device busy {r['busy_us']:.1f} us, gather and "
                              f"fields {r['gather_and_fields_us']:.2f} us" for r in runs))
    return rows, err


def phase_sharded(dev: torch.device, tracker_iq: np.ndarray, capture) -> tuple[list[dict], dict[str, int]]:
    """Phase 11: the halo-sharded decode of a 2^26-sample capture (DF17 and
    extended) on 4 shards of the card and on make_mesh(1), against
    decode_capture_overlap and the embedded frames; a sharded step's
    kernels profiled; the shard-gather kernel against its plain version;
    analyze_capture(_extended) on the first 2^25 samples of the tracker
    traffic, its fixes against the per-packet tracker's; decode_channels
    on 8 channels; the sharded batched streams against run_stream's. ->
    (the shard-gather kernel's entry, the launches of the paths)."""
    from airjax_torch import analytics, pipeline
    from airjax_torch.config import PipelineConfig
    from airjax_torch.io import synth
    from airjax_torch.kernels.shard_gather import shard_gather, shard_gather_plain
    from airjax_torch.parallel import channels, halo
    from airjax_torch.parallel.mesh import Mesh, make_mesh
    from airjax_torch.protocol.packet import AdsbPacket
    from airjax_torch.runner import run_stream, run_stream_sharded
    from airjax_torch.track.aircraft import handle_aircraft_update
    from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker

    launches = {"shard_gather": 0, "fields": 0, "shard_gather_fields": 0}

    def add(n: dict) -> None:
        launches["shard_gather"] += n["shard_gather"]

    def shard_launches_ok(name: str, n: dict, d: int) -> None:
        check(n["shard_gather"] >= 1 and n["magdet_bits"] == n["block_decode"] == d * n["shard_gather"]
              and n["compact_bits"] == n["candidate"] == n["magdet_front"] == n["fields"] == 0
              and n["block_decode_fields"] == n["shard_gather_fields"] == 0,
              f"{name}: not a front and a block decode a shard and a shard gather a step: {n}")

    iq, offsets, frames = capture
    want = list(zip(offsets.tolist(), frames))
    t0 = time.perf_counter()
    overlap, _ = pipeline.decode_capture_overlap(iq, PipelineConfig(block_len=1 << 22), device=dev)
    wall = time.perf_counter() - t0
    check([(h[1], h[2]) for h in overlap] == want, "decode_capture_overlap differs from the embedded frames")
    print(f"decode_capture_overlap: {len(overlap)} hits == the embedded frames; {SHARD_SAMPLES / wall / 1e6:.1f} MS/s "
          f"({wall:.2f} s wall, host included)")

    steps = {}
    for name, mesh, k, k_ext in (("4 shards of the card", Mesh([dev] * SHARDS), CAPACITY, 1 << 15),
                                 ("make_mesh(1)", make_mesh(1, device=dev), 4 * CAPACITY, 1 << 17)):
        d = mesh.size
        for extended in (False, True):
            kw = (dict(capacity_per_shard=k_ext) if extended else
                  dict(capacity_per_shard=k, compact_capacity=2 * SHARD_FRAMES))
            decode = halo.decode_capture_sharded_extended if extended else halo.decode_capture_sharded
            with counted() as n:
                got, stats = decode(iq, mesh, **kw)
            shard_launches_ok(name, n, d)
            add(n)
            t0 = time.perf_counter()
            decode(iq, mesh, **kw)
            wall = time.perf_counter() - t0
            if extended:
                # Noise detections give AP candidates too; the cache lets through those whose
                # residual is one of the 4096 ICAOs, so the other packets are held against the
                # one-shard decode (the whole capture as one extended block), not against none.
                long = [(o, p.packet) for o, p in got if type(p).__name__ == "AdsbPacket"]
                check(long == want and stats["n_good_long"] == len(frames),
                      f"{name}: the extended DF17 packets differ from the embedded frames")
                gated = [(o, repr(p)) for o, p in got if type(p).__name__ != "AdsbPacket"]
                if ("4 shards of the card", True) in steps:
                    check(gated == steps[("4 shards of the card", True)][2],
                          f"{name}: the cache-gated packets differ from the 4-shard decode's")
            else:
                gated = None
                check(got == [(0, *h[1:]) for h in overlap], f"{name}: the hits differ from decode_capture_overlap's")
            label = f"decode_capture_sharded{'_extended' if extended else ''}, {name}"
            extra = f" (+ {len(gated)} cache-gated AP packets of noise)" if extended else ""
            print(f"{label}: {len(got) - len(gated or ())} {'packets' if extended else 'hits'} == the embedded "
                  f"frames{extra}; "
                  f"{SHARD_SAMPLES / wall / 1e6:.1f} MS/s ({wall:.2f} s wall, host included; launches {json.dumps(n)}); "
                  f"stats {json.dumps(stats)}")
            steps[(name, extended)] = (mesh, stats, gated)

    # A sharded step's kernels, and the gather at the step's shapes.
    block = halo.tuned_block(-(-SHARD_SAMPLES // SHARDS))
    padded = pipeline.pad_iq_non_detecting(iq, block * SHARDS)
    mesh4 = steps[("4 shards of the card", False)][0]
    shards = halo.shard_iq(padded, mesh4, block, halo._halo_size(block))
    rows = {}
    real = []
    for extended in (False, True):
        stats = steps[("4 shards of the card", extended)][1]
        k, c = stats["capacity_per_shard"], stats["compact_capacity"]
        build = halo.build_sharded_decoder_extended_compact if extended else halo.build_sharded_decoder_compact
        step = build(mesh4, block * SHARDS, k, c)
        table = sharded_step_profile(f"{'extended' if extended else 'DF17'}, {SHARDS} shards of {block}", step,
                                     shards, SHARDS, block, k, "preamble" if extended else "df17")
        outs = halo._decode_shards(mesh4, shards, block, halo._halo_size(block), k, extended)
        args = (outs, block, block * SHARDS - 240, c)
        gathered = shard_gather(*args, extended=extended)
        real.append((f"the {'extended ' if extended else ''}sharded step's shards", outs, block, args[2], c, extended))
        b_ms, b_by = bound(*gather_work(outs, gathered, extended))
        rows[extended] = {"ms": cuda_ms(lambda: shard_gather(*args, extended=extended)),
                          "plain_ms": cuda_ms(lambda: shard_gather_plain(*args, extended=extended)),
                          "device_us": device_us(lambda: shard_gather(*args, extended=extended), ("shard_gather_kernel",)),
                          "step_device_us": table["shard_gather_kernel"][1], "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None, "shape": f"D {SHARDS}, K {k}, C {c}"}
        print(f"shard gather, {'extended' if extended else 'DF17'} ({rows[extended]['shape']}): kernel "
              f"{rows[extended]['ms']:.4f} ms by events, {rows[extended]['device_us']:.2f} us device; plain "
              f"{rows[extended]['plain_ms']:.4f} ms; bound {b_ms * 1e3:.3f} us ({b_by})")
    err, f_err = check_shard_gather(dev, real)
    f_rows, f_check = batched_steps(mesh4, shards, block, steps)
    f_err = max(f_err, f_check)

    # The analyses on the first 2^25 samples of the tracker traffic.
    sub = tracker_iq[:ANALYTICS_SAMPLES]
    hits, _ = pipeline.decode_capture_overlap(sub, device=dev)
    per: dict = {}
    online: dict[int, list] = {}  # the per-packet tracker's new positions, by aircraft
    for _, off, frame, _ in hits:
        packet = AdsbPacket.from_bytes(frame, off / analytics.SAMPLE_RATE)
        prev = per[packet.icao].geo_position if packet.icao in per else None
        handle_aircraft_update(packet, per)
        g = per[packet.icao].geo_position
        if g is not None and g is not prev:
            online.setdefault(packet.icao, []).append((off, g.latitude, g.longitude))
    for name, analyze, kw in (("analyze_capture", analytics.analyze_capture, {}),
                              ("analyze_capture, devices=1", analytics.analyze_capture, {"devices": 1}),
                              ("analyze_capture_extended", analytics.analyze_capture_extended, {})):
        with counted() as n:
            t0 = time.perf_counter()
            tracks, stats = analyze(sub, device=dev, **kw)
            wall = time.perf_counter() - t0
        add(n)
        launches["fields"] += n["fields"]
        check(n["fields"] == (0 if "extended" in name else 1), f"{name}: not one fields launch: {n}")
        fixes = {icao: [(f.offset, f.latitude, f.longitude) for f in t.fixes] for icao, t in tracks.items() if t.fixes}
        check(sorted(fixes) == sorted(online), f"{name}: fixes for other aircraft than the per-packet tracker's")
        for icao, fx in fixes.items():
            # The batch CPR against the tracker's scalar math: to 1e-9 degrees (exact in the replay).
            tol = 0.0 if "extended" in name else 1e-9
            check([o for o, _, _ in fx] == [o for o, _, _ in online[icao]]
                  and all(abs(a - b) <= tol and abs(c - e) <= tol for (_, a, c), (_, b, e) in zip(fx, online[icao])),
                  f"{name} {icao:06x}: fixes differ from the per-packet tracker's")
        print(f"{name}: {len(tracks)} aircraft, {stats['n_fixes']} fixes == the per-packet tracker's at the same "
              f"offsets; {ANALYTICS_SAMPLES / wall / 1e6:.1f} MS/s ({wall:.2f} s wall); launches {json.dumps(n)}; "
              f"stats {json.dumps(stats)}")

    # Channels: 8 receivers of 2^21 samples on the card.
    rng = np.random.default_rng(71)
    chans, embedded = [], []
    for c in range(N_CHANNELS):
        offs = np.sort(rng.choice(np.arange(0, (CHANNEL_SAMPLES - 240) // 300) * 300, CHANNEL_FRAMES, replace=False))
        fr = make_frames(CHANNEL_FRAMES, 80 + c)
        chans.append(synth.modulate(fr, list(map(int, offs)), CHANNEL_SAMPLES, noise_std=60.0, seed=80 + c))
        embedded.append(list(zip(offs.tolist(), fr)))
    chans = np.stack(chans)
    mesh_c = make_mesh(1, "c", device=dev)
    channels.decode_channels(chans, mesh_c)
    with counted() as n:
        t0 = time.perf_counter()
        results = channels.decode_channels(chans, mesh_c)
        wall = time.perf_counter() - t0
    check(n == {**ONE_PASS, "magdet_bits": N_CHANNELS, "block_decode": N_CHANNELS},
          f"channels: not a front and a block decode a channel: {n}")
    check([[(h[1], h[2]) for h in r] for r in results] == embedded, "channels: hits differ from the embedded frames")
    print(f"decode_channels: {N_CHANNELS} channels of {CHANNEL_SAMPLES} samples, every frame; "
          f"{N_CHANNELS * CHANNEL_SAMPLES / wall / 1e6:.1f} MS/s ({wall:.2f} s wall); launches {json.dumps(n)}")

    # The sharded batched streams: the tables of run_stream's.
    def blocks():
        return (sub[i : i + CHUNK] for i in range(0, len(sub), CHUNK))

    for name, tracker, extended, r2 in (("BatchTracker", BatchTracker, False, False),
                                        ("BatchTracker --recover2", BatchTracker, False, True),
                                        ("ExtendedBatchTracker", ExtendedBatchTracker, True, False)):
        single = tracker()
        run_stream(blocks(), single, extended=extended, recover2=r2, device=dev)
        sharded = tracker()
        with counted() as n:
            t0 = time.perf_counter()
            stats = run_stream_sharded(blocks(), sharded, mesh=Mesh([dev] * SHARDS), extended=extended,
                                       recover2=r2).as_dict()
            wall = time.perf_counter() - t0
        add(n)
        launches["shard_gather_fields"] += n["shard_gather_fields"]
        check(n["shard_gather"] == n["shard_gather_fields"] > 0 and n["fields"] == 0
              and n["magdet_bits"] == SHARDS * n["shard_gather"],
              f"sharded {name}: not a shard gather with F, and no fields launch, a step: {n}")
        check(same_table(table_view(sharded.aircrafts, extended), table_view(single.aircrafts, extended)),
              f"run_stream_sharded, {name}: the table differs from run_stream's")
        print(f"run_stream_sharded, {name}, {SHARDS} shards: the table == run_stream's ({len(single.aircrafts)} "
              f"aircraft); {ANALYTICS_SAMPLES / wall / 1e6:.1f} MS/s ({wall:.2f} s wall); launches {json.dumps(n)}; "
              f"stats {json.dumps({k: v for k, v in stats.items() if k != 'stages'})}")

    entry = {"name": "shard_gather", "route": "cuda", "source": "airjax_torch/csrc/shard_gather.cu",
             "replaces": "airjax/parallel/halo.py:259", "launches": None, "path": None, "max_abs_err": err,
             **rows[False], "extended_path": rows[True]}
    f_entry = {"name": "shard_gather_fields", "route": "cuda", "source": "airjax_torch/csrc/shard_gather.cu",
               "replaces": "airjax/parallel/halo.py:417", "launches": None, "path": None, "max_abs_err": f_err,
               **f_rows[False], "extended_path": f_rows[True]}
    return [entry, f_entry], launches


# Phase 12: the multi-process decode (parallel/multihost.py) on the card.
MH_TIMEOUT = 120  # seconds the worker processes may take together (they take about 10)


def mh_canonical(aircrafts: dict) -> dict:
    """A tracker's state as its checkpoint writes it; times still at their
    wall-clock default are not compared (the decodes stamp `now`)."""
    from airjax_torch.track.state import aircraft_to_json

    return {f"{icao:06x}": {k: None if isinstance(v, float) and v >= 1e9 else v
                             for k, v in aircraft_to_json(a).items()} for icao, a in sorted(aircrafts.items())}


def mh_paths(local_iq: np.ndarray, mesh, timed: bool) -> dict:
    """The three multi-process paths over this process's span and mesh: each
    run once with its launches counted (and, `timed`, again for its MS/s and
    the exchange's wall time) -> {path: {digest, n, stats, launches, ...}}."""
    import hashlib

    from airjax_torch.parallel import multihost
    from airjax_torch.track.batch import ExtendedBatchTracker

    exchange = [0.0]
    plain_gather = multihost._all_gather

    def timed_gather(t):  # the exchange's wall time, the card's copies included
        t0 = time.perf_counter()
        out = plain_gather(t)
        if out.is_cuda:
            torch.cuda.synchronize()
        exchange[0] += time.perf_counter() - t0
        return out

    def run(name):
        if name == "decode_capture":
            hits, stats = multihost.decode_capture(local_iq, capacity_per_shard=CAPACITY,
                                                   compact_capacity=2 * SHARD_FRAMES, mesh=mesh)
            return [[h[1], h[2].hex(), h[3]] for h in hits], stats
        if name == "decode_capture_extended":
            packets, stats = multihost.decode_capture_extended(local_iq, capacity_per_shard=1 << 15, now=5.0, mesh=mesh)
            return [[o, repr(p)] for o, p in packets], stats
        tracker = ExtendedBatchTracker()
        applied, stats = multihost.decode_capture_extended_batched(local_iq, tracker, capacity_per_shard=1 << 15,
                                                                   now=5.0, mesh=mesh)
        return [applied, mh_canonical(tracker.aircrafts)], stats

    out = {}
    multihost._all_gather = timed_gather
    try:
        for name in ("decode_capture", "decode_capture_extended", "decode_capture_extended_batched"):
            with counted() as n:
                result, stats = run(name)
                torch.cuda.synchronize()
            entry = {"digest": hashlib.sha256(json.dumps(result).encode()).hexdigest(), "stats": stats,
                     "launches": n, "n": result[0] if name.endswith("batched") else len(result)}
            if name == "decode_capture":
                entry["offsets"] = [h[0] for h in result]
            elif name == "decode_capture_extended":
                entry["long"] = [o for o, r in result if r.startswith("AdsbPacket(")]
            if timed:
                exchange[0] = 0.0
                t0 = time.perf_counter()
                run(name)
                torch.cuda.synchronize()
                entry["wall_s"] = time.perf_counter() - t0
                entry["exchange_s"] = exchange[0]
            out[name] = entry
    finally:
        multihost._all_gather = plain_gather
    return out


def multihost_worker(argv: list[str]) -> int:
    """One rank of phase 12 (`chip_smoke.py --multihost-rank RANK WORLD PORT
    BACKEND SHARDS CAPTURE`): joins the group, decodes its span of the
    saved capture on SHARDS shards of its card, prints `RESULT <json>`."""
    rank, world, port = map(int, argv[:3])
    backend, shards, path = argv[3], int(argv[4]), argv[5]
    from airjax_torch.parallel import multihost
    from airjax_torch.parallel.mesh import Mesh

    check(torch.cuda.is_available(), "a worker without a card")
    if backend == "gloo":
        torch.cuda.set_device(0)  # the ranks of a gloo group share card 0
    check(multihost.init(backend, f"tcp://127.0.0.1:{port}", world, rank) == (rank, world), "init")
    card = torch.device("cuda", torch.cuda.current_device())
    span = SHARD_SAMPLES // world
    local = np.array(np.load(path, mmap_mode="r")[rank * span : (rank + 1) * span])  # a writable copy
    out = mh_paths(local, Mesh([card] * shards), timed=True)
    print("RESULT " + json.dumps({"rank": rank, "card": str(card), "paths": out}), flush=True)
    multihost.dist.destroy_process_group()
    return 0


def run_workers(world: int, backend: str, shards: int, path: str) -> list[dict]:
    """`world` rank processes of chip_smoke.py on `backend`, all within one
    timeout; a nonzero exit or a missing result fails the phase. Each rank
    writes to files of its own, so that no rank waits on a pipe that is not
    read while its peers wait on it in a collective."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # NCCL's bootstrap on one host without a network: the loopback interface.
    env = dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"),
               NCCL_DEBUG=os.environ.get("NCCL_DEBUG", "WARN"))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"{rank}.out"), "w+"), open(os.path.join(tmp, f"{rank}.err"), "w+"))
                for rank in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-rank", str(rank),
                                   str(world), str(port), backend, str(shards), path],
                                  stdout=out, stderr=err, text=True, env=env)
                 for rank, (out, err) in enumerate(logs)]
        deadline = time.monotonic() + MH_TIMEOUT
        late = set()
        try:
            for proc in procs:
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for rank, proc in enumerate(procs):
                if proc.poll() is None:
                    late.add(rank)
                    proc.kill()
                    proc.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    for rank, (proc, (stdout, stderr)) in enumerate(zip(procs, texts)):
        why = f", killed: not ended in {MH_TIMEOUT} s" if rank in late else ""
        check(proc.returncode == 0, f"{backend} rank {rank} exited {proc.returncode}{why}:\n{stdout[-3000:]}\n"
                                    f"{stderr[-3000:]}")
    results = []
    for rank, (stdout, _) in enumerate(texts):
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        check(len(lines) == 1, f"{backend} rank {rank} printed no result")
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results


def phase_multihost(dev: torch.device, capture) -> dict[str, int]:
    """Phase 12: multihost.decode_capture, decode_capture_extended and
    decode_capture_extended_batched of phase 11's capture over 4 shards,
    (a) 2 processes with gloo on card 0, 2 shards each, (b) NCCL, one
    process a card, the 4 shards split among them; every rank == one
    process's decode over the same 4 shards (stats but `processes`) == the
    embedded frames, and a rank's step is its fronts and block decodes, one
    shard gather (and one fields launch batched). -> the launches."""
    from airjax_torch.parallel.mesh import Mesh

    iq, offsets, frames = capture
    one = mh_paths(iq, Mesh([dev] * SHARDS), timed=True)
    check(one["decode_capture"]["offsets"] == offsets.tolist(), "one process: the hits != the embedded frames")
    check(one["decode_capture_extended"]["long"] == offsets.tolist()
          and one["decode_capture_extended"]["stats"]["n_good_long"] == len(frames),
          "one process: the extended DF17 packets != the embedded frames")
    check(one["decode_capture_extended_batched"]["n"] == one["decode_capture_extended"]["n"],
          "one process: the batched tracker applied another number of messages than the packets")
    launches = {"shard_gather": 0, "fields_extended": 0}

    def add(n: dict) -> None:
        launches["shard_gather"] += n["shard_gather"]
        launches["fields_extended"] += n["fields"]

    for name, entry in one.items():
        add(entry["launches"])
        print(f"multihost, one process, {SHARDS} shards of the card, {name}: {entry['n']} "
              f"{'messages' if name.endswith('batched') else 'hits' if name == 'decode_capture' else 'packets'}; "
              f"{SHARD_SAMPLES / entry['wall_s'] / 1e6:.1f} MS/s ({entry['wall_s']:.3f} s wall, host included); "
              f"stats {json.dumps(entry['stats'])}")
    n_cards = torch.cuda.device_count()
    world_nccl = max(w for w in (1, 2, 4) if w <= n_cards)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.npy")
        np.save(path, iq)
        for label, world, backend in ((f"gloo, 2 processes on card 0", 2, "gloo"),
                                      (f"nccl, {world_nccl} process(es), one a card", world_nccl, "nccl")):
            shards = SHARDS // world
            t0 = time.perf_counter()
            ranks = run_workers(world, backend, shards, path)
            wall = time.perf_counter() - t0
            check([r["rank"] for r in ranks] == list(range(world)), f"{label}: ranks {[r['rank'] for r in ranks]}")
            if backend == "nccl":
                check([r["card"] for r in ranks] == [f"cuda:{i}" for i in range(world)],
                      f"{label}: the ranks' cards {[r['card'] for r in ranks]}")
            for name, want in one.items():
                for r in ranks:
                    got = r["paths"][name]
                    stats = dict(got["stats"])
                    check(stats.pop("processes") == world, f"{label}, {name}: processes")
                    check(got["digest"] == want["digest"] and got["n"] == want["n"]
                          and stats == {k: v for k, v in want["stats"].items() if k != "processes"},
                          f"{label}, rank {r['rank']}, {name}: differs from one process's decode: "
                          f"{got['n']} vs {want['n']}, stats {got['stats']} vs {want['stats']}")
                    n = got["launches"]
                    check(n == {**ONE_PASS, "magdet_bits": shards, "block_decode": shards, "shard_gather": 1,
                                "fields": 1 if name.endswith("batched") else 0},
                          f"{label}, rank {r['rank']}, {name}: not {shards} fronts, {shards} block decodes, one "
                          f"shard gather{' and one fields launch' if name.endswith('batched') else ''}: {n}")
                    add(n)
                rates = ", ".join(f"rank {r['rank']} {SHARD_SAMPLES / r['paths'][name]['wall_s'] / 1e6:.1f} MS/s "
                                  f"({r['paths'][name]['wall_s']:.3f} s wall, exchange "
                                  f"{r['paths'][name]['exchange_s'] * 1e3:.1f} ms)" for r in ranks)
                print(f"multihost, {label}, {shards} shard(s) a rank, {name}: every rank == one process's decode "
                      f"(stats but processes); {rates}")
            print(f"multihost, {label}: {wall:.1f} s for the {world} processes, start-up included")
    return launches


# Phase 13: the golden oracle, the per-chunk parity decode, the debug aids.
GOLDEN_SAMPLES = 2_000_000


def count_entry(dev: torch.device, tracker_iq: np.ndarray) -> dict:
    """The front's count mode (kernels/magdet.py::chunked_detection_count,
    the fused parity decode's detection count) against its plain version
    and against the first front's mask count (csrc/magdet.cu, then pad,
    view and sum: the path it replaced) on the first 2 M and 2^24 samples
    of the tracker traffic; at 2^24 device µs in turns (count, old, old,
    count) -> the kernel table's entry."""
    from airjax_torch.kernels.magdet import chunked_detection_count, chunked_detection_count_plain, magdet, n_tiles
    from airjax_torch.pipeline import reference_chunk_count

    def old(iq, n_chunks):
        n_scan = n_chunks * CHUNK - 240
        det, _ = magdet(iq[: n_chunks * CHUNK], n_scan)
        det = torch.nn.functional.pad(det, (0, n_chunks * CHUNK - n_scan))
        return det.view(n_chunks, CHUNK)[:, : CHUNK - 240].sum(dtype=torch.int32)

    err = 0
    for n in (GOLDEN_SAMPLES, BLOCK):
        iq = torch.as_tensor(np.ascontiguousarray(tracker_iq[:n])).to(dev)
        n_chunks = reference_chunk_count(n)
        got = chunked_detection_count(iq, CHUNK, n_chunks)
        e = max(max_abs_err([(got, chunked_detection_count_plain(iq, CHUNK, n_chunks))]),
                max_abs_err([(got, old(iq, n_chunks))]))
        check(e == 0, f"count mode: {int(got)} detections differ from the plain or first-front count on {n} samples")
        err = max(err, e)
        print(f"  count mode == plain == the first front's mask count: {int(got)} detections in {n_chunks} chunks "
              f"of {n} samples")
    n_samples, n_off = n_chunks * CHUNK, n_chunks * CHUNK - 240

    def count():
        return chunked_detection_count(iq, CHUNK, n_chunks)

    def first_front():
        return old(iq, n_chunks)

    kernel_us, old_us = [], []
    for turn in ("count", "old", "old", "count"):
        if turn == "count":
            kernel_us.append(device_us(count, ("magdet_bits_kernel",)))
        else:
            old_us.append(device_us(first_front, ("magdet_kernel",)))
    b_ms, b_by = bound(4 * n_samples + 4 * n_tiles(n_off), 5 * n_samples + 26 * n_off)
    row = {"name": "chunked_detection_count", "route": "cuda", "source": "airjax_torch/csrc/front.cu",
           "replaces": "airjax/pipeline.py:464", "launches": None, "path": None, "max_abs_err": err,
           "ms": cuda_ms(count),
           "plain_ms": cuda_ms(lambda: chunked_detection_count_plain(iq, CHUNK, n_chunks), reps=5),
           "library_ms": None, "device_us": statistics.median(kernel_us), "device_us_turns": kernel_us,
           "with_sum_device_us": device_us(count), "first_front_device_us": statistics.median(old_us),
           "first_front_device_us_turns": old_us, "first_front_with_ops_device_us": device_us(first_front),
           "first_front_ms": cuda_ms(first_front), "bound_ms": b_ms, "bound_by": b_by,
           "shape": f"{n_chunks} chunks of {CHUNK} samples"}
    print(f"count mode at {n_samples} samples: device us in turns count {kernel_us[0]:.2f}, first front "
          f"{old_us[0]:.2f}, {old_us[1]:.2f}, count {kernel_us[1]:.2f}; with the sum {row['with_sum_device_us']:.2f} "
          f"against the first front with its pad, copy and sum {row['first_front_with_ops_device_us']:.2f}; by events "
          f"{row['ms']:.4f} ms against {row['first_front_ms']:.4f}; plain {row['plain_ms']:.4f} ms; bound "
          f"{b_ms * 1e3:.2f} us ({b_by})")
    return row


def phase_oracle(dev: torch.device, tracker_iq: np.ndarray) -> tuple[dict[str, int], dict]:
    """Phase 13: golden.decode_capture_playback of 2 M samples of the
    tracker traffic == decode_capture_parity on the card, fused and per
    chunk (fused=False: a front and a block decode a chunk, plus any chunk
    decoded again), the two forms' stats equal; the fused form's detection
    count one launch of the front's count mode and no first-front launch,
    the count held to the first front's (count_entry); `adsb --playback
    --dump-preamble` on the card prints what it prints on the CPU
    (`Processed Time` masked); `adsb --trace DIR` writes a trace that names
    the front and block-decode kernels. -> the launches."""
    from airjax_torch import golden, pipeline
    from airjax_torch.io.c16 import save_c16

    sub = np.ascontiguousarray(tracker_iq[:GOLDEN_SAMPLES])
    t0 = time.perf_counter()
    gold = golden.decode_capture_playback(sub)
    t_gold = time.perf_counter() - t0
    forms = {}
    for fused in (True, False):
        pipeline.decode_capture_parity(sub[: 4 * CHUNK + 10], fused=fused, device=dev)  # warm
        with counted() as n:
            t0 = time.perf_counter()
            hits, stats = pipeline.decode_capture_parity(sub, fused=fused, device=dev)
            wall = time.perf_counter() - t0
        check([(c, o, f) for c, o, f, _ in hits] == gold, f"decode_capture_parity(fused={fused}) != golden")
        forms[fused] = (stats, n, wall)
    # The fused form counts the reference-chunked detections with the
    # front's count mode: one launch a capture, none of csrc/magdet.cu.
    check(forms[True][1]["chunked_count"] == 1 and forms[True][1]["magdet_front"] == 0,
          f"fused: not one count-mode launch and no first-front launch a capture: {forms[True][1]}")
    n_chunks = pipeline.reference_chunk_count(len(sub))
    (fstats, _, fwall), (cstats, n, cwall) = forms[True], forms[False]
    check(fstats == cstats, f"the parity stats differ: fused {fstats}, per chunk {cstats}")
    check(n["magdet_bits"] == n["block_decode"] >= n_chunks and (n["magdet_bits"] == n_chunks or cstats["overflow"])
          and n["compact_bits"] == n["candidate"] == n["magdet_front"] == n["fields"] == n["shard_gather"] == 0
          and n["chunked_count"] == 0,
          f"fused=False: not a front and a block decode a chunk ({n_chunks} chunks): {n}")
    print(f"golden oracle: {len(gold)} hits in {n_chunks} chunks == decode_capture_parity fused and per chunk; "
          f"stats equal {json.dumps(fstats)}; golden {GOLDEN_SAMPLES / t_gold / 1e6:.2f} MS/s (host), fused "
          f"{GOLDEN_SAMPLES / fwall / 1e6:.1f} MS/s, per chunk {GOLDEN_SAMPLES / cwall / 1e6:.1f} MS/s "
          f"(launches {json.dumps(n)})")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traffic.c16")
        save_c16(tracker_iq[: 10 * CHUNK + 10], path)
        card, _, _ = run_cli(["adsb", "--playback", path, "--fast", "--dump-preamble"])
        cpu, _, _ = run_cli(["adsb", "--playback", path, "--fast", "--dump-preamble", "--torch-device", "cpu"])
        dumps = sum(ln.startswith("preamble @ ") for ln in card.splitlines())
        check(dumps > 0 and masked(card[: card.rindex("\nstats: ")]) == masked(cpu[: cpu.rindex("\nstats: ")]),
              "adsb --dump-preamble: the card's text differs from the CPU's")
        trace_dir = os.path.join(tmp, "trace")
        run_cli(["adsb", "--playback", path, "--fast", "--trace", trace_dir])
        names = set()
        for root, _, files in os.walk(trace_dir):
            for f in files:
                with open(os.path.join(root, f)) as fh:
                    names |= {e.get("name", "") for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"}
        check(any("magdet_bits_kernel" in x for x in names) and any("block_decode_kernel" in x for x in names),
              f"adsb --trace: the trace names no front or block-decode kernel: {sorted(names)[:10]}")
    print(f"adsb --dump-preamble: the card's {dumps} dumps and packets == the CPU's (Processed Time masked); "
          f"adsb --trace: a trace with {len(names)} kernel names, the front's and the block decode's among them")
    entry = count_entry(dev, tracker_iq)
    check(int(pipeline._count_chunked_detections(torch.as_tensor(sub).to(dev), CHUNK, n_chunks))
          == fstats["n_detections"], "the fused parity decode's n_detections is not the count mode's")
    return {"magdet_bits_chunks": n["magdet_bits"], "chunked_detection_count": forms[True][1]["chunked_count"]}, entry


# Phase 14: the pipelined stream (runner's pipeline_depth, pipeline.Fetcher).
PIPE_DEPTHS = (0, 1, 2, 4)
PIPE_SAMPLES = 10_000_000  # the tracker traffic's first 5 s, for the tables
BIG_STREAM_BLOCKS = 8  # phase 4's block, fed this many times


def stream_pass(name: str, blocks, sink, runner=None, **kw):
    """One stream through `runner` (run_stream by default) -> (stats,
    stats.as_dict(), launches); prints its MS/s, the mean dispatch, fetch
    and apply ms a decode, the fetches that overlapped the next decode, and
    those made early because the source had no block ready."""
    from airjax_torch.runner import run_stream

    with counted() as n, replayed() as g:
        t0 = time.perf_counter()
        stats = (runner or run_stream)(blocks(), sink, **kw)
        wall = time.perf_counter() - t0
    n["graphs"] = g
    d = stats.as_dict()
    st = d["stages"]
    print(f"pipelined, {name}: {d['samples'] / wall / 1e6:.2f} MS/s ({wall:.3f} s wall, {d['samples']} samples); "
          f"dispatch / fetch / apply {st['dispatch']['mean_ms']:.4f} / {st['fetch']['mean_ms']:.4f} / "
          f"{st['apply']['mean_ms']:.4f} ms a decode ({st['fetch']['calls']} decodes); {stats.overlapped} of "
          f"{stats.fetches} fetches returned with the next decode pending, {stats.early_fetches} early; "
          f"launches {json.dumps(n)}"
          + (f"; slots {stats.graphs['pinned_bytes']} B pinned, {stats.graphs['device_bytes']} B on the card"
             if stats.graphs else ""))
    return stats, d, n


def same_stats(a: dict, b: dict) -> bool:
    return {k: v for k, v in a.items() if k not in ("stages", "msamples_per_s")} == {
        k: v for k, v in b.items() if k not in ("stages", "msamples_per_s")}


def phase_pipelined(dev: torch.device, stream_capture, block: np.ndarray, block_frames: list[bytes],
                    tracker_iq: np.ndarray) -> None:
    """Phase 14: run_stream keeps pipeline_depth decodes in flight, each
    fetched on a copy stream after its own event (pipeline.Fetcher). Each
    pass below runs in turns (0, 1, ..., 1, 0) and prints its MS/s and
    stages. Phase 6's 20 M-sample stream at depths 0, 1, 2 and 4: the
    packets are the embedded frames in order, a front and a block decode a
    block. The first PIPE_SAMPLES of the tracker traffic into
    ExtendedBatchTracker and BatchTracker --recover2, and
    run_stream_sharded on 4 shards of the card into BatchTracker, at depths
    0 and 1: the tables and stats equal. Phase 4's block fed
    BIG_STREAM_BLOCKS times at depths 0 and 1 (capacity 2048: no regrow):
    the same packets, and at depth 1 block k+1 still pending when block
    k's fetch returns in at least half the blocks; a profiler window of
    that depth-1 stream runs the front and the block decode a decode and
    no other kernel."""
    from airjax_torch.config import PipelineConfig
    from airjax_torch.parallel.mesh import Mesh
    from airjax_torch.runner import run_stream_sharded
    from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker

    def chunks(iq, n):
        return lambda: (iq[i : i + CHUNK] for i in range(0, n, CHUNK))

    stream_iq, frames = stream_capture
    n_blocks = STREAM_SAMPLES // CHUNK
    for depth in PIPE_DEPTHS + PIPE_DEPTHS[::-1]:  # in turns
        got = []
        stats, d, n = stream_pass(f"phase 6's stream, depth {depth}", chunks(stream_iq, STREAM_SAMPLES), got.append,
                                  device=dev, pipeline_depth=depth)
        check([p.packet for p in got] == frames, f"depth {depth}: the packets are not the embedded frames in order")
        check(n["magdet_bits"] == n["block_decode"] == n_blocks == d["blocks"] and stats.fetches == n_blocks
              and n["compact_bits"] == n["candidate"] == n["magdet_front"] == n["fields"] == 0,
              f"depth {depth}: not a front and a block decode a block: {n}")
        g = n["graphs"]
        check((g["eager"], g["captures"], g["replays"]) == (1, depth + 1, n_blocks - 1),
              f"depth {depth}: not one eager block, depth + 1 captures and replays: {g}")
        print(f"  stages: {json.dumps(d['stages'])}")

    tracks = chunks(tracker_iq, PIPE_SAMPLES)
    for name, make, kw in (("ExtendedBatchTracker", ExtendedBatchTracker, {"extended": True}),
                           ("BatchTracker --recover2", BatchTracker, {"recover2": True}),
                           ("run_stream_sharded, 4 shards of the card, BatchTracker", BatchTracker,
                            {"runner": run_stream_sharded, "mesh": Mesh([dev] * 4)})):
        runs = []
        for depth in (0, 1, 1, 0):  # in turns
            sink = make()
            extra = {} if "runner" in kw else {"device": dev}
            _, d, n = stream_pass(f"{name}, depth {depth}", tracks, sink, pipeline_depth=depth, **kw, **extra)
            check(n["block_decode"] > 0 and n["compact_bits"] == n["candidate"] == 0, f"{name}: launches {n}")
            runs.append((table_view(sink.aircrafts, kw.get("extended", False)), d))
        t0_, d0 = runs[0]
        check(len(t0_) > 0 and all(same_table(t0_, t) and same_stats(d0, d) for t, d in runs[1:]),
              f"{name}: depth 1's table or stats differ from depth 0's")
        print(f"  {name}: depth 1 == depth 0 ({len(t0_)} aircraft, stats "
              f"{json.dumps({k: v for k, v in d0.items() if k not in ('stages', 'msamples_per_s')})})")

    def big():
        return (block for _ in range(BIG_STREAM_BLOCKS))

    # Phase 4's capacity: 1024 frames a block never regrow.
    cfg = PipelineConfig(max_candidates=CAPACITY)
    for depth in (0, 1, 1, 0):  # in turns
        got = []
        stats, d, n = stream_pass(f"phase 4's block x {BIG_STREAM_BLOCKS}, depth {depth}", big, got.append,
                                  cfg=cfg, device=dev, pipeline_depth=depth)
        check([p.packet for p in got] == block_frames * BIG_STREAM_BLOCKS,
              f"the 2^24 stream, depth {depth}: packets differ")
        check(n["magdet_bits"] == n["block_decode"] == stats.fetches == BIG_STREAM_BLOCKS + 1
              == n["graphs"]["eager"] + n["graphs"]["replays"] and n["graphs"]["replays"] > 0,
              f"the 2^24 stream, depth {depth}: not a front and a block decode a decode, through the graphs: {n}")
        check(depth == 0 or 2 * stats.overlapped >= BIG_STREAM_BLOCKS,
              f"the 2^24 stream at depth 1: block k+1 pending at block k's fetch in {stats.overlapped} of "
              f"{BIG_STREAM_BLOCKS} blocks, not half")
        print(f"  stages: {json.dumps(d['stages'])}")

    from airjax_torch.runner import run_stream

    def one_stream():
        run_stream(big(), lambda p: None, cfg, device=dev, pipeline_depth=1)

    # A capture (pipeline.BlockGraphs) launches torch's own bookkeeping of
    # the CUDA generator's state: two int64 fills, at capture and not in the
    # graph; nothing else of the stream's is a kernel other than the two.
    def capture_fill(x: str) -> bool:
        return "FillFunctor<long>" in x

    one_stream()
    for _ in range(PROFILE_TRIES):
        with replayed() as g:
            events = device_events(one_stream, 1)
        names = [e.name for e in events if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
        fronts = sum("magdet_bits_kernel" in x for x in names)
        decodes = sum("block_decode_kernel" in x for x in names)
        fills = sum(capture_fill(x) for x in names)
        other = sorted({x[:80] for x in names if "magdet_bits_kernel" not in x and "block_decode_kernel" not in x
                        and not capture_fill(x)})
        check(not other and fills <= 2 * g["captures"],
              f"the depth-1 2^24 stream ran other kernels: {other}, {fills} fills for {g['captures']} captures")
        if fronts == decodes == BIG_STREAM_BLOCKS + 1 and fills == 2 * g["captures"]:
            break
        print(f"profile, the depth-1 2^24 stream: the profiler dropped events ({fronts} fronts, {decodes} block "
              f"decodes, {fills} fills of {g['captures']} captures); again")
    else:
        check(False, f"the depth-1 2^24 stream: the profiler dropped events in {PROFILE_TRIES} windows")
    busy = busy_us(events)
    copies = sum(1 for e in events if "memcpy" in e.name.lower())
    print(f"pipelined, the depth-1 2^24 stream under the profiler: {fronts} fronts and {decodes} block decodes, no "
          f"other kernel but {fills} generator-state fills of its {g['captures']} captures; {copies} copies; "
          f"device busy {busy / 1e3:.3f} ms")


# Phase 15: live input on the card (sdr.py, the native ring, list/receive/adsb).
LIVE_BLOCKS = 50
LIVE_OFFSETS = (1000, 7000, 13000)


def fake_capture(path: str) -> list[bytes]:
    """A 20,000-sample capture (one MTU block of the fake SoapySDR, which
    cycles it) of three DF17 identification frames in its interior -> the
    frames."""
    from airjax_torch.io import synth
    from airjax_torch.io.c16 import save_c16

    frames = [synth.make_df17(0x7C0DE0 + i, synth.make_id_me(f"LIVE{i:04d}")) for i in range(len(LIVE_OFFSETS))]
    save_c16(synth.modulate(frames, list(LIVE_OFFSETS), CHUNK, seed=11), path)
    return frames


@contextlib.contextmanager
def fake_soapysdr(tmp: str):
    """The environment that points sdr.py at the fake SoapySDR (built from
    native/fake_soapysdr.c) over fake_capture's capture -> (capture path,
    frames, log path); the variables restored on exit."""
    from airjax_torch import native

    capture, log = os.path.join(tmp, "fake.c16"), os.path.join(tmp, "soapy.log")
    frames = fake_capture(capture)
    env = {"AIRJAX_SOAPY_LIB": str(native.build_fake_soapysdr()), "AIRJAX_FAKE_SOAPY_C16": capture,
           "AIRJAX_FAKE_SOAPY_LOG": log}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield capture, frames, log
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_live(dev: torch.device, tracker_iq: np.ndarray) -> None:
    """Phase 15: through the fake SoapySDR, `list` prints its device,
    `receive --synthetic` writes the synthetic stream and a live `receive`
    the fake's blocks; `adsb --max-blocks LIVE_BLOCKS` on the card decodes
    the capture's frames LIVE_BLOCKS times over, the blocks through the
    native ring (sdr.ring_blocks), a front and a block decode a block; the
    port's native.decode_chunk, chunk by chunk, == decode_capture_parity on
    the card on phase 13's traffic."""
    from airjax_torch import native, pipeline, sdr
    from airjax_torch.io.c16 import load_c16
    from airjax_torch.io.source import synthetic_blocks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, fake_soapysdr(tmp) as (capture, frames, log), contextlib.chdir(tmp):
        text, _ = cli_out(["list"])
        check(text == "0: device 0\n", f"list printed {text!r}")
        text, _ = cli_out(["receive", "2000000.0", "2000000.0", "49.5", "1", "--synthetic"])
        want = np.concatenate(list(synthetic_blocks(chunk=CHUNK, n_blocks=100)))[:2_000_000]
        check(np.array_equal(load_c16("data_2000000.0_2000000.0_49.5"), want),
              f"receive --synthetic: not the synthetic stream ({text.strip()})")
        text, wall = cli_out(["receive", "1090000000.0", "2000000.0", "49.5", "1", "-d", "0"])
        cap = load_c16("data_1090000000.0_2000000.0_49.5")
        blocks = cap.reshape(-1, CHUNK, 2) if len(cap) % CHUNK == 0 else None
        check(blocks is not None and len(blocks) > 0 and all(np.array_equal(b, load_c16(capture)) for b in blocks),
              f"receive: not the fake's blocks ({text.strip()})")
        check('makeStrArgs args="driver=rtlsdr,rtl=0"' in open(log).read(), "receive -d 0: not device 0")
        print(f"live: list == '0: device 0'; receive --synthetic == 2 M samples of the synthetic stream; receive "
              f"-d 0 wrote {len(blocks)} of the fake's blocks in {wall:.2f} s")

        sdr.ring_blocks = 0
        with counted() as n:
            text, stats, wall = run_cli(["adsb", "--max-blocks", str(LIVE_BLOCKS)])
        check(hexes(text) == [f.hex() for f in frames] * LIVE_BLOCKS,
              f"live adsb: {len(hexes(text))} packets, not the capture's {len(frames)} frames {LIVE_BLOCKS} times")
        check(sdr.ring_blocks >= LIVE_BLOCKS, f"live adsb: {sdr.ring_blocks} blocks through the native ring")
        check(stats["blocks"] == LIVE_BLOCKS and n["magdet_bits"] == n["block_decode"] == LIVE_BLOCKS
              and n["compact_bits"] == n["candidate"] == n["fields"] == 0, f"live adsb: stats {stats}, launches {n}")
        closing = open(log).read()
        check("closeStream" in closing and "unmake" in closing, "live adsb: the SDR was not closed")
        print(f"live: adsb --max-blocks {LIVE_BLOCKS} on the card: {len(hexes(text))} packets == the capture's "
              f"frames x {LIVE_BLOCKS}, {sdr.ring_blocks} blocks through the native ring, launches {json.dumps(n)}; "
              f"{wall:.2f} s; stages {json.dumps(stats['stages'])}")

    sub = np.ascontiguousarray(tracker_iq[:GOLDEN_SAMPLES])
    hits, _ = pipeline.decode_capture_parity(sub, device=dev)
    t1 = time.perf_counter()
    nat = []
    for c in range(pipeline.reference_chunk_count(len(sub))):
        chunk_hits, _ = native.decode_chunk(sub[c * CHUNK : (c + 1) * CHUNK])
        nat += [(c, o, f, r) for o, f, r in chunk_hits]
    t_nat = time.perf_counter() - t1
    check(nat == hits, f"native.decode_chunk ({len(nat)} hits) != decode_capture_parity on the card ({len(hits)})")
    print(f"live: native.decode_chunk == decode_capture_parity on the card, {len(hits)} hits of {GOLDEN_SAMPLES} "
          f"samples of the tracker traffic; native {GOLDEN_SAMPLES / t_nat / 1e6:.2f} MS/s (host); phase "
          f"{time.perf_counter() - t0:.1f} s")


# Phase 16: the port's tools at small size on the card, as processes of their own.
TOOLS_TIMEOUT = 400


def run_tools(commands: dict[str, list[str]], env: dict, tmp: str) -> None:
    """Each command in a process of its own, all started together, each
    writing to a file; every one must exit 0 within TOOLS_TIMEOUT. Prints
    each one's wall time and last line; kills what is left."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    try:
        t0 = time.perf_counter()
        for name, argv in commands.items():
            out = open(os.path.join(tmp, f"{len(procs)}.log"), "w")
            procs[name] = (subprocess.Popen([sys.executable, *argv], cwd=root, env=env, stdout=out,
                                            stderr=subprocess.STDOUT), out)
        for name, (proc, out) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, TOOLS_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = None
            out.close()
            lines = open(out.name).read().strip().splitlines() or [""]
            check(rc == 0, f"{name} exited {rc}: {' | '.join(lines[-8:])}")
            print(f"tools: {name}: exit 0 by {time.perf_counter() - t0:.1f} s: {lines[-1][:400]}")
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def phase_tools() -> None:
    """Phase 16: airjax_torch/tools on the card, all at once: fuzz_parity and
    fuzz_extended (and --recover2) at 20 iterations, soak for 10 s, soak
    --sdr for 5 s through the fake SoapySDR, dryrun_multichip on
    Mesh([card 0] * 4); each exits 0."""
    tools = "airjax_torch/tools/"
    with tempfile.TemporaryDirectory() as tmp, fake_soapysdr(tmp):
        run_tools({
            "fuzz_parity --iters 20": [tools + "fuzz_parity.py", "--iters", "20"],
            "fuzz_extended --iters 20": [tools + "fuzz_extended.py", "--iters", "20"],
            "fuzz_extended --iters 20 --recover2": [tools + "fuzz_extended.py", "--iters", "20", "--recover2"],
            "soak --seconds 10": [tools + "soak.py", "--seconds", "10"],
            "soak --sdr --seconds 5": [tools + "soak.py", "--sdr", "--seconds", "5"],
            "dryrun_multichip 4 --one-card": [tools + "dryrun_multichip.py", "4", "--one-card"],
        }, dict(os.environ), tmp)


def phase_sweeps() -> None:
    """Phase 16, second part: airjax_torch/tools/snr_sweep.py at its default
    size (BASELINE config 2: 8 SNRs x 8 captures of 24,001 samples) with
    --golden, --extended --golden and --recover2, the three at once after
    the other tools; each exits 0 (its curve equals the golden decoder's,
    or recover2's is a pure gain) and prints its wall time."""
    sweep = "airjax_torch/tools/snr_sweep.py"
    with tempfile.TemporaryDirectory() as tmp:
        run_tools({
            "snr_sweep --golden": [sweep, "--golden"],
            "snr_sweep --extended --golden": [sweep, "--extended", "--golden"],
            "snr_sweep --recover2": [sweep, "--recover2"],
        }, dict(os.environ), tmp)


# Phase 17: the last airjax names on the card.
def device_ops(fn, calls: int = 10) -> tuple[float, int, list[str]]:
    """(device µs a call, device events a call, their names) of fn, torch
    ops, under torch.profiler; a window whose event count is no multiple
    of `calls` is profiled again (PROFILE_TRIES windows, then it fails)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        events = device_events(fn, calls)
        if events and len(events) % calls == 0:
            names = sorted({e.name[:60] for e in events})
            return sum(e.time_range.end - e.time_range.start for e in events) / calls, len(events) // calls, names
        print(f"device_ops: the profiler dropped events ({len(events)} in {calls} calls); again")
    check(False, f"device_ops: the profiler dropped events in {PROFILE_TRIES} windows")


def phase_names(dev: torch.device, frames: list[bytes], offsets: np.ndarray) -> None:
    """Phase 17: modulate_device at bench.py's shape (2^24 + 1024 samples,
    phase 4's 1024 DF17 frames at multiples of 300, noise 60): the same
    capture on two calls, decode_iq_block finds every frame at its offset,
    noise_std=0 on the card == the CPU's; timed by CUDA events against the
    host `modulate`, profiled against its bound (the int16 capture written
    once). Then the port's other counterparts of airjax names that no
    decode path runs, on the card against their CPU results: the u32 magnitudes, slice_bits (its clamps), the sparse
    byte reader, pack_cmp_words_reduce, compact_detections at several
    tiles, pipeline.compact_mask, decode_mags_block_r2, and
    decode_iq_block_kernel == decode_iq_block in the same two launches.
    Last, airjax's own calls with no device, decode_capture_overlap(iq)
    and run_stream(blocks, cb, DEFAULT_CONFIG, True, 2), on the capture's
    first 2^21 samples: they run on the card (the front and the block
    decode launched) and equal the same calls with device="cuda"."""
    from airjax_torch import config, pipeline, runner
    from airjax_torch.dsp import demod, magnitude
    from airjax_torch.io import synth
    from airjax_torch.parallel import mesh
    from airjax_torch.protocol import crc

    t_phase = time.perf_counter()
    n = BLOCK + HALO
    n_off = BLOCK - 240
    offs = list(map(int, offsets))

    def make():
        return synth.modulate_device(frames, offs, n, noise_std=60.0, seed=0, device=dev)

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cap = make()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(cap.shape == (n, 2) and cap.dtype == torch.int16 and cap.device.type == dev.type, "modulate_device's tensor")
    check(torch.equal(cap, make()), "modulate_device: two calls with one seed differ")
    check(not torch.equal(cap, synth.modulate_device(frames, offs, n, seed=1, device=dev)),
          "modulate_device: another seed gave the same capture")
    q = cap[:, 1].double()
    print(f"modulate_device: Q mean {float(q.mean()):.4f}, std {float(q.std()):.4f} (noise_std 60)")
    check(abs(float(q.mean())) < 0.1 and abs(float(q.std()) / 60.0 - 1.0) < 0.01, "modulate_device's noise")
    with counted() as launches:
        out = pipeline.to_host(pipeline.decode_iq_block(cap, n_off, CAPACITY))
    check(launches == ONE_PASS, f"decode of modulate_device's capture: {launches}")
    good = out["good"]
    check(int(out["n_good"]) == len(frames) and out["offsets"][good].tolist() == offs
          and [bytes(r) for r in out["frames"][good]] == frames,
          f"modulate_device's capture decoded to {int(out['n_good'])} frames, not the {len(frames)} embedded")
    quiet = synth.modulate_device(frames, offs, n, noise_std=0.0, device=dev)
    check(torch.equal(quiet.cpu(), synth.modulate_device(frames, offs, n, noise_std=0.0, device="cpu")),
          "modulate_device(noise_std=0): the card's capture != the CPU's")

    ms = cuda_ms(make, reps=20, warmup=3)
    dev_us, n_events, names = device_ops(make)
    t0 = time.perf_counter()
    synth.modulate(frames, offs, n, noise_std=60.0, seed=0)
    host_ms = (time.perf_counter() - t0) * 1e3
    b_ms, b_by = bound(2 * 2 * n, 0)
    print(f"modulate_device, {n} samples, {len(frames)} frames: {ms:.4f} ms by events (median of 20), "
          f"{dev_us:.2f} µs device, {n_events} device events a call ({', '.join(names)}); bound "
          f"{b_ms * 1e3:.2f} µs ({b_by}, the int16 capture once); peak memory {peak / 2**20:.1f} MiB "
          f"({peak / n:.2f} B a sample); host modulate {host_ms:.1f} ms (one call)")

    # The other names, on a 2^20-sample head of the capture, card against CPU.
    head = cap[: (1 << 20) + 1024]
    head_cpu = head.cpu()
    mags, mags_cpu = magnitude.magnitude_u16(head), magnitude.magnitude_u16(head_cpu)
    h_off = (1 << 20) - 240
    det = demod.detect(mags, h_off)
    rng = np.random.default_rng(17)
    cand = np.concatenate([np.nonzero(det.cpu().numpy())[0], rng.integers(0, h_off, 200),
                           [h_off + 239, head.shape[0], -1, -300]])
    plane = torch.as_tensor(rng.integers(0, 256, 1 << 20, dtype=np.uint8))
    sq = magnitude.squared_magnitude_u32(head_cpu)
    pairs = {
        "squared_magnitude_u32": (magnitude.squared_magnitude_u32(head), sq),
        "isqrt_u32": (magnitude.isqrt_u32(sq.to(dev)), magnitude.isqrt_u32(sq)),
        "magnitude_u32": (magnitude.magnitude_u32(head), magnitude.magnitude_u32(head_cpu)),
        "slice_bits": (demod.slice_bits(mags, cand), demod.slice_bits(mags_cpu, cand)),
        "slice_bits_sparse_bytes": (demod.slice_bits_sparse_bytes(plane.to(dev), cand[cand < (1 << 16)]),
                                    demod.slice_bits_sparse_bytes(plane, cand[cand < (1 << 16)])),
        "pack_cmp_words_reduce": (demod.pack_cmp_words_reduce(mags), demod.pack_cmp_words_reduce(mags_cpu)),
        "compact_mask": (pipeline.compact_mask(det, 512), pipeline.compact_mask(det.cpu(), 512)),
        "decode_mags_block_r2": (pipeline.to_host(pipeline.decode_mags_block_r2(mags, h_off, 512)),
                                 pipeline.to_host(pipeline.decode_mags_block_r2(mags_cpu, h_off, 512))),
    }
    for tile in (1, 7, 512, 1 << 21):
        pairs[f"compact_detections tile {tile}"] = (demod.compact_detections(det, 256, tile=tile),
                                                    demod.compact_detections(det.cpu(), 256))
    for name, (got, want) in pairs.items():
        got = list(got.values()) if isinstance(got, dict) else got if isinstance(got, tuple) else [got]
        want = list(want.values()) if isinstance(want, dict) else want if isinstance(want, tuple) else [want]
        for g, w in zip(got, want):
            g = torch.as_tensor(g)
            check(g.dtype == torch.as_tensor(w).dtype and torch.equal(g.cpu(), torch.as_tensor(w)),
                  f"{name}: the card's result != the CPU's")
    check(crc.crc_matrix().shape == (88, 24) and crc.syndromes().dtype == np.uint32
          and np.array_equal(np.packbits(crc.bytes_to_bits(np.frombuffer(b"".join(frames), np.uint8)
                                                             .reshape(-1, 14)), axis=-1),
                             np.frombuffer(b"".join(frames), np.uint8).reshape(-1, 14)), "the CRC helpers")
    cfg = config.PipelineConfig(gain_db=40.0, web_port=9000)
    check((cfg.window_len, cfg.halo, cfg.bytes_per_frame) == (demod.WINDOW, demod.WINDOW - 1, 14), "PipelineConfig")
    check(mesh.init_distributed() is None, "init_distributed")

    # The SNR sweep's capture (24,001 samples): its parity decode against
    # the host's share, the pad to a 2^22-sample scan block and the upload.
    sweep_iq = synth.modulate([frames[0]] * 8, [300 + 2925 * i for i in range(8)], 24001, snr_db=10.0, seed=1)
    sweep_cfg = config.PipelineConfig(block_len=24000)

    def upload():
        torch.as_tensor(pipeline.pad_iq_non_detecting(sweep_iq[:24000], 1 << 22)).to(dev)
        torch.cuda.synchronize()

    t_parity, t_upload = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        pipeline.decode_capture_parity(sweep_iq, sweep_cfg, device=dev)
        t_parity.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        upload()
        t_upload.append(time.perf_counter() - t0)
    print(f"snr_sweep's capture (24,001 samples): decode_capture_parity {statistics.median(t_parity) * 1e3:.3f} ms, "
          f"of which the pad to 2^22 samples and its upload {statistics.median(t_upload) * 1e3:.3f} ms "
          f"(host clock, median of 10)")

    with counted() as launches:
        got = pipeline.to_host(pipeline.decode_iq_block_kernel(cap, n_off, CAPACITY))
    check(launches == ONE_PASS, f"decode_iq_block_kernel: not the front and the block decode once each: {launches}")
    check(all(np.array_equal(got[k], out[k]) for k in out) and sorted(got) == sorted(out),
          "decode_iq_block_kernel != decode_iq_block")

    # airjax's calls, as written for airjax: no device, the card by default.
    head_iq = cap[: 1 << 21].cpu().numpy()

    def stream(**kw):
        got = []
        stats = runner.run_stream((head_iq[i : i + 20000] for i in range(0, len(head_iq), 20000)), got.append,
                                  config.DEFAULT_CONFIG, True, 2, **kw)
        return [p.packet for p in got], stats.good

    with counted() as bare_launches:
        bare = pipeline.decode_capture_overlap(head_iq), stream()
    named = pipeline.decode_capture_overlap(head_iq, device="cuda"), stream(device="cuda")
    n_head = sum(o < len(head_iq) - 240 for o in offs)
    check(bare == named, "airjax's calls with no device != the same calls with device='cuda'")
    check(len(bare[0][0]) == n_head and bare[1][1] == n_head,
          f"airjax's calls with no device: {len(bare[0][0])} hits, {bare[1][1]} packets, not the {n_head} embedded")
    check(bare_launches["magdet_bits"] > 0 and bare_launches["block_decode"] > 0,
          f"airjax's calls with no device launched no kernel on the card: {bare_launches}")
    print(f"airjax's calls with no device on {nvidia_smi()}: decode_capture_overlap(iq) and run_stream(blocks, cb, "
          f"DEFAULT_CONFIG, True, 2) == their device='cuda' forms, {n_head} frames each; launches "
          f"{json.dumps({k: v for k, v in bare_launches.items() if v})}")
    print(f"phase 17: {len(pairs)} results of the A16 functions on the card == the CPU's; decode_iq_block_kernel == "
          f"decode_iq_block in {launches['magdet_bits']} + {launches['block_decode']} launches; "
          f"{time.perf_counter() - t_phase:.1f} s")


# Phase 18: the measuring harness (airjax_torch/bench.py, graft_entry.py, the four measuring tools).
HARNESS_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}


def kernel_kind(name: str) -> str:
    """A device event's kernel, by its name: the count-mode front
    (magdet_bits_kernel<G, true>), the bits front, the compaction's two
    kernels, the block decode, or "other"."""
    if "magdet_bits_kernel" in name:
        return "count front" if "true>" in name else "bits front"
    for key, kind in (("compact_scan_kernel", "compaction scan"), ("compact_scatter_kernel", "compaction scatter"),
                      ("block_decode_kernel", "block decode")):
        if key in name:
            return kind
    return "other"


def graph_replay_kernels(bench, step, dev: torch.device, blocks, reps: int,
                         want: dict[str, int]) -> tuple[dict[str, int], list]:
    """The device events of one replay of a graph of `reps` passes of
    `step` under torch.profiler: their count by name, and the events.
    `want` is the kernels a replay runs by kernel_kind, "other" aside; a
    window whose kernels differ from it is profiled again (a lost event;
    PROFILE_TRIES windows, then it fails). The sums the replay left are
    checked against `reps` eager passes."""
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    want_sums = step(blocks, reps, acc).tolist()
    graph = bench.capture(step, blocks, reps, acc)
    acc.zero_()
    graph.replay()
    check(acc.tolist() == want_sums, f"a replay's sums {acc.tolist()} != {reps} eager passes' {want_sums}")
    for _ in range(PROFILE_TRIES):
        names: dict[str, int] = {}
        events = device_events(graph.replay, 1)
        for e in events:
            names[e.name] = names.get(e.name, 0) + 1
        kinds: dict[str, int] = {}
        for name, n in names.items():
            if kernel_kind(name) != "other":
                kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0) + n
        if kinds == want:
            return names, events
        print(f"replay: {json.dumps(kinds)} against {json.dumps(want)} (a lost event or another kernel); again; "
              f"{json.dumps({k[:60]: n for k, n in names.items()})}")
    check(False, f"replay: the kernels of a replay were not {want} in {PROFILE_TRIES} windows")


def phase_harness(dev: torch.device) -> None:
    """Phase 18: airjax_torch.bench.bench() in process at its default size
    (2^24 + 1024 samples, 1024 frames, R = 2 and 42 in CUDA graphs): the
    contract's keys, every frame decoded in every pass, the graph's counts a
    pass == one eager pass's; the launches through the wrappers (the
    warm-up, the two captures, three eager timings of r_big); a profiler
    window over one replay of the r_small graph: r_small fronts, r_small
    block decodes and the sums' 2 * r_small element-wise kernels, nothing
    else. The same bench with n_blocks=2 (the L2 carry-over between
    passes). Then graft_entry and the four measuring tools at small sizes,
    as processes of their own, all at once; each exits 0."""
    from airjax_torch import bench
    from airjax_torch.dsp.demod import WINDOW
    from airjax_torch.pipeline import decode_iq_block

    t_phase = time.perf_counter()
    r_small, r_big = 2, 42
    with counted() as launches:
        result = bench.bench(r_small=r_small, r_big=r_big)
    detail = result["detail"]
    check(set(result) == HARNESS_KEYS and result["metric"] == "iq_throughput_msps" and result["value"] > 0
          and abs(result["vs_baseline"] - result["value"] / 2.0) < 0.1, f"bench: the contract {result}")
    check(detail["frames_decoded_per_pass"] == detail["frames_embedded"] == 1024,
          f"bench: {detail['frames_decoded_per_pass']} frames a pass of {detail['frames_embedded']}")
    passes = 1 + r_small + r_big + 3 * r_big  # warm-up, the two captures, _timed's three eager runs
    check(launches == {**ONE_PASS, "magdet_bits": passes, "block_decode": passes},
          f"bench: the wrappers' launches {launches}, {passes} fronts and block decodes expected")
    blocks, _ = bench.build_workload(BLOCK, 1, device=dev)
    out = decode_iq_block(blocks[0], BLOCK - WINDOW, CAPACITY)
    one = (int(out["n_good"]), int(out["n_detections"]))
    check(one == (detail["frames_decoded_per_pass"], detail["detections_per_pass"]),
          f"bench: the graph's counts a pass {detail['frames_decoded_per_pass'], detail['detections_per_pass']} "
          f"!= one eager pass's {one}")
    names, events = graph_replay_kernels(bench, bench.make_repeat_step(BLOCK, CAPACITY), dev, blocks, r_small,
                                         {"bits front": r_small, "block decode": r_small})
    busy = busy_us(events)
    other = {k: n for k, n in names.items() if kernel_kind(k) == "other"}
    check(sum(other.values()) == 2 * r_small and all("elementwise" in k for k in other),
          f"harness: a replay of {r_small} passes ran other work than the fronts, the block decodes and the "
          f"sums' adds: {json.dumps(names)}")
    del blocks, out
    two = bench.bench(n_blocks=2, r_small=r_small, r_big=r_big)
    # Pass r decodes block r % 2: its frames a pass are the two blocks' mean.
    blocks, _ = bench.build_workload(BLOCK, 2, device=dev)
    goods = [int(decode_iq_block(b, BLOCK - WINDOW, CAPACITY)["n_good"]) for b in blocks]
    del blocks
    check(two["detail"]["frames_decoded_per_pass"] == sum(goods[r % 2] for r in range(r_big)) // r_big,
          f"bench n_blocks=2: {two['detail']}, the blocks' eager passes {goods}")
    for label, res in (("n_blocks=1", result), ("n_blocks=2", two)):
        d = res["detail"]
        print(f"bench {label}: graph {d['seconds_per_pass'] * 1e6:.3f} us/pass, eager "
              f"{d['eager_seconds_per_pass'] * 1e6:.3f} us/pass (graph / eager "
              f"{d['eager_seconds_per_pass'] / d['seconds_per_pass']:.2f}x), fixed {d['fixed_overhead_s'] * 1e6:.1f} "
              f"us; {res['value']} MS/s, {d['decoded_msgs_per_s']} msgs/s")
    print(f"harness: the bench's launches {launches['magdet_bits']} + {launches['block_decode']} through the "
          f"wrappers; a replay of {r_small} passes: {json.dumps({k[:60]: n for k, n in names.items()})}, device "
          f"busy {busy / r_small:.2f} us a pass under the profiler, idle share "
          f"{1 - busy / r_small / (detail['seconds_per_pass'] * 1e6):.3f} of the graph's slope")
    print(f"bench: {json.dumps(result)}")
    tools = "airjax_torch/tools/"
    with tempfile.TemporaryDirectory() as tmp:
        run_tools({
            "graft_entry": ["-m", "airjax_torch.graft_entry"],
            "bench_stream --blocks 4 --block-len 4194304": [tools + "bench_stream.py", "--blocks", "4",
                                                           "--block-len", "4194304"],
            "bench_host --messages 20000": [tools + "bench_host.py", "--messages", "20000"],
            "bench_extended --r-big 6": [tools + "bench_extended.py", "--r-big", "6"],
            "scaling_sweep --one-card --per-device 1000000": [tools + "scaling_sweep.py", "--one-card",
                                                              "--per-device", "1000000"],
        }, dict(os.environ), tmp)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


# Phase 19: the pass's cost by nested prefixes (airjax_torch/tools/bench_stages.py).
# Each stage's wrappers (counted()'s keys) and kernels a pass (kernel_kind's).
STAGE_WRAPPERS = {"detect": ("chunked_count",), "compact": ("magdet_bits", "compact_bits"),
                  "pack": ("magdet_bits", "compact_bits"), "full": ("magdet_bits", "block_decode")}
STAGE_KERNELS = {"detect": {"count front": 1},
                 "compact": {"bits front": 1, "compaction scan": 1, "compaction scatter": 1},
                 "pack": {"bits front": 1, "compaction scan": 1, "compaction scatter": 1},
                 "full": {"bits front": 1, "block decode": 1}}


def phase_stages(dev: torch.device) -> None:
    """Phase 19: the four stages of airjax_torch/tools/bench_stages.py on
    its capture at the full block (2^24 + 1024 samples, K 2048): each
    stage's pair on the card == its plain version's (PLAIN) on the same
    tensor; timed by bench.measure (R = 2 and 12 in CUDA graphs; it raises
    when the graph's sums differ from the eager passes'), the sums r_big
    times the pair, the launches through the wrappers, and one replay of the
    R = 2 graph profiled: detect the count-mode front, compact and pack the
    bits front and the compaction's two kernels, full the bits front and
    the block decode, besides the sums' element-wise and reduce kernels."""
    from airjax_torch import bench
    from airjax_torch.dsp.demod import WINDOW
    from airjax_torch.tools import bench_stages

    t_phase = time.perf_counter()
    r_small, r_big = 2, 12
    n_off = BLOCK - WINDOW
    iq = bench_stages.build_iq(device=dev)
    card = bench.card(dev)
    lines = {}
    for stage, body in bench_stages.STAGES.items():
        one = tuple(int(x) for x in body(iq, n_off, CAPACITY))
        plain = tuple(int(x) for x in bench_stages.PLAIN[stage](iq, n_off, CAPACITY))
        check(one == plain, f"stages: {stage}'s pair {one} on the card != its plain version's {plain}")
        with counted() as launches:
            line = bench_stages.measure_stage(stage, iq, BLOCK, CAPACITY, r_small, r_big, card)
        check(line["sums"] == [r_big * x for x in one], f"stages: {stage}'s sums {line['sums']} != {r_big} x {one}")
        passes = 1 + r_small + r_big + 3 * r_big  # warm-up, the two captures, _timed's three eager runs
        want = {**{k: 0 for k in ONE_PASS}, **{k: passes for k in STAGE_WRAPPERS[stage]}}
        check(launches == want, f"stages: {stage}'s launches {launches} != {want}")
        step = bench.make_repeat_step(BLOCK, CAPACITY, body)
        names, events = graph_replay_kernels(bench, step, dev, (iq,), r_small,
                                             {k: n * r_small for k, n in STAGE_KERNELS[stage].items()})
        other = {k: n for k, n in names.items() if kernel_kind(k) == "other"}
        check(all("elementwise" in k or "reduce_kernel" in k for k in other),
              f"stages: a replay of {stage} ran other work than its kernels and the sums': {json.dumps(names)}")
        kind_us: dict[str, float] = {}
        for e in events:
            kind = kernel_kind(e.name)
            kind_us[kind] = kind_us.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / r_small
        busy = busy_us(events) / r_small
        n_small = sum(other.values()) // r_small
        lines[stage] = line
        print(json.dumps(line))
        print(f"  {stage}: pair {one} == plain; a replay of {r_small} passes: "
              f"{json.dumps({k[:60]: n for k, n in names.items()})}; device us a pass by kernel "
              f"{json.dumps({k: round(v, 3) for k, v in kind_us.items()})} (other: the sums' {n_small} small "
              f"kernels), busy {busy:.3f}, idle share {1 - busy / (line['seconds_per_pass'] * 1e6):.3f} of the "
              f"slope; eager {line['eager_seconds_per_pass'] * 1e6:.3f} us a pass")
    us = {stage: line["seconds_per_pass"] * 1e6 for stage, line in lines.items()}
    print(f"stages, us a pass: {json.dumps(us)}; compact - detect {us['compact'] - us['detect']:.3f}, pack - compact "
          f"{us['pack'] - us['compact']:.3f}, full - compact {us['full'] - us['compact']:.3f}")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")


# The multi-card run (`chip_smoke.py --cards`, a host of 4 or more cards).
# Phase 20: one program a block (pipeline.BlockGraphs), against the eager
# form it replaced in run_stream.
GRAPH_VARIANTS = {  # name -> (decode function name, recover2)
    "decode_iq_block": ("decode_iq_block", False),
    "decode_iq_block --recover2": ("decode_iq_block", True),
    "decode_iq_block_extended": ("decode_iq_block_extended", False),
    "decode_iq_block_with_fields": ("decode_iq_block_with_fields", False),
    "decode_iq_block_extended_with_fields --recover2": ("decode_iq_block_extended_with_fields", True),
}
GRAPH_REPS = 20  # replays and eager passes timed on the 2^24 block


@contextlib.contextmanager
def replayed():
    """pipeline.graph_counts set to 0 on entry; on exit the dict holds the
    first sightings, captures and replays of every BlockGraphs inside."""
    from airjax_torch import pipeline

    pipeline.graph_counts.update(dict.fromkeys(pipeline.graph_counts, 0))
    got: dict[str, int] = {}
    yield got
    got.update(pipeline.graph_counts)


class EagerBlocks:
    """The eager decode that pipeline.BlockGraphs replaced in run_stream,
    behind BlockGraphs' interface, for the A/B in turns: each block staged
    in a pinned buffer, uploaded, the front and the block decode launched
    through the wrappers, an event recorded; each dict entry fetched on a
    copy stream that waits on that event (pipeline.Fetcher)."""

    def __init__(self, decode, *, recover2: bool = False, device="cuda", depth: int = 1):
        from airjax_torch.pipeline import Fetcher

        self.decode = functools.partial(decode, recover2=recover2)
        self.fetcher = Fetcher(device)
        self.eager = self.captures = self.replays = 0

    @property
    def fetches(self) -> int:
        return self.fetcher.fetches

    @property
    def overlapped(self) -> int:
        return self.fetcher.overlapped

    def dispatch(self, iq, n_off: int, capacity: int) -> list:
        staged = self.fetcher.stage(iq)
        block_dev = self.fetcher.upload(staged)
        out = self.decode(block_dev, n_off, capacity)
        self.eager += 1
        return [block_dev, n_off, out, self.fetcher.launched(staged), capacity]

    def fetch(self, slot: list) -> dict:
        return self.fetcher.fetch(slot[2], slot[3])

    def collect(self, slot: list) -> tuple[dict, bool]:
        """BlockGraphs.collect's regrow, from the block's device copy."""
        out = self.fetch(slot)
        overflowed, capacity = bool(out["overflow"]), slot[4]
        while bool(out["overflow"]) and capacity < slot[1]:
            capacity = min(capacity * 4, slot[1])
            regrown = self.decode(slot[0], slot[1], capacity)
            self.fetcher.done(slot[3])
            slot[3] = self.fetcher.launched()
            out = self.fetcher.fetch(regrown, slot[3])
        self.done(slot)
        return out, overflowed

    def done(self, slot: list) -> None:
        self.fetcher.done(slot[3])

    def summary(self) -> dict[str, int]:
        return {"eager": self.eager, "captures": 0, "replays": 0, "pinned_bytes": 0, "device_bytes": 0}


@contextlib.contextmanager
def eager_stream():
    """run_stream decodes through EagerBlocks while the context lasts."""
    from airjax_torch import runner

    saved = runner.BlockGraphs
    runner.BlockGraphs = EagerBlocks
    try:
        yield
    finally:
        runner.BlockGraphs = saved


def same_host_dict(got: dict, want: dict) -> bool:
    """Two host dicts (nested field dicts spread out) equal key by key, dtypes included."""
    got, want = flat(got), flat(want)
    return sorted(got) == sorted(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]) for k in want)


def copy_kind(name: str) -> str:
    low = name.lower().replace(" ", "")
    for kind in ("htod", "dtoh", "dtod"):
        if kind in low:
            return kind
    return "memcpy"


def replay_profile(name: str, fn, want: dict) -> dict[str, int]:
    """One call of fn (a BlockGraphs or StepGraphs dispatch, fetch and
    done) under the profiler -> its device events by kind; the kernels and
    copies `want` counts, nothing else (a window that lost an event is
    profiled again)."""
    for _ in range(PROFILE_TRIES):
        events = device_events(fn, 1)
        kinds: dict[str, int] = {}
        for e in events:
            k = ("front" if "magdet_bits_kernel" in e.name else "block decode" if "block_decode_kernel" in e.name
                 else "gather" if "shard_gather_kernel" in e.name
                 else copy_kind(e.name) if "memcpy" in e.name.lower() else e.name[:60])
            kinds[k] = kinds.get(k, 0) + 1
        if kinds == want:
            us = {e.name[:48]: round(e.time_range.end - e.time_range.start, 3) for e in events}
            print(f"  {name}: {json.dumps(kinds)}; device us {json.dumps(us)}")
            return kinds
        if set(kinds) - set(want):
            check(False, f"{name}: a replay ran other work: {json.dumps(kinds)}")
        print(f"profile, {name}: the profiler dropped events ({json.dumps(kinds)}); again")
    check(False, f"{name}: the profiler dropped events in {PROFILE_TRIES} windows")


BREAKDOWN_BLOCKS = 300  # blocks a step of the dispatch breakdown is timed over


def dispatch_breakdown(dev: torch.device, ext: np.ndarray, ext_dev: torch.Tensor, k: int) -> None:
    """Where a 20,000-sample block's dispatch and fetch go on the host, at
    depth 0 (pipeline.BlockGraphs): each step timed alone, median µs over
    BREAKDOWN_BLOCKS blocks, beside a replay of the graph without the
    upload (upload=False) and the eager wrappers' two launches."""
    from airjax_torch import pipeline
    from airjax_torch.kernels.fields import layout_views

    forms = {}
    for upload, src in ((True, ext), (False, ext_dev)):
        graphs = pipeline.BlockGraphs(pipeline.decode_iq_block, device=dev, depth=0, upload=upload)
        for _ in range(2):  # the first sighting, then the capture
            slot = graphs.dispatch(src, CHUNK, k)
            graphs.fetch(slot)
            graphs.done(slot)
        forms[upload] = graphs
    graphs = forms[True]
    (slot,) = graphs.slots()
    (bare,) = forms[False].slots()
    stream = torch.cuda.current_stream(dev)
    block = torch.from_numpy(ext)
    steps = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps.setdefault(name, []).append((time.perf_counter() - t0) * 1e6)
        return out

    for _ in range(BREAKDOWN_BLOCKS):
        timed("copy in (one memcpy)", lambda: np.copyto(slot.host_iq.numpy(), ext))
        timed("copy in (torch's threaded copy)", lambda: slot.host_iq.copy_(block))
        timed("replay", slot.graph.replay)
        timed("event record", lambda: slot.event.record(stream))
        timed("wait", slot.event.synchronize)
        timed("copy out + views", lambda: layout_views(slot.layout.entries,
                                                       *pipeline._split(slot.host_out.numpy().copy(),
                                                                        slot.layout.n_int)))
        s2 = timed("BlockGraphs.dispatch", lambda: graphs.dispatch(ext, CHUNK, k))
        timed("BlockGraphs.fetch", lambda: graphs.fetch(s2))
        graphs.done(s2)
        timed("replay, no upload node", bare.graph.replay)
        torch.cuda.synchronize()
        timed("eager: the two launches", lambda: pipeline.decode_iq_block(ext_dev, CHUNK, k))
        torch.cuda.synchronize()
    print(f"graphs, a block's host steps at depth 0 (median us of {BREAKDOWN_BLOCKS}): "
          + json.dumps({name: round(statistics.median(t), 3) for name, t in steps.items()}))


def back_to_back_ms(fn) -> float:
    """ms a call of fn over GRAPH_REPS calls back to back between two CUDA
    events, the best of 3 (as bench.py's _timed), after a warm-up call."""
    fn()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPS):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / GRAPH_REPS)
    return best


def stage_ms(stats, stage: str) -> float:
    """Mean ms a call of a run_stream stage, unrounded."""
    return stats.stages.totals[stage] / stats.stages.counts[stage] * 1e3


def phase_graphs(dev: torch.device, stream_capture, block_dev: torch.Tensor, card: str) -> None:
    """Phase 20: run_stream and the overlap scan decode a block by replaying
    one CUDA graph (pipeline.BlockGraphs). (1) One replay of each of the
    five decodes on phase 6's block shape: its dict == the eager wrappers'
    bit for bit, one front and one block-decode launch counted (with F where
    batched), and under the profiler the front, the block decode, the
    block's upload and the dict's one download, nothing else; the overlap
    form (upload=False): a device copy before the replay, then the same.
    (2) Phase 6's 20 M-sample stream through run_stream with the eager form
    (EagerBlocks: the wrappers and pipeline.Fetcher) and with BlockGraphs,
    in turns at depths 0 and 1: the packets the embedded frames, the
    dispatch, fetch and apply ms a block and MS/s. (3) `adsb --playback
    FILE --fast` the same way. (4) Phase 4's 2^24 block: a replay's device
    time (CUDA events) and its kernels' device time (profiler) against an
    eager pass's and bench.measure's graph slope, and the overlap form's
    host time a block. The captures, replays, first sightings and the
    memory the slots hold are printed."""
    from airjax_torch import bench, pipeline
    from airjax_torch.config import DEFAULT_CONFIG
    from airjax_torch.dsp.demod import WINDOW
    from airjax_torch.io.c16 import save_c16
    from airjax_torch.runner import run_stream

    t_phase = time.perf_counter()
    stream_iq, frames = stream_capture
    k = DEFAULT_CONFIG.max_candidates
    # Phase 6's steady block: the carry's 239 samples, then 20,000 fresh.
    ext = np.ascontiguousarray(stream_iq[CHUNK - WINDOW + 1 : 2 * CHUNK])
    ext_dev = torch.as_tensor(ext, device=dev)
    print(f"graphs: {card}; a block {ext.shape[0]} samples, n_off {CHUNK}, capacity {k}")
    for name, (fn_name, r2) in GRAPH_VARIANTS.items():
        fn = getattr(pipeline, fn_name)
        batched = "with_fields" in fn_name
        want = pipeline.to_host(fn(ext_dev, CHUNK, k, recover2=r2))
        for upload in (True, False) if fn_name == "decode_iq_block" and not r2 else (True,):
            graphs = pipeline.BlockGraphs(fn, recover2=r2, device=dev, depth=0, upload=upload)
            src = ext if upload else ext_dev

            def one():
                slot = graphs.dispatch(src, CHUNK, k)
                out = graphs.fetch(slot)
                graphs.done(slot)
                return out

            one()  # the first sighting, eager
            with counted() as n, replayed() as g:
                got = one()  # the capture, then a replay
            check(same_host_dict(got, want), f"graphs, {name}: a replay's dict != the eager wrappers'")
            check(n == (BATCHED_PASS if batched else ONE_PASS) and g == {"eager": 0, "captures": 1, "replays": 1},
                  f"graphs, {name}: a replay counted {n}, {g}")
            copies = {"htod": 1, "dtoh": 1} if upload else {"dtod": 1, "dtoh": 1}
            replay_profile(f"{name}{'' if upload else ', the overlap form'}", one,
                           {"front": 1, "block decode": 1, **copies})
    print("graphs: a replay == the eager wrappers bit for bit in each decode, one front and one block decode "
          "counted, and only those kernels and the copies on the card")
    dispatch_breakdown(dev, ext, ext_dev, k)

    def blocks():
        return (stream_iq[i : i + CHUNK] for i in range(0, STREAM_SAMPLES, CHUNK))

    n_blocks = STREAM_SAMPLES // CHUNK
    rows: dict[tuple[int, str], list] = {}
    for depth in (0, 1):
        for form in ("eager", "graphs", "graphs", "eager"):  # in turns
            got = []
            with (eager_stream() if form == "eager" else contextlib.nullcontext()), counted() as n, \
                    replayed() as g:
                t0 = time.perf_counter()
                stats = run_stream(blocks(), got.append, device=dev, pipeline_depth=depth)
                wall = time.perf_counter() - t0
            check([p.packet for p in got] == frames, f"{form}, depth {depth}: the packets differ")
            check(n["magdet_bits"] == n["block_decode"] == n_blocks
                  and (g["replays"] == 0 if form == "eager" else
                       (g["eager"], g["captures"], g["replays"]) == (1, depth + 1, n_blocks - 1)),
                  f"{form}, depth {depth}: launches {n}, graphs {g}")
            row = (stage_ms(stats, "dispatch"), stage_ms(stats, "fetch"), stage_ms(stats, "apply"),
                   STREAM_SAMPLES / wall / 1e6)
            rows.setdefault((depth, form), []).append(row)
            print(f"graphs A/B, phase 6's stream, {form}, depth {depth}: dispatch {row[0]:.6f} ms, fetch "
                  f"{row[1]:.6f} ms, apply {row[2]:.6f} ms a block, {row[3]:.3f} MS/s ({wall:.3f} s wall); "
                  f"{stats.overlapped} of {stats.fetches} fetches with the next decode pending"
                  + (f"; graphs {json.dumps(stats.graphs)}" if form == "graphs" else ""))
    for depth in (0, 1):
        e, gr = (np.mean(rows[(depth, f)], axis=0) for f in ("eager", "graphs"))
        print(f"graphs A/B, depth {depth}, mean of 2 turns on {card}: dispatch + fetch {e[0] + e[1]:.6f} ms eager, "
              f"{gr[0] + gr[1]:.6f} ms graphs ({(gr[0] + gr[1]) / (e[0] + e[1]):.3f} of eager); "
              f"{e[3]:.3f} MS/s eager, {gr[3]:.3f} MS/s graphs")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.c16")
        save_c16(stream_iq, path)
        want = [f.hex() for f in frames]
        for form in ("eager", "graphs", "graphs", "eager"):  # in turns
            with eager_stream() if form == "eager" else contextlib.nullcontext():
                text, stats, wall = run_cli(["adsb", "--playback", path, "--fast"])
            check(hexes(text) == want, f"adsb, {form}: the packets are not the embedded frames in order")
            st = stats["stages"]
            print(f"graphs A/B, adsb --playback --fast, {form}: {STREAM_SAMPLES / wall / 1e6:.3f} MS/s ({wall:.3f} s "
                  f"wall); dispatch {st['dispatch']['mean_ms']} ms, fetch {st['fetch']['mean_ms']} ms, apply "
                  f"{st['apply']['mean_ms']} ms a block")

    n_off = BLOCK - WINDOW
    graphs = pipeline.BlockGraphs(pipeline.decode_iq_block, device=dev, depth=0, upload=False)
    want = pipeline.to_host(pipeline.decode_iq_block(block_dev, n_off, CAPACITY))

    def overlap_block():
        slot = graphs.dispatch(block_dev, n_off, CAPACITY)
        out = graphs.fetch(slot)
        graphs.done(slot)
        return out

    overlap_block()  # the first sighting
    check(same_host_dict(overlap_block(), want), "graphs, 2^24: a replay's dict != the eager wrappers'")
    (slot,) = graphs.slots()
    replay_ms = back_to_back_ms(slot.graph.replay)
    eager_ms = back_to_back_ms(lambda: pipeline.decode_iq_block(block_dev, n_off, CAPACITY))
    host = []
    for _ in range(GRAPH_REPS):
        t0 = time.perf_counter()
        overlap_block()
        host.append(time.perf_counter() - t0)
    slope = bench.measure(bench.make_repeat_step(BLOCK, CAPACITY), (block_dev,), 2, 42)
    kernels_replay = device_us(slot.graph.replay, PASS_KERNELS)
    kernels_eager = device_us(lambda: pipeline.decode_iq_block(block_dev, n_off, CAPACITY), PASS_KERNELS)
    print(f"graphs, 2^24 block on {card}: a replay {replay_ms * 1e3:.3f} us (the two kernels and the dict's "
          f"download), an eager pass {eager_ms * 1e3:.3f} us ({GRAPH_REPS} back to back between two CUDA events, "
          f"best of 3); bench.measure "
          f"slope {slope['seconds_per_pass'] * 1e6:.3f} us, its eager {slope['eager_seconds_per_pass'] * 1e6:.3f} us "
          f"a pass; the two kernels' device time {kernels_replay:.3f} us in a replay, {kernels_eager:.3f} us eager "
          f"(profiler); the overlap form {statistics.median(host) * 1e3:.6f} ms a block on the host (device copy, "
          f"replay, fetch; median of {GRAPH_REPS})")
    print(f"graphs: the 2^24 slot holds {slot.device_bytes} bytes on the card and {slot.pinned_bytes} pinned; "
          f"phase 20 {time.perf_counter() - t_phase:.1f} s")


# Phase 21: one program a sharded step (parallel/halo.py::StepGraphs), against
# the eager step it replaced in run_stream_sharded on one card.
STEP_VARIANTS = {  # name -> (extended, recover2, with_fields)
    "DF17": (False, False, False),
    "DF17 --recover2": (False, True, False),
    "DF17 batched (F)": (False, False, True),
    "extended": (True, False, False),
    "extended batched --recover2 (F)": (True, True, True),
}
STEP_KERNELS = ("magdet_bits_kernel", "block_decode_kernel", "shard_gather_kernel")


@contextlib.contextmanager
def step_replayed():
    """halo.step_graph_counts set to 0 on entry; on exit the dict holds the
    first sightings, captures and replays of every StepGraphs inside."""
    from airjax_torch.parallel import halo

    halo.step_graph_counts.update(dict.fromkeys(halo.step_graph_counts, 0))
    got: dict[str, int] = {}
    yield got
    got.update(halo.step_graph_counts)


@contextlib.contextmanager
def eager_steps():
    """run_stream_sharded launches its steps eagerly on one card while the
    context lasts: halo.EagerSteps, the form a mesh over several cards
    keeps, is the step StepGraphs replaced (staged, uploaded shard by shard,
    launched through the wrappers, fetched in two copies, pipeline.Fetcher)."""
    from airjax_torch.parallel import halo

    saved = halo.StepGraphs
    halo.StepGraphs = halo.EagerSteps
    try:
        yield
    finally:
        halo.StepGraphs = saved


def phase_step_graphs(dev: torch.device, stream_capture, tracker_iq: np.ndarray, card: str) -> None:
    """Phase 21: run_stream_sharded on one card decodes a step by replaying
    one CUDA graph (halo.StepGraphs). (1) One replay of each step variant
    (DF17, --recover2, batched with the gather's F, extended, extended
    batched --recover2) on phase 14's step shape (block 20,240, K 256, C 256
    or 512), on 4 shards of the card and on make_mesh(1), on a step of the
    tracker traffic: its dict == the eager step's bit for bit, D fronts, D
    block decodes and one gather (F where batched) counted, and under the
    profiler one upload, those kernels and one download, nothing else; for
    the DF17 step on 4 shards a replay's time and its kernels' device time
    against the eager step's. (2) Phase 14's sharded stream (BatchTracker,
    the tracker traffic's first PIPE_SAMPLES) at depths 0 and 1 and phase
    11's three (BatchTracker, --recover2, ExtendedBatchTracker on
    ANALYTICS_SAMPLES, depth 1), on 4 shards of the card, with the eager
    step (halo.EagerSteps) and with the graphs in turns: tables ==
    run_stream's, dispatch, fetch and apply ms a step, MS/s, the slots'
    bytes. (3) `adsb --playback FILE --fast --devices 1` on phase 6's
    stream the same way."""
    from airjax_torch import pipeline
    from airjax_torch.config import DEFAULT_CONFIG
    from airjax_torch.io.c16 import save_c16
    from airjax_torch.parallel import halo
    from airjax_torch.parallel.mesh import Mesh, make_mesh
    from airjax_torch.runner import run_stream, run_stream_sharded
    from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker

    t_phase = time.perf_counter()
    block = halo.tuned_block(max(16384, DEFAULT_CONFIG.block_len))
    k = DEFAULT_CONFIG.max_candidates
    print(f"step graphs: {card}; a shard {block} samples (halo {halo._halo_size(block)}), K {k}")
    for mesh_name, mesh in (("4 shards of the card", Mesh([dev] * SHARDS)), ("make_mesh(1)", make_mesh(1, device=dev))):
        d = mesh.size
        n = d * block
        step_iq = np.ascontiguousarray(tracker_iq[:n])
        step_dev = torch.as_tensor(step_iq, device=dev)
        for name, (ext, r2, with_fields) in STEP_VARIANTS.items():
            c = max(512 if ext else 128, k)
            eager = halo._compact_builder(ext)(mesh, n, k, c, with_fields=with_fields, recover2=r2)
            want = pipeline.to_host(eager(step_dev))
            steps = halo.StepGraphs(mesh, block, k, c, extended=ext, recover2=r2, with_fields=with_fields, depth=0)

            def one():
                slot = steps.dispatch(step_iq)
                out = steps.fetch(slot)
                steps.done(slot)
                return out

            one()  # the first sighting, eager
            with counted() as cnt, step_replayed() as g:
                got = one()  # the capture, then a replay
            label = f"step graphs, {name}, {mesh_name}"
            check(int(want["n_candidates" if ext else "n_good"]) > 0, f"{label}: the step holds no frame")
            check(same_host_dict(got, want), f"{label}: a replay's dict != the eager step's")
            check(cnt == {**ONE_PASS, "magdet_bits": d, "block_decode": d, "shard_gather": 1,
                          "shard_gather_fields": int(with_fields)}
                  and g == {"eager": 0, "captures": 1, "replays": 1}, f"{label}: a replay counted {cnt}, {g}")
            replay_profile(label, one, {"front": d, "block decode": d, "gather": 1, "htod": 1, "dtoh": 1})
            (slot,) = steps.slots()
            print(f"  {label}: a slot downloads {slot.out.numel()} bytes (C {c}); holds {slot.pinned_bytes} pinned, "
                  f"{slot.device_bytes} on the card")
            if name == "DF17" and d == SHARDS:
                replay_ms = back_to_back_ms(slot.graph.replay)
                eager_ms = back_to_back_ms(lambda: eager(step_dev))
                kernels_replay = device_us(slot.graph.replay, STEP_KERNELS)
                kernels_eager = device_us(lambda: eager(step_dev), STEP_KERNELS)
                print(f"step graphs, DF17 step on {mesh_name} ({card}): a replay {replay_ms * 1e3:.3f} us (upload, "
                      f"kernels, download), the eager step {eager_ms * 1e3:.3f} us ({GRAPH_REPS} back to back between "
                      f"two CUDA events, best of 3); the kernels' device time {kernels_replay:.3f} us in a replay, "
                      f"{kernels_eager:.3f} us eager (profiler; {kernels_replay / kernels_eager:.4f} of eager)")
    print("step graphs: a replay == the eager step bit for bit in each variant, D fronts, D block decodes and one "
          "gather counted, and only those kernels and the two copies on the card")

    def chunks(n_samples):
        return lambda: (tracker_iq[i : i + CHUNK] for i in range(0, n_samples, CHUNK))

    mesh4 = Mesh([dev] * SHARDS)
    rows: dict[tuple[str, int, str], list] = {}
    for label, n_samples, make, kw, depths in (
            ("phase 14's BatchTracker", PIPE_SAMPLES, BatchTracker, {}, (0, 1)),
            ("phase 11's BatchTracker", ANALYTICS_SAMPLES, BatchTracker, {}, (1,)),
            ("phase 11's BatchTracker --recover2", ANALYTICS_SAMPLES, BatchTracker, {"recover2": True}, (1,)),
            ("phase 11's ExtendedBatchTracker", ANALYTICS_SAMPLES, ExtendedBatchTracker, {"extended": True}, (1,))):
        ext = kw.get("extended", False)
        single = make()
        run_stream(chunks(n_samples)(), single, device=dev, **kw)
        want = table_view(single.aircrafts, ext)
        for depth in depths:
            for form in ("eager", "graphs", "graphs", "eager"):  # in turns
                sink = make()
                with (eager_steps() if form == "eager" else contextlib.nullcontext()), counted() as n, \
                        step_replayed() as g:
                    t0 = time.perf_counter()
                    stats = run_stream_sharded(chunks(n_samples)(), sink, mesh=mesh4, pipeline_depth=depth, **kw)
                    wall = time.perf_counter() - t0
                name = f"{label}, {form}, depth {depth}"
                check(same_table(table_view(sink.aircrafts, ext), want), f"{name}: the table != run_stream's")
                check(n["shard_gather"] == n["shard_gather_fields"] > 0 and n["fields"] == 0
                      and n["magdet_bits"] == n["block_decode"] == SHARDS * n["shard_gather"],
                      f"{name}: not a front and a block decode a shard and a gather with F a step: {n}")
                check(g == {"eager": 0, "captures": 0, "replays": 0} if form == "eager" else
                      (g["eager"] >= 1 and g["replays"] > 0 and g["eager"] + g["replays"] == stats.blocks + 1),
                      f"{name}: graphs {g} for {stats.blocks} steps and the warm-up")
                row = (stage_ms(stats, "dispatch"), stage_ms(stats, "fetch"), stage_ms(stats, "apply"),
                       n_samples / wall / 1e6)
                rows.setdefault((label, depth, form), []).append(row)
                print(f"step graphs A/B, {name}: dispatch {row[0]:.6f} ms, fetch {row[1]:.6f} ms, apply "
                      f"{row[2]:.6f} ms a step, {row[3]:.3f} MS/s ({wall:.3f} s wall, {stats.blocks} steps, "
                      f"{stats.overflow_blocks} regrown); {stats.overlapped} of {stats.fetches} fetches with the next "
                      f"step pending; graphs {json.dumps(stats.graphs)}")
            e, gr = (np.mean(rows[(label, depth, f)], axis=0) for f in ("eager", "graphs"))
            print(f"step graphs A/B, {label}, depth {depth}, mean of 2 turns on {card}: dispatch + fetch "
                  f"{e[0] + e[1]:.6f} ms eager, {gr[0] + gr[1]:.6f} ms graphs ({(gr[0] + gr[1]) / (e[0] + e[1]):.3f} "
                  f"of eager); apply {e[2]:.6f} / {gr[2]:.6f} ms; {e[3]:.3f} MS/s eager, {gr[3]:.3f} MS/s graphs")

    stream_iq, frames = stream_capture
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.c16")
        save_c16(stream_iq, path)
        want = [f.hex() for f in frames]
        for form in ("eager", "graphs", "graphs", "eager"):  # in turns
            with (eager_steps() if form == "eager" else contextlib.nullcontext()), step_replayed() as g:
                text, stats, wall = run_cli(["adsb", "--playback", path, "--fast", "--devices", "1"])
            check(hexes(text) == want, f"adsb --devices 1, {form}: the packets are not the embedded frames in order")
            check((g["replays"] == 0) == (form == "eager"), f"adsb --devices 1, {form}: graphs {g}")
            st = stats["stages"]
            print(f"step graphs A/B, adsb --playback --fast --devices 1, {form}: {STREAM_SAMPLES / wall / 1e6:.3f} "
                  f"MS/s ({wall:.3f} s wall); dispatch {st['dispatch']['mean_ms']} ms, fetch {st['fetch']['mean_ms']} "
                  f"ms, apply {st['apply']['mean_ms']} ms a step; graphs {json.dumps(g)}")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")


def packet_view(packet) -> tuple:
    """A packet's class and fields but its wall-clock stamp."""
    import dataclasses

    fields = dataclasses.asdict(packet)
    return type(packet).__name__, {k: v for k, v in fields.items() if not (isinstance(v, float) and v >= 1e9)}


def phase_multicard(dev: torch.device, capture) -> None:
    """The mesh paths across cards: decode_capture_sharded(_extended) and
    run_stream_sharded (per packet, BatchTracker, ExtendedBatchTracker) on
    make_mesh(4), one shard a card (the shards' dicts reach card 0 by peer
    copies), against Mesh([card 0] * 4): hits, packets, tables and stats
    equal; the MS/s of both, host included, in turns."""
    from airjax_torch.parallel import halo
    from airjax_torch.parallel.mesh import Mesh, make_mesh
    from airjax_torch.runner import run_stream_sharded
    from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker

    iq, offsets, frames = capture
    meshes = {"make_mesh(4)": make_mesh(4), "Mesh([card 0] * 4)": Mesh([dev] * 4)}
    for extended in (False, True):
        decode = halo.decode_capture_sharded_extended if extended else halo.decode_capture_sharded
        kw = dict(capacity_per_shard=1 << 15) if extended else dict(capacity_per_shard=CAPACITY,
                                                                    compact_capacity=2 * SHARD_FRAMES)
        got, walls = {}, {name: [] for name in meshes}
        for name in (*meshes, *reversed(meshes)):  # in turns: a b b a
            t0 = time.perf_counter()
            result, stats = decode(iq, meshes[name], **kw)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            view = [(o, repr(p)) for o, p in result] if extended else result
            check(got.setdefault(name, (view, stats)) == (view, stats), f"{name}: two runs differ")
        a, b = got.values()
        check(a == b, f"decode_capture_sharded{'_extended' if extended else ''}: make_mesh(4) != 4 shards of card 0")
        long = [o for o, r in a[0] if r.startswith("AdsbPacket(")] if extended else [h[1] for h in a[0]]
        check(long == offsets.tolist(), "the multi-card decode lost an embedded frame")
        print(f"decode_capture_sharded{'_extended' if extended else ''}: make_mesh(4) == Mesh([card 0] * 4), "
              f"hits and stats {json.dumps(a[1])}; " + ", ".join(
                  f"{name} {SHARD_SAMPLES / min(w) / 1e6:.1f} MS/s (walls {', '.join(f'{x:.3f}' for x in w)} s)"
                  for name, w in walls.items()))

    sub = iq[:ANALYTICS_SAMPLES]
    for sink_name, make, extended in (("per packet", list, False), ("per packet", list, True),
                                      ("BatchTracker", BatchTracker, False),
                                      ("ExtendedBatchTracker", ExtendedBatchTracker, True)):
        tables, walls = {}, {}
        for name, mesh in meshes.items():
            sink = make()
            t0 = time.perf_counter()
            stats = run_stream_sharded((sub[i : i + CHUNK] for i in range(0, len(sub), CHUNK)),
                                       sink.append if isinstance(sink, list) else sink, mesh=mesh,
                                       extended=extended).as_dict()
            walls[name] = time.perf_counter() - t0
            table = ([packet_view(p) for p in sink] if isinstance(sink, list)
                     else table_view(sink.aircrafts, extended))
            tables[name] = (table, {k: v for k, v in stats.items() if k not in ("stages", "msamples_per_s")})
        (ta, sa), (tb, sb) = tables.values()
        check(sa == sb and (ta == tb if isinstance(ta, list) else same_table(ta, tb)),
              f"run_stream_sharded, {sink_name}{', extended' if extended else ''}: the meshes differ")
        print(f"run_stream_sharded, {sink_name}{', extended' if extended else ''}: make_mesh(4) == "
              f"Mesh([card 0] * 4) ({len(ta)} {'packets' if isinstance(ta, list) else 'aircraft'}); " + ", ".join(
                  f"{name} {ANALYTICS_SAMPLES / w / 1e6:.1f} MS/s" for name, w in walls.items()))


def cards_main() -> int:
    """`chip_smoke.py --cards`: on a host of 4 or more cards, phase 12 (with
    NCCL across 4 cards) and the mesh paths across cards, nothing else."""
    check(torch.cuda.is_available() and torch.cuda.device_count() >= 4, "--cards needs 4 or more cards")
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    dev = torch.device("cuda", 0)
    capture = sharded_capture(60)
    phase_multicard(dev, capture)
    from airjax_torch.parallel.mesh import make_mesh
    from airjax_torch.tools.dryrun_multichip import dryrun_multichip

    print(dryrun_multichip(make_mesh(4))[:400])
    multi = phase_multihost(dev, capture)
    print(f"chip_smoke --cards: {time.perf_counter() - t_start:.1f} s, the build included; launches "
          f"{json.dumps(multi)}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--multihost-rank"]:
        return multihost_worker(sys.argv[2:])
    if sys.argv[1:] == ["--cards"]:
        return cards_main()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import airjax_torch  # noqa: F401  (fails outside a checkout of the repository)
    from airjax_torch.dsp.demod import WINDOW
    from airjax_torch.io import synth

    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the CRC products stay f32

    rng = np.random.default_rng(0)
    n_off = BLOCK - WINDOW
    offsets = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, size=1024, replace=False))
    frames = make_frames(len(offsets), 1)
    t0 = time.perf_counter()
    block = synth.modulate(frames, list(map(int, offsets)), BLOCK + HALO, noise_std=60.0, seed=0)
    block_dev = torch.as_tensor(block).to(dev)
    ext_block, ext_offsets, ext_frames, _ = mixed_capture(1024, BLOCK + HALO, BLOCK, 30)
    ext_block_dev = torch.as_tensor(ext_block).to(dev)
    capacity = ext_capacity(ext_block_dev, n_off)
    r2_block, r2_frames, r2_offsets, r2_flipped = recover2_block(2)
    r2_block_dev = torch.as_tensor(r2_block).to(dev)
    print(f"blocks: {BLOCK + HALO} samples, {len(frames)} DF17 frames; {len(ext_frames)} frames of "
          f"every format, extended capacity {capacity}; {len(r2_frames)} DF17 frames, {len(r2_flipped)} with a "
          f"2-bit flip; made in {time.perf_counter() - t0:.2f} s")

    kernels, (planes_err, baseline_err), front_launches, chain_fields = phase_kernels(
        block_dev, ext_block_dev, capacity, r2_block_dev)
    phase_block(block_dev, frames, offsets)
    phase_recover2_block(r2_block_dev, r2_frames, r2_offsets, r2_flipped)
    launches = phase_block_ab(block_dev, ext_block_dev, capacity)
    ab = phase_planes_ab(block_dev)
    df17, stream_capture = phase_stream(dev)
    phase_extended_block(ext_block_dev, capacity, ext_frames, ext_offsets)
    ext = phase_extended_stream(dev)
    tracker, tracker_iq = phase_tracker_stream(dev)
    t0 = time.perf_counter()
    capture = sharded_capture(60)
    print(f"sharded capture: {SHARD_SAMPLES} samples, {len(capture[2])} DF17 frames, {SHARDS - 1} at the edges of "
          f"{SHARDS} shards (padded and not), one ending at the capture's end; made in "
          f"{time.perf_counter() - t0:.2f} s")
    sharded_entries, sharded = phase_sharded(dev, tracker_iq, capture)
    kernels += sharded_entries
    multi = phase_multihost(dev, capture)
    del capture
    oracle, count_row = phase_oracle(dev, tracker_iq)
    kernels.append(count_row)
    phase_pipelined(dev, stream_capture, block, frames, tracker_iq)
    phase_graphs(dev, stream_capture, block_dev, card)
    phase_step_graphs(dev, stream_capture, tracker_iq, card)
    del stream_capture
    phase_live(dev, tracker_iq)
    phase_tools()
    phase_sweeps()
    phase_names(dev, frames, offsets)
    phase_harness(dev)
    phase_stages(dev)
    launches.update({**df17, **ext, **tracker, "block_decode": df17["block_decode"] + ext["block_decode"],
                     "magdet_front": front_launches["df17"], "magdet_front_preamble": front_launches["preamble"],
                     **sharded, "shard_gather": sharded["shard_gather"] + df17["shard_gather"] + multi["shard_gather"],
                     "fields_extended": multi["fields_extended"],
                     "chunked_detection_count": oracle["chunked_detection_count"]})
    paths = {"magdet_bits": "adsb stream", "magdet_bits_preamble": "adsb --extended stream",
             "block_decode": "adsb stream + adsb --extended stream",
             "compact_bits": "block A/B, staged chain (DF17 + extended)",
             "candidate_crc": "block A/B, staged chain (DF17)", "candidate_extended": "block A/B, staged chain (extended)",
             "magdet_front": "phase 3 oracle checks (DF17 gate); no decode path launches it",
             "magdet_front_preamble": "phase 3 oracle checks (preamble gate)",
             "block_decode_r2": "tracker stream, per-packet table --recover2",
             "block_decode_extended_r2": "tracker stream, per-packet extended table --recover2",
             "block_decode_fields": "tracker stream, BatchTracker",
             "block_decode_r2_fields": "tracker stream, BatchTracker --recover2",
             "block_decode_extended_fields": "tracker stream, ExtendedBatchTracker",
             "block_decode_extended_r2_fields": "tracker stream, ExtendedBatchTracker --recover2",
             "fields": "phase 11: analyze_capture (overlap and devices=1)",
             "fields_extended": "phase 12: multihost decode_capture_extended_batched, every rank and one process",
             "shard_gather_fields": "phase 11: run_stream_sharded --batched (BatchTracker, BatchTracker --recover2, "
                                    "ExtendedBatchTracker), a launch a step",
             "chunked_detection_count": "phase 13: decode_capture_parity(fused=True), one launch a capture",
             "shard_gather": "phase 11: decode_capture_sharded(_extended) on 4 shards and make_mesh(1), "
                             "analyze_capture(devices=1), analyze_capture_extended, the sharded batched streams; "
                             "phase 6: adsb --devices 1; phase 12: multihost decode_capture(_extended, "
                             "_extended_batched), every rank of gloo and NCCL and one process"}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["path"] = paths[k["name"]]
    at = [k["name"] for k in kernels].index("magdet_front_preamble") + 1
    kernels[at:at] = planes_rows(ab, planes_err, baseline_err, block_dev.shape[0], n_off)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # reported, then the same exit as a success's
        import traceback

        traceback.print_exc()
        code = 1
    # With TEARDOWN_CUPTI=1, a process that exits right after its last
    # profiler window hangs in CUPTI's teardown (measured: a bare
    # torch.profiler window on the card, then exit, hung past 60 s; the same
    # without the variable, or with more work after the window, exited). The
    # script has closed what it opened and reaped its workers by here.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
