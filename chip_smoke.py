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
     against the old front's mask packed; the old front in both modes with
     both gates (DF17, preamble only); the three stencil variants (tree32,
     tree16, flat16) against their plain versions and against the flat
     front; all on int16 extremes, small-range noise (ties and detections
     at every tile edge), the ragged lengths 20239 / 65536+777 / 2^22+13,
     the block of phase 4, and three of these from a base 4 bytes past a
     16-byte boundary; the compaction kernel against its plain version on
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
     each and no other kernel; kernel path and plain path timed (median of
     CUDA-event passes), then profiled (torch.profiler, 10 passes each,
     counted by the block-decode kernel): device time per kernel and per
     pass, the busy time against this run's CUDA-event pass time, the
     front kernel's bytes moved per second, and a kernel-path pass that
     runs those two kernels, at most one memset and nothing else;
  5. two A/Bs in turns, in one run: the block pass through the staged
     chain (front, compaction and candidate kernels, dict ops) against the
     front and the block-decode kernel, for the DF17 and the extended
     block (pass time, device busy time, idle share); and the
     front-stencil A/B (airjax's tools/bench_stencil3.py, the path the
     stencil variants serve): tree32, tree16 and flat16 against the flat
     front in mode planes on the 2^24-sample block;
  6. a 20 M-sample (10 s at 2 MS/s) capture with ~600 frames, some
     straddling the 20,000-sample chunk edges and some corrupted, replayed
     through the CLI (`adsb --playback FILE --fast`): overlap mode emits
     every frame once, in order; --no-overlap loses the straddlers; both
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
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BLOCK = 1 << 24
HALO = 1024
CAPACITY = 2048
CHUNK = 20000
STREAM_SAMPLES = 20_000_000  # 10 s at 2 MS/s
EXT_STREAM_SAMPLES = 4_000_000  # 2 s at 2 MS/s
VARIANTS = ("tree32", "tree16", "flat16")


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


def device_us(fn, names: tuple[str, ...] = (), calls: int = 10) -> float:
    """Device µs per call of fn under torch.profiler: the kernels whose name
    holds one of `names` (every kernel if none), over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and (not names or any(n in e.name for n in names)))
    return total / calls


def library_call():
    """The one PyTorch call that computes the compaction, the yardstick
    `library_ms` (the port never calls it): nonzero_static where this
    torch has it, else nonzero."""
    if hasattr(torch, "nonzero_static"):
        return "torch.nonzero_static", lambda det, k, n_off: torch.nonzero_static(det, size=k, fill_value=n_off)
    return "torch.nonzero", lambda det, k, n_off: torch.nonzero(det)


def check_fronts(cases: list[torch.Tensor]) -> tuple[dict, dict, dict, dict]:
    """The old front (both modes, both gates), the bit-emitting front (both
    gates; against its plain version and against the old front's mask
    packed) and the stencil variants, on every case -> max abs errors, and
    the old front's launches by gate."""
    from airjax_torch.dsp.demod import pack_msb_words
    from airjax_torch.kernels import magdet as magdet_mod
    from airjax_torch.kernels.magdet import (
        GATES, magdet, magdet_bits, magdet_bits_plain, magdet_plain, n_det_words, tile_counts)
    from airjax_torch.kernels.stencil3 import magdet_tree, magdet_tree_plain

    front_err = dict.fromkeys(GATES, 0)
    bits_err = dict.fromkeys(GATES, 0)
    tree_err = dict.fromkeys(VARIANTS, 0)
    front_launches = dict.fromkeys(GATES, 0)
    for iq in cases:
        n_off = iq.shape[0] - 240
        for gate in GATES:
            before = magdet_mod.launches
            for packed in (True, False):
                got = magdet(iq, n_off, packed=packed, gate=gate)
                want = magdet_plain(iq, n_off, packed=packed, gate=gate)
                front_err[gate] = max(front_err[gate], max_abs_err(zip(got, want)))
            det_old, words_old = magdet(iq, n_off, gate=gate)
            old = (pack_msb_words(det_old, n_det_words(n_off)), words_old, tile_counts(det_old))
            got = magdet_bits(iq, n_off, gate)
            err = max(max_abs_err(zip(got, magdet_bits_plain(iq, n_off, gate))), max_abs_err(zip(got, old)))
            bits_err[gate] = max(bits_err[gate], err)
            front_launches[gate] += magdet_mod.launches - before
        flat = magdet(iq, n_off, packed=False)
        for v in VARIANTS:
            got = magdet_tree(iq, n_off, v)
            err = max(max_abs_err(zip(got, magdet_tree_plain(iq, n_off, v))), max_abs_err(zip(got, flat)))
            tree_err[v] = max(tree_err[v], err)
    torch.cuda.synchronize()
    check(not any(front_err.values()), f"front kernel disagrees with plain (max abs err {front_err})")
    check(not any(bits_err.values()), f"bit-emitting front disagrees (max abs err {bits_err})")
    check(not any(tree_err.values()), f"a stencil variant disagrees (max abs err {tree_err})")
    misaligned = sum(1 for iq in cases if iq.data_ptr() % 16)
    print(f"front kernel == plain on {len(cases)} inputs ({misaligned} at a 4-byte but not 16-byte aligned base), "
          f"both modes, both gates; the bit-emitting front == its plain version == the front's mask packed, "
          f"both gates; tree32, tree16, flat16 == plain == flat front on the same inputs")
    return front_err, bits_err, tree_err, front_launches


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
    block_dev: torch.Tensor, ext_block_dev: torch.Tensor, capacity_ext: int
) -> tuple[list[dict], dict[str, int], dict[str, int]]:
    """Phase 3 -> the kernel table's entries of the decode paths, the
    stencil variants' max abs errors, and the old front's launches by gate."""
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
    front_err, bits_err, tree_err, front_launches = check_fronts(cases)
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
        "magdet_front_planes": (lambda: magdet(block_dev, n_off, packed=False),
                                lambda: magdet_plain(block_dev, n_off, packed=False), None, ("magdet_kernel",),
                                front_work(L, n_off, "df17", n_off + L - 1)),
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
    }
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
        print(f"{name}: kernel {k_ms:.4f} ms by events, {dev_us:.2f} us device; plain {p_ms:.4f} ms; "
              + (f"{lib_name} {l_ms:.4f} ms, {rows[name]['library_device_us']:.2f} us device; " if library else "")
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
    ]
    return entries, tree_err, front_launches


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
    check(launches == {"magdet_bits": 1, "block_decode": 1, "compact_bits": 0, "candidate": 0, "magdet_front": 0},
          f"the block did not run the front and block-decode kernels once each, and nothing else: {launches}")
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


@contextlib.contextmanager
def counted():
    """Every kernel wrapper's launch count set to 0 on entry; on exit the
    dict holds the launches made inside."""
    from airjax_torch.kernels import block_decode, candidate, compact, magdet

    magdet.launches = magdet.bits_launches = block_decode.launches = compact.launches = candidate.launches = 0
    got: dict[str, int] = {}
    yield got
    got.update(magdet_bits=magdet.bits_launches, block_decode=block_decode.launches,
               compact_bits=compact.launches, candidate=candidate.launches, magdet_front=magdet.launches)


def device_profile(fn, marker: str, passes: int = 10) -> tuple[dict[str, float], float, int, dict[str, float]]:
    """torch.profiler over `passes` calls of fn: device µs per pass by
    kernel name, the device's busy µs per pass (union of the device
    intervals), the passes it recorded: the count of the kernel named by
    `marker`, which fn launches once (the profiler can lose whole passes),
    and the launches per pass by kernel name; ({}, 0.0, 0, {}) if it
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = sum(marker in e.name for e in events)
    if not seen:
        return {}, 0.0, 0, {}
    per_kernel: dict[str, float] = {}
    per_pass: dict[str, float] = {}
    for e in events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / seen
        per_pass[e.name] = per_pass.get(e.name, 0.0) + 1 / seen
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return per_kernel, busy / seen, seen, per_pass


# The kernel once a pass by which the profiler's passes are counted: the
# block-decode kernel on the kernel path, the compaction kernel's scan on
# the staged chain, the plain compaction's searchsorted on the plain path.
KERNEL_MARKER = "block_decode_kernel"
STAGED_MARKER = "compact_scan_kernel"
PLAIN_MARKER = "searchsorted"
PASS_KERNELS = ("magdet_bits_kernel", "block_decode_kernel")  # a kernel-path pass, one launch each


def profile_pass(name: str, fn, pass_us: float, n_samples: int, n_off: int, kernel_path: bool) -> None:
    """Where one block decode's device time goes: device time per kernel
    and the busy time per pass under torch.profiler, against the pass time
    that CUDA events measured just before without it. On the kernel path,
    also that the pass ran the front and block-decode kernels once each, at
    most one memset, and nothing else."""
    per_kernel, busy, seen, per_pass = device_profile(fn, KERNEL_MARKER if kernel_path else PLAIN_MARKER)
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
        other = [k for k in per_pass if "memset" not in k.lower() and not any(m in k for m in PASS_KERNELS)]
        once = all(round(sum(n for k, n in per_pass.items() if m in k), 6) == 1 for m in PASS_KERNELS)
        check(once and memsets <= 1 and not other,
              f"{name}: a pass should run {PASS_KERNELS} once each, at most one memset, and nothing else: "
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


def phase_stencil_ab(block_dev: torch.Tensor) -> dict[str, tuple[float, float, int]]:
    """The front-stencil A/B on the 2^24-sample block, in turns (flat,
    tree32, tree16, flat16, then the reverse), each a median of CUDA-event
    passes; the variants' plain versions after. Returns per variant
    (kernel ms, plain ms, launches in the A/B, device µs)."""
    from airjax_torch.kernels import stencil3
    from airjax_torch.kernels.magdet import magdet

    n_off = BLOCK - 240
    order = ("flat",) + VARIANTS
    runs: dict[str, list[float]] = {name: [] for name in order}
    stencil3.launches = 0
    launches = dict.fromkeys(VARIANTS, 0)
    for name in order + order[::-1]:
        before = stencil3.launches
        if name == "flat":
            runs[name].append(cuda_ms(lambda: magdet(block_dev, n_off, packed=False)))
        else:
            runs[name].append(cuda_ms(lambda: stencil3.magdet_tree(block_dev, n_off, name)))
            launches[name] += stencil3.launches - before
    ms = {name: statistics.mean(v) for name, v in runs.items()}
    plain = {v: cuda_ms(lambda: stencil3.magdet_tree_plain(block_dev, n_off, v)) for v in VARIANTS}
    print("stencil A/B (2^24 samples, mode planes, two turns each): "
          + ", ".join(f"{name} {ms[name]:.4f} ms ({' / '.join(f'{t:.4f}' for t in runs[name])})" for name in order))
    print("stencil variants, plain: " + ", ".join(f"{v} {plain[v]:.4f} ms" for v in VARIANTS))
    # Device time alone (no host launch cost), one kernel per call.
    device = {}
    for name in order:
        fn = (lambda: magdet(block_dev, n_off, packed=False)) if name == "flat" else (
            lambda: stencil3.magdet_tree(block_dev, n_off, name))
        before = stencil3.launches
        per_kernel, _, _, _ = device_profile(fn, "magdet")
        if name != "flat":
            launches[name] += stencil3.launches - before
        device[name] = max(per_kernel.values(), default=float("nan"))
    moved = 4 * block_dev.shape[0] + n_off + block_dev.shape[0] - 1  # IQ in, det and cmp out
    print("stencil A/B, device time (profiler, 10 calls): " + ", ".join(
        f"{name} {device[name]:.2f} us ({moved / device[name] / 1e3:.1f} GB/s)" for name in order))
    return {v: (ms[v], plain[v], launches[v], device[v]) for v in VARIANTS}


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
    check(launches == {"magdet_bits": 1, "block_decode": 1, "compact_bits": 0, "candidate": 0, "magdet_front": 0},
          f"the extended block did not run the front and block-decode kernels once each: {launches}")
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
          and n["compact_bits"] == n["candidate"] == n["magdet_front"] == 0,
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


def run_cli(argv: list[str]) -> tuple[str, dict, float]:
    """The CLI's standard output, its final stats and its wall time."""
    from airjax_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} returned {rc}")
    text = buf.getvalue()
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
        with counted() as n:
            text, stats, wall = run_cli(["adsb", "--playback", path, "--fast"])
        got = hexes(text)
        check(min(n["magdet_bits"], n["block_decode"]) > 0
              and n["compact_bits"] == n["candidate"] == n["magdet_front"] == 0,
              f"the stream did not run the front and block-decode kernels alone: {n}")
        launches = {"magdet_bits": n["magdet_bits"], "block_decode": n["block_decode"]}
        check(got == [f.hex() for _, f in plain], "overlap stream differs from the plain path")
        check(stats["recovered"] == len(corrupt), f"recovered {stats['recovered']} != {len(corrupt)}")
        check(stats["blocks"] == n_chunks and stats["overflow_blocks"] == 0, f"stats {stats}")
        print(f"stream overlap: {len(got)} frames, each once, in order; {wall:.2f} s wall, "
              f"stats {json.dumps({k: v for k, v in stats.items() if k != 'stages'})}")
        print(f"stream stages: {json.dumps(stats['stages'])}")

        text_p, _, wall_p = run_cli(["adsb", "--playback", path, "--fast", "--no-overlap"])
        hexes_p = hexes(text_p)
        want = [f.hex() for g, f in plain if g % CHUNK < CHUNK - 240]
        check(hexes_p == want, "no-overlap stream differs from the plain path's chunk filter")
        lost = len(got) - len(hexes_p)
        check(lost >= len(straddle), f"no-overlap lost {lost} < {len(straddle)} straddlers")
        print(f"stream no-overlap: {len(hexes_p)} frames ({lost} lost at chunk edges); {wall_p:.2f} s wall")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import airjax_torch  # noqa: F401  (fails outside a checkout of the repository)
    from airjax_torch.dsp.demod import WINDOW
    from airjax_torch.io import synth

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
    print(f"blocks: {BLOCK + HALO} samples, {len(frames)} DF17 frames; {len(ext_frames)} frames of "
          f"every format, extended capacity {capacity}; made in {time.perf_counter() - t0:.2f} s")

    kernels, tree_err, front_launches = phase_kernels(block_dev, ext_block_dev, capacity)
    phase_block(block_dev, frames, offsets)
    launches = phase_block_ab(block_dev, ext_block_dev, capacity)
    ab = phase_stencil_ab(block_dev)
    df17 = phase_stream(dev)
    phase_extended_block(ext_block_dev, capacity, ext_frames, ext_offsets)
    ext = phase_extended_stream(dev)
    launches.update({**df17, **ext, "block_decode": df17["block_decode"] + ext["block_decode"],
                     "magdet_front": front_launches["df17"], "magdet_front_preamble": front_launches["preamble"]})
    paths = {"magdet_bits": "adsb stream", "magdet_bits_preamble": "adsb --extended stream",
             "block_decode": "adsb stream + adsb --extended stream",
             "compact_bits": "block A/B, staged chain (DF17 + extended)",
             "candidate_crc": "block A/B, staged chain (DF17)", "candidate_extended": "block A/B, staged chain (extended)",
             "magdet_front": "phase 3 oracle checks (DF17 gate)",
             "magdet_front_preamble": "phase 3 oracle checks (preamble gate)"}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["path"] = paths[k["name"]]
    body = {"tree32": 148, "tree16": 157, "flat16": 169}
    planes = bound(*front_work(block_dev.shape[0], n_off, "df17", n_off + block_dev.shape[0] - 1))
    for v in VARIANTS:
        kernels.insert(5 + VARIANTS.index(v), {
            "name": f"magdet_tree_{v}", "route": "cuda", "source": "airjax_torch/csrc/magdet.cu",
            "replaces": f"airjax/kernels/stencil3.py:{body[v]}", "launches": ab[v][2], "path": "stencil A/B",
            "max_abs_err": tree_err[v], "ms": ab[v][0], "plain_ms": ab[v][1], "library_ms": None,
            "device_us": ab[v][3], "bound_ms": planes[0], "bound_by": planes[1]})

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
