"""Sharded overlap-save decode over a mesh (airjax/parallel/halo.py).

A capture is cut along time into D shards of `block` samples. A Mode S
window is 240 samples, so each shard also needs the head of the next shard
(the ring wraps: the last shard takes the first shard's head, and a
one-shard mesh its own). airjax moves that halo as magnitudes with a
`ppermute` (:90-96); here each shard's block and the next shard's first
`_halo_size(block)` IQ samples are copied into a fresh buffer on the
shard's device (`shard_iq`). Magnitudes are per sample, so an IQ halo
gives the same magnitudes, and the fresh buffer keeps the front kernel's
base aligned. Each shard then runs the block decode (pipeline.
decode_iq_block or decode_iq_block_extended: the front and block-decode
kernels, recover2 as the R2 flag) over its `block` offsets, on its own
device; shards that share a card run one after another on its current
stream. Every global offset is scanned once; windows past the capture are
masked with the capture's length, as the reference's `len - 240`.

The compact builders (airjax :335, :521) end in one shard-gather launch
(kernels/shard_gather.py) on the mesh's first device: the selected rows
of every shard, offset-sorted, in a buffer of C rows. A shard on another
card sends its dict there first, one copy per buffer the block decode
wrote. With `with_fields` the same gather launch also writes the
gathered rows' fields (its flag F), as airjax calls extract_fields on its
replicated buffer (:417-424, :613-621): a batched sharded step is a front
and a block decode a shard and one gather, no fields launch. The dense
builders (:62, :449) return every shard's K slots, for the A/B.

`tuned_block` pads a shard to the shape airjax tuned on the TPU (block ≡
784 mod 1024 above 4096 samples, a 240-sample halo). It is kept because it
sets `block`, the regrow caps and which offsets wrap, and so the stats
(`n_detections` counts detections at the last shard's wrapped offsets).
"""

from __future__ import annotations

import numpy as np
import torch

from airjax_torch.dsp.demod import WINDOW
from airjax_torch.extended import assemble_extended
from airjax_torch.kernels.shard_gather import MASK_KEYS, shard_gather
from airjax_torch.parallel.mesh import TIME_AXIS, Mesh
from airjax_torch.pipeline import decode_iq_block, decode_iq_block_extended, pad_iq_non_detecting, to_host
from airjax_torch.track.icao_cache import IcaoCache

HALO = WINDOW - 1  # 239

# The tuned decomposition (airjax :33-40): block ≡ TUNED_RESIDUE (mod 1024)
# and a TUNED_HALO-sample halo make a 1024-aligned shard slice.
TUNED_HALO = 240
TUNED_RESIDUE = (-TUNED_HALO) % 1024  # 784

# Per-candidate columns of the extended compact output that the host
# wrappers and the sharded stream runner fetch (airjax :298-301).
EXT_COMPACT_ROW_KEYS = ("offsets", "classmask", "df", "icao_ap_short", "icao_ap_long", "frames", "frames_raw")
# The extended classes masked to a shard's owned offsets (airjax :435-442),
# and the columns carried unmasked (:445-446).
_EXT_MASK_KEYS = MASK_KEYS
_EXT_DATA_KEYS = ("df", "icao_ap_short", "icao_ap_long")
_EXT_FRAME_KEYS = ("frames", "frames_raw")
# The columns of the dense extended dict that assemble_extended consumes.
EXT_DENSE_KEYS = ("offsets", *_EXT_MASK_KEYS, *_EXT_DATA_KEYS, *_EXT_FRAME_KEYS)


def _halo_size(block: int) -> int:
    """240 for a block in the tuned class (≡ 784 mod 1024), else 239."""
    if block % 1024 == TUNED_RESIDUE:
        return TUNED_HALO
    return HALO


def tuned_block(per_shard: int) -> int:
    """Round a shard's sample count up to the tuned class (≡ 784 mod 1024);
    below 4096 samples unchanged."""
    if per_shard < 4096:
        return per_shard
    return per_shard + (TUNED_RESIDUE - per_shard) % 1024


def _shape(mesh: Mesh, n_samples: int, axis: str) -> tuple[int, int, int]:
    """(D, block, halo) of a decode of `n_samples` over `mesh`; raises as airjax."""
    n_dev = mesh.shape[axis]
    if n_samples % n_dev != 0:
        raise ValueError(f"n_samples {n_samples} not divisible by mesh size {n_dev}")
    block = n_samples // n_dev
    if block < HALO:
        raise ValueError(f"per-shard block {block} smaller than halo {HALO}")
    return n_dev, block, _halo_size(block)


def shard_iq(iq, mesh: Mesh, block: int, halo: int, non_blocking: bool = False) -> list[torch.Tensor]:
    """(D * block, 2) int16 IQ (numpy or a tensor) -> each shard's (block +
    halo, 2) slice, its block then the head of the next shard, in a fresh
    buffer on the shard's device. A step takes this list as it takes the
    whole array, so that a regrow does not copy the capture again.
    non_blocking=True queues the copies from a pinned host tensor on the
    devices' current streams without waiting (the caller keeps it alive
    until they ran: runner.run_stream_sharded's pipeline.Fetcher)."""
    src = torch.from_numpy(np.ascontiguousarray(iq, dtype=np.int16)) if isinstance(iq, np.ndarray) else iq
    n_dev = mesh.size
    if src.dtype != torch.int16 or tuple(src.shape) != (n_dev * block, 2):
        raise ValueError(f"iq: expected ({n_dev * block}, 2) int16, got {tuple(src.shape)} {src.dtype}")
    shards = []
    for i, device in enumerate(mesh.devices):
        nxt = (i + 1) % n_dev * block
        ext = torch.empty((block + halo, 2), dtype=torch.int16, device=device)
        ext[:block].copy_(src[i * block : (i + 1) * block], non_blocking=non_blocking)
        ext[block:].copy_(src[nxt : nxt + halo], non_blocking=non_blocking)
        shards.append(ext)
    return shards


def _to_device(out: dict, device: torch.device, copy=lambda flat, device: flat.to(device)) -> dict:
    """A shard's dict on `device`: each buffer its tensors view is copied
    once (the block-decode kernel writes two) and the views are rebuilt on
    the copy; a dict already there is returned as it is."""
    if all(t.device == device for t in out.values()):
        return out
    copies = {}
    moved = {}
    for key, t in out.items():
        storage = t.untyped_storage()
        if storage.data_ptr() not in copies:
            flat = torch.empty(0, dtype=torch.uint8, device=t.device).set_(storage)
            copies[storage.data_ptr()] = copy(flat, device).untyped_storage()
        moved[key] = torch.empty(0, dtype=t.dtype, device=device).set_(
            copies[storage.data_ptr()], t.storage_offset(), t.shape, t.stride())
    return moved


def _decode_shards(mesh: Mesh, iq, block: int, halo: int, capacity: int, extended: bool,
                   recover2: bool = False) -> list[dict]:
    """Every shard's block decode, launched shard by shard, then each dict
    on the mesh's first device."""
    shards = iq if isinstance(iq, list) else shard_iq(iq, mesh, block, halo)
    decode = decode_iq_block_extended if extended else decode_iq_block
    outs = [decode(ext, block, capacity, recover2=recover2) for ext in shards]
    return [_to_device(out, mesh.devices[0]) for out in outs]


def dense_rows(outs: list[dict], block: int, n_samples: int, extended: bool, first_shard: int = 0) -> dict:
    """The shards' block-decode dicts -> the dense dict of all their slots
    (airjax :111-142, :490-518): offsets globalized from shard first_shard
    on (out of range: n_samples), the flags masked to owned in-capture
    offsets (DF17 good and recovered, extended the six classes), the other
    columns as decoded, and n_detections (and DF17 n_good), overflow over
    the shards."""
    max_offset = n_samples - WINDOW
    parts: dict[str, list] = {}
    for i, res in enumerate(outs, first_shard):
        offsets = res["offsets"] + i * block
        in_range = res["valid"] & (offsets <= max_offset)
        parts.setdefault("offsets", []).append(torch.where(in_range, offsets, n_samples))
        for k in _EXT_MASK_KEYS if extended else ("good", "recovered"):
            parts.setdefault(k, []).append(res[k] & in_range)
        for k in _EXT_DATA_KEYS + _EXT_FRAME_KEYS if extended else ("frames",):
            parts.setdefault(k, []).append(res[k])
    out = {k: torch.cat(v) for k, v in parts.items()}
    out["n_detections"] = torch.stack([r["n_detections"] for r in outs]).sum(dtype=torch.int32)
    if not extended:
        out["n_good"] = out["good"].sum(dtype=torch.int32)
    out["overflow"] = torch.stack([r["overflow"] for r in outs]).any()
    return out


def build_sharded_decoder(mesh: Mesh, n_samples: int, capacity_per_shard: int, axis: str = TIME_AXIS):
    """A step for captures of `n_samples` (airjax :62-142): (n_samples, 2)
    int16 IQ, or shard_iq's list -> the dense dict of every shard's slots,
    on the mesh's first device: offsets (D*K,) int32 global (out of range:
    n_samples), good, recovered (D*K,) bool, frames (D*K, 14) uint8, and
    n_detections, n_good, overflow summed over the shards."""
    n_dev, block, halo = _shape(mesh, n_samples, axis)

    def step(iq) -> dict[str, torch.Tensor]:
        outs = _decode_shards(mesh, iq, block, halo, capacity_per_shard, extended=False)
        return dense_rows(outs, block, n_samples, extended=False)

    return step


def build_sharded_decoder_compact(
    mesh: Mesh, n_samples: int, capacity_per_shard: int, compact_capacity: int, axis: str = TIME_AXIS,
    with_fields: bool = False, recover2: bool = False,
):
    """A step (airjax :335-426) -> the compact dict of C = compact_capacity
    rows on the mesh's first device (kernels/shard_gather.py): offsets,
    recovered, frames, n_good, n_detections, overflow (any shard's, or
    n_good > C: callers regrow and rerun), `recovered2` under recover2,
    `fields` (extract_fields of the C rows, the gather launch's flag F)
    with with_fields."""
    n_dev, block, halo = _shape(mesh, n_samples, axis)
    max_offset = n_samples - WINDOW

    def step(iq) -> dict:
        outs = _decode_shards(mesh, iq, block, halo, capacity_per_shard, False, recover2)
        return shard_gather(outs, block, max_offset, compact_capacity, recover2=recover2, with_fields=with_fields)

    return step


def build_sharded_decoder_extended(mesh: Mesh, n_samples: int, capacity_per_shard: int, axis: str = TIME_AXIS):
    """The dense extended step (airjax :449-518) -> the candidate dict
    assemble_extended consumes, every shard's slots: offsets globalized (out
    of range: n_samples), the six classes masked to owned in-capture
    offsets, df / AP residuals / frames / raw frames as decoded, and
    n_detections, overflow over the shards."""
    n_dev, block, halo = _shape(mesh, n_samples, axis)

    def step(iq) -> dict[str, torch.Tensor]:
        outs = _decode_shards(mesh, iq, block, halo, capacity_per_shard, extended=True)
        return dense_rows(outs, block, n_samples, extended=True)

    return step


def build_sharded_decoder_extended_compact(
    mesh: Mesh, n_samples: int, capacity_per_shard: int, compact_capacity: int, axis: str = TIME_AXIS,
    with_fields: bool = False, recover2: bool = False,
):
    """The extended step with the compact output (airjax :521-624): the
    union of the classes gathered into C rows, the classes packed into
    `classmask` (bit i = _EXT_MASK_KEYS[i]; unpack_extended_compact expands
    it): offsets, classmask, df, icao_ap_short, icao_ap_long, frames,
    frames_raw, n_candidates, n_detections, overflow; `recovered2` under
    recover2; `fields` and `short_fields` with with_fields (the gather
    launch's flag F)."""
    n_dev, block, halo = _shape(mesh, n_samples, axis)
    max_offset = n_samples - WINDOW

    def step(iq) -> dict:
        outs = _decode_shards(mesh, iq, block, halo, capacity_per_shard, True, recover2)
        return shard_gather(outs, block, max_offset, compact_capacity, extended=True, recover2=recover2,
                            with_fields=with_fields)

    return step


def _run_compact_with_regrow(make_step, iq_dev, K: int, C: int, block: int, n_dev: int, count_key: str):
    """Run a compact step, regrowing K and C together, 4x, capped at block
    and D * block, while it overflows (airjax :304-319) -> (out, the
    scalars on the host, K, C)."""
    keys = (count_key, "n_detections", "overflow")
    out = make_step(K, C)(iq_dev)
    scal = to_host({k: out[k] for k in keys})
    while bool(scal["overflow"]) and (K < block or C < n_dev * block):
        K = min(K * 4, block)
        C = min(C * 4, n_dev * block)
        out = make_step(K, C)(iq_dev)
        scal = to_host({k: out[k] for k in keys})
    return out, scal, K, C


def _run_dense_with_regrow(make_step, iq_dev, K: int, block: int) -> tuple[dict, int]:
    """Run a dense step, regrowing K 4x, capped at block, while a shard
    overflows: a detection storm must not drop hits (airjax :204-208) ->
    (out on the host, K)."""
    out = to_host(make_step(K)(iq_dev))
    while bool(out["overflow"]) and K < block:
        K = min(K * 4, block)
        out = to_host(make_step(K)(iq_dev))
    return out, K


def collect_df17(make_step, iq_dev, K: int, C: int, block: int, n_dev: int, max_offset: int,
                 gather: str) -> tuple[list, dict]:
    """The DF17 decode over the shards, regrown on overflow -> (hits,
    stats). make_step(k, c) builds the compact step (gather="compact") or
    the dense one; hits are (0, global_offset, frame_bytes, recovered) at
    offsets up to max_offset, in offset order; stats n_detections, n_good,
    overflow, capacity_per_shard, and compact_capacity, fetched_bytes
    (compact)."""
    if gather == "compact":
        out, scal, K, C = _run_compact_with_regrow(make_step, iq_dev, K, C, block, n_dev, "n_good")
        n_good = int(scal["n_good"])
        rows = to_host({k: out[k][:n_good] for k in ("offsets", "recovered", "frames")})
        picked = range(n_good)
        extra = {"compact_capacity": C, "fetched_bytes": n_good * (4 + 4 + 14)}
    else:
        rows, K = _run_dense_with_regrow(lambda k: make_step(k, C), iq_dev, K, block)
        scal, picked, extra = rows, np.nonzero(rows["good"])[0], {}
    hits = []
    for k in picked:
        off = int(rows["offsets"][k])
        if off <= max_offset:
            hits.append((0, off, rows["frames"][k].tobytes(), bool(rows["recovered"][k])))
    hits.sort(key=lambda h: h[1])
    stats = {
        "n_detections": int(scal["n_detections"]),
        "n_good": int(scal["n_good"]),
        "overflow": bool(scal["overflow"]),
        "capacity_per_shard": K,
        **extra,
    }
    return hits, stats


def collect_extended(make_step, iq_dev, K: int, C: int, block: int, n_dev: int, max_offset: int,
                     gather: str) -> tuple[dict, dict]:
    """The extended decode over the shards, regrown on overflow ->
    (candidates, stats). make_step(k, c) builds the compact step
    (gather="compact") or the dense one; the candidates are on the host in
    the schema assemble_extended consumes, their classes masked to offsets
    up to max_offset; stats n_detections, n_good_long, n_good_df11,
    overflow, capacity_per_shard, and compact_capacity, n_candidates,
    fetched_bytes (compact)."""
    if gather == "compact":
        out, scal, K, C = _run_compact_with_regrow(make_step, iq_dev, K, C, block, n_dev, "n_candidates")
        n_cand = int(scal["n_candidates"])
        cand = unpack_extended_compact(to_host({k: out[k][:n_cand] for k in EXT_COMPACT_ROW_KEYS}), n_cand)
        extra = {"compact_capacity": C, "n_candidates": n_cand,
                 "fetched_bytes": n_cand * (4 + 1 + 4 + 4 + 4 + 14 + 14)}
    else:
        scal, K = _run_dense_with_regrow(lambda k: make_step(k, C), iq_dev, K, block)
        cand, extra = {k: scal[k] for k in EXT_DENSE_KEYS}, {}
    # Windows past the capture (into a padded capture's padding) were never real.
    in_cap = cand["offsets"] <= max_offset
    for k in _EXT_MASK_KEYS:
        cand[k] = cand[k] & in_cap
    stats = {
        "n_detections": int(scal["n_detections"]),
        "n_good_long": int(np.sum(cand["good_long"])),
        "n_good_df11": int(np.sum(cand["good_df11"])),
        "overflow": bool(scal["overflow"]),
        "capacity_per_shard": K,
        **extra,
    }
    return cand, stats


def unpack_extended_compact(out: dict, n: int | None = None) -> dict:
    """A fetched compact extended dict (numpy) -> the schema
    assemble_extended consumes: the classes unpacked from `classmask`,
    every column cut to the candidate count (airjax :627-647)."""
    n = int(out["n_candidates"]) if n is None else n
    cm = np.asarray(out["classmask"][:n])
    unpacked = {k: np.asarray(out[k][:n]) for k in ("offsets", "df", "icao_ap_short", "icao_ap_long", "frames",
                                                    "frames_raw")}
    for i, k in enumerate(_EXT_MASK_KEYS):
        unpacked[k] = (cm >> i) & 1 > 0
    if "recovered2" in out:
        unpacked["recovered2"] = np.asarray(out["recovered2"][:n])
    return unpacked


def _prepare(iq, mesh: Mesh, axis: str) -> tuple[np.ndarray, int, int, int, list[torch.Tensor]]:
    """Pad a capture to D shards of tuned_block samples and shard it ->
    (n, D, block, padded length, shard_iq's list)."""
    n_dev = mesh.shape[axis]
    n = len(iq)
    block = tuned_block(-(-n // n_dev))
    padded_len = block * n_dev
    _shape(mesh, padded_len, axis)
    arr = pad_iq_non_detecting(np.asarray(iq, dtype=np.int16), padded_len)
    return n, n_dev, block, padded_len, shard_iq(arr, mesh, block, _halo_size(block))


def decode_capture_sharded(
    iq, mesh: Mesh, capacity_per_shard: int = 256, axis: str = TIME_AXIS, gather: str = "compact",
    compact_capacity: int | None = None,
):
    """Pad, decode over the mesh, collect the hits (airjax :145-238) ->
    (hits, stats); hits are (0, global_offset, frame_bytes, recovered) in
    offset order, as pipeline.decode_capture_overlap's. gather="compact"
    fetches n_good rows (stats["fetched_bytes"]); "dense" every shard's K."""
    n, n_dev, block, padded_len, iq_dev = _prepare(iq, mesh, axis)

    def make_step(k: int, c: int):
        if gather == "compact":
            return build_sharded_decoder_compact(mesh, padded_len, k, c, axis)
        return build_sharded_decoder(mesh, padded_len, k, axis)

    hits, stats = collect_df17(make_step, iq_dev, capacity_per_shard, compact_capacity or max(128, capacity_per_shard),
                               block, n_dev, n - WINDOW, gather)
    if gather != "compact":  # every shard's K slots: offsets, good, recovered, frames
        stats["fetched_bytes"] = n_dev * stats["capacity_per_shard"] * (4 + 1 + 1 + 14)
    return hits, stats


def decode_capture_sharded_extended(
    iq, mesh: Mesh, capacity_per_shard: int = 2048, axis: str = TIME_AXIS, now: float = 0.0, cache=None,
    gather: str = "compact", compact_capacity: int | None = None,
):
    """The extended decode over the mesh -> ([(global_offset, packet)],
    stats) through assemble_extended (airjax :650-741): the same packets
    as decoding the whole capture as one extended block, the ICAO cache
    seeing every CRC-validated frame before any AP candidate is gated."""
    n, n_dev, block, padded_len, iq_dev = _prepare(iq, mesh, axis)

    def make_step(k: int, c: int):
        if gather == "compact":
            return build_sharded_decoder_extended_compact(mesh, padded_len, k, c, axis)
        return build_sharded_decoder_extended(mesh, padded_len, k, axis)

    cand, stats = collect_extended(make_step, iq_dev, capacity_per_shard,
                                   compact_capacity or max(512, capacity_per_shard), block, n_dev, n - WINDOW, gather)
    return assemble_extended(cand, now, cache if cache is not None else IcaoCache()), stats
