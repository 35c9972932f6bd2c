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

A stream's steps (runner.run_stream_sharded) run through `StepGraphs` on
a mesh of one card, the counterpart of airjax's jitted step: a CUDA graph
per step shape holds the step's one upload, every shard's front and block
decode on a view of one device buffer, the gather and one download of
its C rows (kernels/shard_gather.py::gather_layout). A mesh over several
cards keeps the eager step (`EagerSteps`): its shards' peer copies are
not a graph of one card. The one-shot decodes below (decode_capture_
sharded*, and parallel/multihost.py's) run a step of a shape once a
call, as airjax builds a fresh jit a call there, and stay eager.

`tuned_block` pads a shard to the shape airjax tuned on the TPU (block ≡
784 mod 1024 above 4096 samples, a 240-sample halo). It is kept because it
sets `block`, the regrow caps and which offsets wrap, and so the stats
(`n_detections` counts detections at the last shard's wrapped offsets).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch

from airjax_torch.dsp.demod import WINDOW
from airjax_torch.extended import assemble_extended
from airjax_torch.kernels.shard_gather import MASK_KEYS, gather_layout, shard_gather, shard_gather_into
from airjax_torch.parallel.mesh import TIME_AXIS, Mesh
from airjax_torch.pipeline import (
    Fetcher,
    GraphRing,
    Slot,
    copy_in,
    decode_iq_block,
    decode_iq_block_extended,
    pad_iq_non_detecting,
    to_host,
)
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
    until they ran: EagerSteps' pipeline.Fetcher)."""
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


def _compact_builder(extended: bool):
    return build_sharded_decoder_extended_compact if extended else build_sharded_decoder_compact


def compact_rows(out: dict, n: int) -> dict:
    """A compact step's host dict -> its first n rows: every column (the
    nested field dicts' too) cut to n, the scalars dropped."""
    return {k: compact_rows(v, n) if isinstance(v, dict) else v[:n] for k, v in out.items()
            if isinstance(v, dict) or v.ndim}


# Every StepGraphs' first sightings, captures and replays in the process.
step_graph_counts = {"eager": 0, "captures": 0, "replays": 0}


class _StepEngine:
    """What the step engines share: the stream's K and C. A step that
    overflows is decoded again (`_again`) from its own device input with
    both grown 4x, K up to `block` and C up to T, and later steps run at
    the grown K and C (airjax/runner.py:562-566). Which later ones, the
    dispatch order alone decides: a step runs at the K and C left once the
    steps dispatched depth + 1 or more before it are done, those airjax's
    loop has fetched when it dispatches it. So a step fetched early
    (runner._run, the source idle) changes neither the keys nor the stats."""

    def _setup(self, mesh: Mesh, block: int, k: int, c: int, depth: int, extended: bool, recover2: bool,
               with_fields: bool) -> None:
        self.mesh, self.block, self.halo = mesh, block, _halo_size(block)
        self.n_samples = block * mesh.size
        self.extended, self.recover2, self.with_fields = extended, recover2, with_fields
        self.k, self.c = k, c  # where a regrow starts: as the steps collected so far left them
        self._in_force = (k, c)  # what the last step was dispatched at
        # What the next dispatches run at, in order: k and c for the first
        # depth + 1, then what each step collected left.
        self._left = collections.deque([(k, c)] * (max(depth, 0) + 1))

    def _capacity(self) -> tuple[int, int]:
        """(K, C) of the step dispatched now (a step fetched and done
        without `collect` leaves K and C as they were)."""
        if self._left:
            self._in_force = self._left.popleft()
        return self._in_force

    def collect(self, slot) -> tuple[dict, bool]:
        """The slot's dict, fetched and regrown while it overflows; then the
        slot is done -> (host arrays, whether the first fetch overflowed)."""
        out = self.fetch(slot)
        overflowed = bool(out["overflow"])
        while bool(out["overflow"]) and (self.k < self.block or self.c < self.n_samples):
            self.k, self.c = min(self.k * 4, self.block), min(self.c * 4, self.n_samples)
            out = self._again(slot)
        self.done(slot)
        self._left.append((self.k, self.c))
        return out, overflowed

    def _step(self, k: int, c: int) -> Callable:
        """The eager compact step at K = k and C = c."""
        return _compact_builder(self.extended)(self.mesh, self.n_samples, k, c, self.mesh.axis,
                                               with_fields=self.with_fields, recover2=self.recover2)


@dataclasses.dataclass(eq=False)
class StepSlot(Slot):
    """A step in flight: Slot's buffers (n_off a shard's `block` offsets,
    capacity the gather's C), each shard's K, and the shards: views of the
    device input, shard i its rows i * block to (i + 1) * block + halo."""

    k: int = 0
    shards: list = dataclasses.field(default_factory=list)


class StepGraphs(_StepEngine, GraphRing):
    """The compact sharded step of a stream on one card, as one program
    each, the counterpart of airjax's jitted shard_map step (:404, :412;
    extended :600, :608), one per (K, C) in airjax/runner.py:505-511: a CUDA
    graph per step shape and slot (pipeline.GraphRing: the ring of
    depth + 1 slots a key, the first sighting run eagerly, the capture at
    the slot's next use, the replays, the fetch).

    A key is (T, D, block, halo, K, C) for steps of T = D * block samples
    over `mesh`, every shard on one device (make_mesh(1), Mesh([card] * D),
    or CPU shards), in the cache's mode (extended, recover2, with_fields).
    A slot holds a pinned host input of T + halo rows and its device twin,
    the gather's int32 and byte buffers back to back (kernels/
    shard_gather.py::gather_layout) and their pinned copy, an event, and the
    graph: the input's one upload; for each shard its front and block
    decode (pipeline.decode_iq_block(_extended): csrc/front.cu,
    csrc/block_decode.cu) on the view of its rows; one shard-gather launch
    (its flag F with with_fields) into the slot's output; one download of
    that output. The host writes the step into the slot and, in its last
    halo rows, the step's first halo samples: the wrap shard_iq gives the
    last shard, so that every shard is a contiguous view and the graph
    holds no copy to build one. The gather takes the shards' pointers by
    value (csrc/shard_gather.cu's Shards), so the graph holds them and no
    pointer table is read from host memory. A slot downloads its C rows
    whole, where airjax fetches the count and then n rows.

    K = k and C = c at first; a regrow (`collect`) decodes the slot's own
    device input again with the eager step at the grown K and C, and the
    stream's later steps are the grown key's.
    A mesh over several cards is not taken: its step copies every other
    card's dicts to the first (EagerSteps).
    """

    counts = step_graph_counts

    def __init__(self, mesh: Mesh, block: int, k: int, c: int, *, extended: bool = False, recover2: bool = False,
                 with_fields: bool = False, depth: int = 1):
        if len(set(mesh.devices)) != 1:
            raise ValueError(f"StepGraphs: a mesh of one device, got {[str(d) for d in mesh.devices]}")
        super().__init__(mesh.devices[0], depth)
        self._setup(mesh, block, k, c, depth, extended, recover2, with_fields)
        _shape(mesh, self.n_samples, mesh.axis)

    def dispatch(self, iq: np.ndarray) -> StepSlot:
        """Start the step of one (T, 2) int16 host array at the stream's
        per-shard capacity K and C rows (_StepEngine). Returns its slot."""
        t = self.n_samples
        if iq.shape != (t, 2):
            raise ValueError(f"iq: expected ({t}, 2), got {iq.shape}")
        k, c = self._capacity()
        slot, first = self._take((t, self.mesh.size, self.block, self.halo, k, c), lambda: self._slot(k, c))
        copy_in(slot.host_iq[:t], iq)
        slot.host_iq[t:] = slot.host_iq[: self.halo]
        self._launch(slot, first)
        return slot

    def _again(self, slot: StepSlot) -> dict:
        """The slot's step decoded again at the grown K and C by the eager
        step, from the slot's device input (which no step overwrites before
        `done`) -> host arrays."""
        self.fetches += 1
        return to_host(self._step(self.k, self.c)(slot.shards))

    def _slot(self, k: int, c: int) -> StepSlot:
        lay = gather_layout(c, self.extended, self.recover2, self.with_fields)
        n_out = 4 * lay.n_int + lay.n_byte
        rows = self.n_samples + self.halo
        device_iq = torch.empty((rows, 2), dtype=torch.int16, device=self.device)
        shards = [device_iq[i * self.block : (i + 1) * self.block + self.halo] for i in range(self.mesh.size)]
        return StepSlot(self.block, c, lay, torch.empty((rows, 2), dtype=torch.int16, pin_memory=self.cuda),
                        device_iq, torch.empty(n_out, dtype=torch.uint8, device=self.device),
                        torch.empty(n_out, dtype=torch.uint8, pin_memory=self.cuda),
                        event=torch.cuda.Event() if self.cuda else None, k=k, shards=shards)

    def _body(self, slot: StepSlot) -> None:
        """The step of the slot's input: what its graph holds."""
        slot.device_iq.copy_(slot.host_iq, non_blocking=True)
        outs = _decode_shards(self.mesh, slot.shards, self.block, self.halo, slot.k, self.extended, self.recover2)
        shard_gather_into(outs, self.block, self.n_samples - WINDOW, slot.capacity, slot.ints, slot.byts,
                          extended=self.extended, recover2=self.recover2, with_fields=self.with_fields)
        slot.host_out.copy_(slot.out, non_blocking=True)


class EagerSteps(_StepEngine):
    """The compact sharded step launched eagerly, behind StepGraphs'
    interface: the step of a mesh over several cards, whose shards send
    their dicts to the first card by peer copies that a graph of one card
    does not hold. Each step is staged in a pinned buffer, uploaded shard
    by shard (shard_iq), decoded through the wrappers and gathered, with an
    event recorded after it; a fetch copies the count, then its n rows, on a
    copy stream that waits on that event alone (pipeline.Fetcher, whose
    pool holds a staging buffer a step in flight, so `depth` sets only
    when a regrow applies). A regrow runs the grown step on the slot's
    shards."""

    def __init__(self, mesh: Mesh, block: int, k: int, c: int, *, extended: bool = False, recover2: bool = False,
                 with_fields: bool = False, depth: int = 1):
        self._setup(mesh, block, k, c, depth, extended, recover2, with_fields)
        self.fetcher = Fetcher(mesh.devices[0])
        self.scalar_keys = ("n_candidates" if extended else "n_good", "n_detections", "overflow")
        self.eager = 0

    @property
    def fetches(self) -> int:
        return self.fetcher.fetches

    @property
    def overlapped(self) -> int:
        return self.fetcher.overlapped

    def dispatch(self, iq: np.ndarray) -> list:
        staged = self.fetcher.stage(iq)
        shards = shard_iq(staged, self.mesh, self.block, self.halo, non_blocking=True)
        out = self._step(*self._capacity())(shards)
        self.eager += 1
        # The shards stay on their devices for a regrow.
        return [shards, out, self.fetcher.launched(staged)]

    def fetch(self, slot: list) -> dict:
        _, out, ticket = slot
        scal = self.fetcher.fetch({k: out[k] for k in self.scalar_keys}, ticket)
        return {**scal, **self.fetcher.fetch(compact_rows(out, int(scal[self.scalar_keys[0]])), ticket)}

    def _again(self, slot: list) -> dict:
        slot[1] = self._step(self.k, self.c)(slot[0])
        self.fetcher.done(slot[2])
        slot[2] = self.fetcher.launched()
        return self.fetch(slot)

    def done(self, slot: list) -> None:
        self.fetcher.done(slot[2])

    def summary(self) -> dict[str, int]:
        return {"eager": self.eager, "captures": 0, "replays": 0, "pinned_bytes": 0, "device_bytes": 0}


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
