"""The decode pipeline in torch: IQ blocks -> validated 14-byte frames
(the DF17 main path of airjax/pipeline.py).

  int16 IQ -> exact magnitude -> preamble/DF17 gate at every offset ->
  ordered compaction into a fixed capacity -> packed PPM compares ->
  8-word candidate slice -> CRC-24 + single-bit repair -> frames

`decode_iq_block` runs that chain through the kernel wrappers: on CUDA the
front kernel (csrc/front.cu: detection bits, packed compares, detections
per tile), then the block-decode kernel (csrc/block_decode.cu: the ordered
compaction, the candidate decode and the dict in one launch) — the dataflow
of airjax's `decode_iq_block_kernel` (:140-171) with the dense word layout;
the port's `decode_iq_block_kernel` is that decode under airjax's name.
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

`BlockGraphs` is the counterpart of airjax's jit of these decodes with
their static shapes: one CUDA graph per block shape (and slot) holds a
block's upload, the front and block-decode launches and the dict's one
download, replayed for every block of that shape; `runner.run_stream` and
the overlap scan decode through it, and `kernels/block_decode.py::
dict_layout` is where the dict lies in the graph's output, read on the
device and on the host alike. Its ring of slots, first sightings,
captures, replays and fetch are `GraphRing`'s, which parallel/halo.py::
StepGraphs (a sharded step a graph) shares.

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
from typing import Callable

import numpy as np
import torch

from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.dsp.demod import (
    WINDOW,
    compact_detections,
    detect,
    detect_preamble_only,
    pack_cmp_words,
)
from airjax_torch.kernels import block_decode, magdet, shard_gather
from airjax_torch.kernels.block_decode import (
    candidate_dict,
    candidate_dict_extended,
    decode_block_bits,
    decode_block_bits_into,
    dict_layout,
)
from airjax_torch.kernels.candidate import (
    decode_candidates,
    decode_candidates_extended,
    decode_candidates_extended_plain,
    decode_candidates_plain,
)
from airjax_torch.kernels.compact import compact_bits, compact_for_gather
from airjax_torch.kernels.fields import DictLayout, layout_views
from airjax_torch.kernels.magdet import chunked_detection_count, magdet_bits
from airjax_torch.protocol.packet import AdsbPacket

Hit = tuple[int, int, bytes, bool]


def _check_block(n_samples: int, n_off: int) -> None:
    if n_off < 0 or n_off + WINDOW - 1 > n_samples:
        raise ValueError(f"n_off={n_off} needs {n_off + WINDOW - 1} samples, got {n_samples}")


def compact_mask(det: torch.Tensor, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The True positions of a (n,) mask in ascending slots, through
    compact_detections (airjax/pipeline.py:48-56): (indices (capacity,)
    int32, empty slots n; n_true () int32, every True counted)."""
    offsets, _, n_det = compact_detections(det, capacity)
    return offsets, n_det


def decode_mags_block(
    mags: torch.Tensor, n_off: int, capacity: int, recover2: bool = False
) -> dict[str, torch.Tensor]:
    """(L,) int32 magnitudes, L >= n_off + WINDOW - 1 -> candidate dict,
    in plain torch on either device (airjax/pipeline.py:59-108); recover2
    adds the 2-bit repair and `recovered2`."""
    _check_block(mags.shape[0], n_off)
    return candidate_dict(
        compact_for_gather(detect(mags, n_off), capacity), pack_cmp_words(mags), capacity,
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


def decode_mags_block_r2(mags: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """decode_mags_block with the 2-bit repair (airjax/pipeline.py:119-129):
    the plain chain from magnitudes, `recovered2` marking the frames a
    unique double flip validated; callers gate them."""
    return decode_mags_block(mags, n_off, capacity, recover2=True)


def decode_iq_block_kernel(iq: torch.Tensor, n_off: int, capacity: int) -> dict[str, torch.Tensor]:
    """airjax's decode on its Pallas front (airjax/pipeline.py:140-171),
    here on the Hopper front: the front kernel, then the block-decode
    kernel, the same two launches and dict as decode_iq_block.

    It takes airjax's kernel-padded input as it comes ((n + EXTRA, 2) int16,
    n a multiple of the TPU's tile, from airjax's pad_for_kernel) and
    decodes its first n_off offsets, whose windows end before the padding
    can matter. It has no `interpret` argument: Pallas' interpret mode has no
    CUDA meaning, and on the CPU the kernels' plain versions run."""
    return decode_iq_block(iq, n_off, capacity)


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
        compact_for_gather(detect_preamble_only(mags, n_off), capacity), pack_cmp_words(mags), capacity,
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
    """The uploads and result copies of eager decodes, so that they stay in
    flight on a card (parallel/halo.py::EagerSteps; airjax keeps them in
    flight through JAX's async dispatch, airjax/runner.py:382-388).

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


# The decodes a BlockGraphs slot holds: the front's gate, extended, fields.
_GRAPH_DECODES = {
    decode_iq_block: ("df17", False, False),
    decode_iq_block_extended: ("preamble", True, False),
    decode_iq_block_with_fields: ("df17", False, True),
    decode_iq_block_extended_with_fields: ("preamble", True, True),
}
MAX_GRAPH_SHAPES = 4  # keys a graph cache keeps; the least recently used goes first
# A block at least this large is copied into its slot by torch's copy, which
# splits it over threads; a smaller one by one memcpy, which wakes no thread
# (on an H100 host: ~68 µs for a 20,000-sample block through torch's copy).
THREADED_COPY_BYTES = 1 << 22
# Every BlockGraphs' first sightings, captures and replays in the process,
# beside the kernel wrappers' launch counts (parallel/halo.py keeps its
# StepGraphs' own).
graph_counts = {"eager": 0, "captures": 0, "replays": 0}


def _launch_counts() -> tuple[int, ...]:
    """The counts of the wrappers a graph launches through."""
    return (magdet.bits_launches, block_decode.launches, block_decode.fields_launches, shard_gather.launches,
            shard_gather.fields_launches)


def _add_launches(delta: tuple[int, ...]) -> None:
    magdet.bits_launches += delta[0]
    block_decode.launches += delta[1]
    block_decode.fields_launches += delta[2]
    shard_gather.launches += delta[3]
    shard_gather.fields_launches += delta[4]


def copy_in(dst: torch.Tensor, src: np.ndarray) -> None:
    """A host array into a host tensor of its shape: one memcpy below
    THREADED_COPY_BYTES, torch's threaded copy from there."""
    if src.nbytes >= THREADED_COPY_BYTES:
        dst.copy_(torch.from_numpy(src))
    else:
        np.copyto(dst.numpy(), src)


@dataclasses.dataclass(eq=False)
class Slot:
    """One decode in flight: its input's pinned host copy (None when the
    caller's block is on the device) and device copy, the kernel's output
    (the layout's int32 buffer, then its byte buffer, in one byte tensor
    `out`, so that one copy brings the dict back) and its pinned host copy,
    and the graph of it all. `n_off` is the offsets a decode scans (a
    shard's, in a step) and `capacity` the layout's rows; `launches` is
    what one replay adds to the wrappers' counts; `event` is recorded after
    each decode on the card."""

    n_off: int
    capacity: int
    layout: DictLayout
    host_iq: torch.Tensor | None
    device_iq: torch.Tensor
    out: torch.Tensor
    host_out: torch.Tensor
    graph: torch.cuda.CUDAGraph | Callable | None = None  # on the CPU, the plain body
    launches: tuple[int, ...] = ()
    event: torch.cuda.Event | None = None
    busy: bool = False

    def __post_init__(self):
        self.ints, self.byts = _split(self.out, self.layout.n_int)

    @property
    def pinned_bytes(self) -> int:
        return self.host_out.numel() + (0 if self.host_iq is None else self.host_iq.numel() * 2)

    @property
    def device_bytes(self) -> int:
        return self.out.numel() + self.device_iq.numel() * 2


def _split(out, n_int: int):
    """A slot's output bytes (a tensor or a numpy array) -> (the int32
    buffer, the byte buffer) of its layout, as views."""
    ints = out[: 4 * n_int]
    return ints.view(torch.int32) if isinstance(ints, torch.Tensor) else ints.view(np.int32), out[4 * n_int :]


class GraphRing:
    """A cache of decodes as one program each, a ring of slots a key: the
    machinery BlockGraphs and parallel/halo.py::StepGraphs share.

    A key is a static shape; the cache is the stream's and holds at most
    MAX_GRAPH_SHAPES keys, the least recently used going first (its slots
    live on in the entries still in flight). Each key owns a ring of
    depth + 1 slots, so that a stream with `depth` decodes in flight never
    writes a slot whose decode it has not fetched; a decode more in flight
    raises. A subclass's dispatch takes a slot (`_take`), copies its input
    in and calls `_launch`, which runs the subclass's `_body` (what a slot's
    graph holds): eagerly at a key's first sighting, where the library's
    build and the __constant__ and table uploads happen, which cannot be
    captured; as the slot's graph after that, captured at the slot's next
    use on a side stream (a capture runs nothing) and replayed on the
    device's current stream, as every decode of the card must run (the
    block-decode kernel's n_good accumulator is per device). A replay adds
    the launches its graph holds to the wrappers' counts, which the capture
    leaves as they were. A failed capture or replay raises. On the CPU the
    same ring, keys and buffers run, and a "replay" is the plain body.

    A fetch waits on the slot's event, copies the output out of the slot,
    so that the arrays a sink keeps never alias a slot, and reads the dict
    from it through the layout the device wrapper uses. `eager`, `captures`
    and `replays` count first sightings, graphs and replays (and add to the
    process-wide `counts`); `fetches` the dicts fetched (regrows included)
    and `overlapped` the fetches that returned while the next decode was
    still pending on the card.
    """

    counts = graph_counts

    def __init__(self, device: torch.device | str, depth: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.n_slots = max(depth, 0) + 1
        self._keys: collections.OrderedDict[tuple, list] = collections.OrderedDict()  # key -> [uses, slots]
        self._pending: collections.deque[Slot] = collections.deque()
        # Made here, on the thread that runs the stream: a capture's stream.
        self._capture_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.eager = self.captures = self.replays = self.fetches = self.overlapped = 0

    def _take(self, key: tuple, make: Callable[[], Slot]) -> tuple[Slot, bool]:
        """The key's next slot in its ring (made by `make` at its first use)
        -> (slot, whether this is the key's first sighting)."""
        entry = self._keys.pop(key, None)
        first = entry is None
        if first:
            while len(self._keys) >= MAX_GRAPH_SHAPES:
                self._keys.popitem(last=False)
            entry = [0, []]
        self._keys[key] = entry
        i = entry[0] % self.n_slots
        if i == len(entry[1]):
            entry[1].append(make())
        slot = entry[1][i]
        if slot.busy:
            raise RuntimeError(f"a {type(self).__name__} slot is still in flight: more decodes in flight than "
                               f"depth + 1")
        entry[0] += 1
        return slot, first

    def _launch(self, slot: Slot, first: bool) -> None:
        """Run the slot's decode: eagerly at a first sighting, else its graph."""
        if first:
            self._body(slot)
            self._count("eager")
        else:
            if slot.graph is None:
                self._capture(slot)
            if self.cuda:
                slot.graph.replay()
                _add_launches(slot.launches)
            else:
                slot.graph()
            self._count("replays")
        if self.cuda:
            slot.event.record(torch.cuda.current_stream(self.device))
        slot.busy = True
        self._pending.append(slot)

    def _body(self, slot: Slot) -> None:
        raise NotImplementedError

    def fetch(self, slot: Slot) -> dict:
        """The slot's dict as numpy arrays of the host's own, once its
        decode has completed."""
        if self.cuda:
            slot.event.synchronize()
        ints, byts = _split(slot.host_out.numpy().copy(), slot.layout.n_int)
        self._pending.remove(slot)
        self.fetches += 1
        if self.cuda and self._pending and not self._pending[0].event.query():
            self.overlapped += 1
        return layout_views(slot.layout.entries, ints, byts)

    def done(self, slot: Slot) -> None:
        """The slot's results are applied: a later decode may take it."""
        slot.busy = False

    def slots(self) -> list[Slot]:
        return [slot for _, slots in self._keys.values() for slot in slots]

    def summary(self) -> dict[str, int]:
        """First sightings, captures, replays, and the bytes the slots hold
        (StreamStats.graphs)."""
        slots = self.slots()
        return {"eager": self.eager, "captures": self.captures, "replays": self.replays,
                "pinned_bytes": sum(s.pinned_bytes for s in slots), "device_bytes": sum(s.device_bytes for s in slots)}

    def _count(self, kind: str) -> None:
        setattr(self, kind, getattr(self, kind) + 1)
        self.counts[kind] += 1

    def _capture(self, slot: Slot) -> None:
        """Capture the slot's body on the side stream (on the CPU the
        "graph" is the body itself). thread_local: another thread of the
        process (the source's Prefetcher, a UI server) may call CUDA
        meanwhile without invalidating the capture."""
        if not self.cuda:
            slot.graph = functools.partial(self._body, slot)
            self._count("captures")
            return
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        compute = torch.cuda.current_stream(self.device)
        self._capture_stream.wait_stream(compute)
        with torch.cuda.device(self.device), torch.cuda.stream(self._capture_stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body(slot)
            finally:
                graph.capture_end()
        compute.wait_stream(self._capture_stream)
        slot.launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        _add_launches(tuple(-n for n in slot.launches))  # a capture launches nothing
        slot.graph = graph
        self._count("captures")


class BlockGraphs(GraphRing):
    """One decode function's blocks as one program each, the counterpart
    of airjax's jit of decode_iq_block* with its static shape arguments
    (airjax/pipeline.py:111, :277, :288, :308): airjax replays one
    executable per shape, the port one CUDA graph per shape and slot
    (GraphRing: the ring, the first sighting, the capture, the fetch).

    A key is a block shape (L, n_off, capacity), for `decode` (one of
    decode_iq_block, decode_iq_block_extended and their _with_fields forms,
    with or without recover2) on `device`. A slot's graph holds the block's
    upload from the slot's pinned input (upload=True; with upload=False the
    caller's device block is copied into the slot's device input before the
    replay, outside the graph), the front launch (csrc/front.cu), the
    block-decode launch (csrc/block_decode.cu: Mode, R2 and F as the key
    says) into the slot's output (the dict's two buffers back to back), and
    one copy of it into the slot's pinned output, read through
    kernels/block_decode.py::dict_layout. The memory a slot holds is its
    block twice (pinned and on the device; once with upload=False) and its
    dict twice; its graph's pool holds the front's outputs (BlockGraphs.slots,
    Slot.pinned_bytes and device_bytes).
    """

    def __init__(self, decode, *, recover2: bool = False, device: torch.device | str = "cuda", depth: int = 1,
                 upload: bool = True):
        super().__init__(device, depth)
        self.gate, self.extended, self.fields = _GRAPH_DECODES[decode]
        self.recover2 = recover2
        self.decode = functools.partial(decode, recover2=recover2)  # the eager form: the regrow
        self.upload = upload

    def dispatch(self, iq, n_off: int, capacity: int) -> Slot:
        """Start the decode of one (L, 2) int16 block: host IQ (numpy) with
        upload=True, a tensor on the device without. Returns its slot."""
        _check_block(iq.shape[0], n_off)
        slot, first = self._take((iq.shape[0], n_off, capacity), lambda: self._slot(iq.shape[0], n_off, capacity))
        if self.upload:
            copy_in(slot.host_iq, iq)
        else:
            slot.device_iq.copy_(iq)
        self._launch(slot, first)
        return slot

    def collect(self, slot: Slot) -> tuple[dict, bool]:
        """The slot's dict, decoded again while it overflows by the eager
        wrappers from the slot's device input at 4x the capacity, up to its
        n_off (airjax/runner.py:231-237); then the slot is done -> (host
        arrays, whether the first fetch overflowed)."""
        out = self.fetch(slot)
        overflowed = bool(out["overflow"])
        capacity = slot.capacity
        while bool(out["overflow"]) and capacity < slot.n_off:
            capacity = min(capacity * 4, slot.n_off)
            self.fetches += 1
            out = to_host(self.decode(slot.device_iq, slot.n_off, capacity))
        self.done(slot)
        return out, overflowed

    def _slot(self, n_samples: int, n_off: int, capacity: int) -> Slot:
        lay = dict_layout(capacity, self.extended, self.recover2, self.fields)
        n_out = 4 * lay.n_int + lay.n_byte
        host_iq = torch.empty((n_samples, 2), dtype=torch.int16, pin_memory=self.cuda) if self.upload else None
        return Slot(n_off, capacity, lay, host_iq, torch.empty((n_samples, 2), dtype=torch.int16, device=self.device),
                    torch.empty(n_out, dtype=torch.uint8, device=self.device),
                    torch.empty(n_out, dtype=torch.uint8, pin_memory=self.cuda),
                    event=torch.cuda.Event() if self.cuda else None)

    def _body(self, slot: Slot) -> None:
        """The decode of the slot's block: what its graph holds."""
        if self.upload:
            slot.device_iq.copy_(slot.host_iq, non_blocking=True)
        det_words, words, counts = magdet_bits(slot.device_iq, slot.n_off, gate=self.gate)
        decode_block_bits_into(det_words, words, counts, slot.n_off, slot.capacity, slot.ints, slot.byts,
                               extended=self.extended, recover2=self.recover2, fields=self.fields)
        slot.host_out.copy_(slot.out, non_blocking=True)


def decode_iq_block_adaptive(
    iq_block: np.ndarray, n_off: int, capacity: int, *, device: torch.device | str = "cuda"
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
    iq: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG, fused: bool = True, *, device: torch.device | str = "cuda"
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
    iq: np.ndarray, cfg: PipelineConfig = DEFAULT_CONFIG, *, device: torch.device | str = "cuda"
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
    resident capture through one BlockGraphs key, whose collect regrows
    capacity on overflow."""
    max_global = n - WINDOW  # windows past the capture end are not scanned
    hits = []
    stats = {"n_detections": 0, "n_good": 0, "n_recovered": 0, "overflow": False}
    # One graph for every block (airjax's one jitted _decode_block_at): a
    # block is copied on the device into the slot's input, then replayed.
    graphs = BlockGraphs(decode_iq_block, device=iq_dev.device, depth=0, upload=False)
    for b in range(n_blocks):
        out, _ = graphs.collect(graphs.dispatch(iq_dev[b * scan : b * scan + slice_len], scan, cfg.max_candidates))
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
            res = decode_iq_block_adaptive(blocks[b], n_off, capacity, device=device)
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
