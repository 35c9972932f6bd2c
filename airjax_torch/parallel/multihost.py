"""The multi-process decode over torch.distributed (airjax/parallel/multihost.py).

A capture's span is split over the processes of a job, in order: process
(rank) r holds samples [r * L, (r + 1) * L) and its own mesh of D_local
shards, one card a process (or N CPU shards when the caller asks for
them), so that the job's mesh has D = world * D_local shards and rank r's
local shard i is global shard r * D_local + i. airjax lays one jax mesh
over every device of every process and lets XLA move the halo (a
`ppermute` over ICI or DCN) and the gathered rows (a `psum`); here the
processes exchange what they must with `all_gather` alone, so that the
NCCL and the gloo backend take every call:

  * init()                 — torch.distributed.init_process_group from the
                             arguments or the environment; (0, 1) alone
  * global_mesh()          — the job's mesh: this rank's shards and its place
  * ingest_process_local() — this rank's shard buffers; the halo of its last
                             shard is the next rank's head (one all_gather of
                             every rank's first 240 samples; the last rank
                             takes rank 0's, a ring as airjax's)
  * decode_capture()       — each rank decodes its shards (a front and a
                             block decode a shard) and gathers its rows with
                             one shard-gather launch whose rows are already
                             global (`first_shard`); one all_gather of the
                             ranks' counts, detections and overflow flags
                             (their max is airjax's all-reduce of the flag),
                             one of the rows padded to the largest count,
                             concatenated in rank order: the same C-row
                             buffer on every rank. Every rank reads the same
                             overflow, so all regrow K and C in step
                             (halo.collect_df17 / collect_extended).
                             gather="dense" gathers every rank's
                             D_local * K slots instead.
  * decode_capture_extended(), attach_candidate_fields(),
    decode_capture_extended_batched() — the extended decode, the fields of
    the gathered rows (one kernels/fields.py::block_fields launch on the
    rank's device), and one on_extended_block a rank, so that every rank's
    tracker replica ends in the same state.

The exchanged tensors lie on the backend's device: the rank's card for
NCCL, the host for gloo (the rows are copied there explicitly). airjax's
multihost does not pad a shard to `tuned_block`: block = n_global // D, so
the stats equal airjax's multihost decode, not halo.decode_capture_sharded's
(whose padding can change `n_detections`). A process alone (no process
group) decodes its span as the whole capture, as airjax's does.

Two processes may share a card: each has its own context, and so its own
block-decode `n_good` accumulator. One NCCL communicator must not hold two
ranks of one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from airjax_torch.dsp.demod import WINDOW
from airjax_torch.extended import assemble_extended
from airjax_torch.kernels.fields import block_fields
from airjax_torch.kernels.shard_gather import shard_gather
from airjax_torch.parallel import halo
from airjax_torch.parallel.mesh import TIME_AXIS, Mesh
from airjax_torch.pipeline import to_host
from airjax_torch.track.icao_cache import IcaoCache

# The process group's timeout: how long a collective may wait on its peers.
TIMEOUT = datetime.timedelta(seconds=60)

# The columns each gather moves, in the order they are packed into a row of bytes.
_DF17_ROWS = ("offsets", "recovered", "frames")
_DF17_DENSE = ("offsets", "good", "recovered", "frames")


def init(backend: str | None = None, init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None) -> tuple[int, int]:
    """Join the job's process group -> (rank, world size).

    From the arguments, or else from the environment (MASTER_ADDR,
    WORLD_SIZE, RANK: `env://`); with neither, a process alone -> (0, 1),
    as airjax's init. An existing group is kept. The backend is NCCL unless
    the caller names gloo (a decode on the CPU, or several ranks on one
    card). An NCCL rank takes its card (LOCAL_RANK, else rank modulo the
    cards) and makes its communicator here, not at the first collective, so
    that a rendezvous or a communicator that fails, fails in init."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None and world_size is None and "MASTER_ADDR" not in os.environ:
        return 0, 1
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    backend = backend or "nccl"
    card = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.init: NCCL needs a CUDA card (backend='gloo' for the CPU)")
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=TIMEOUT, device_id=card)
    return rank, world_size


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The job's 1-D mesh: this rank's shards (`local`) at global index
    rank * local.size of world * local.size."""

    local: Mesh
    rank: int
    world: int

    @property
    def size(self) -> int:
        return self.world * self.local.size

    @property
    def shape(self) -> dict[str, int]:
        """{axis: the job's shard count}, as airjax's global mesh."""
        return {self.local.axis: self.size}

    @property
    def first_shard(self) -> int:
        return self.rank * self.local.size

    @property
    def grouped(self) -> bool:
        """Whether the ranks exchange through a process group."""
        return dist.is_initialized()


def global_mesh(axis: str = TIME_AXIS, *, local: Mesh | None = None) -> ProcessMesh:
    """The job's mesh over `local`, this rank's shards (default: the card
    init() chose, or the current one; raises without a card)."""
    if local is None:
        if not torch.cuda.is_available():
            raise RuntimeError("multihost: no CUDA card; pass a mesh (e.g. make_mesh(n, device='cpu'))")
        local = Mesh([torch.device("cuda", torch.cuda.current_device())], axis)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return ProcessMesh(local, rank, world)


def _comm_device(pm: ProcessMesh) -> torch.device:
    """Where the exchanged tensors lie: the rank's card for NCCL, else the host."""
    if pm.grouped and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (same shape on every rank), stacked in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts)


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def _as_bytes(t: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of a column as (n, bytes a row) uint8."""
    return t[:n].contiguous().view(torch.uint8).reshape(n, _row_bytes(t))


def _pack(cols: dict, keys: tuple, n: int) -> torch.Tensor:
    """The first n rows of `keys`' columns as one (n, row bytes) uint8 tensor."""
    return torch.cat([_as_bytes(cols[k], n) for k in keys], dim=1)


def _unpack(buf: torch.Tensor, like: dict, keys: tuple) -> dict:
    """_pack's inverse: (n, row bytes) -> the columns, dtypes and row shapes as `like`'s."""
    out, at = {}, 0
    for k in keys:
        t = like[k]
        width = _row_bytes(t)
        out[k] = buf[:, at : at + width].contiguous().view(t.dtype).reshape(buf.shape[0], *t.shape[1:])
        at += width
    return out


def _exchange_scalars(pm: ProcessMesh, values: list[torch.Tensor]) -> np.ndarray:
    """(world, len(values)) int64 on the host: every rank's scalars."""
    mine = torch.stack([v.to(torch.int64) for v in values])
    if not pm.grouped:
        return mine.cpu().numpy()[None]
    return _all_gather(mine.to(_comm_device(pm))).cpu().numpy()


def ingest_process_local(local_iq, mesh: Mesh | ProcessMesh | None = None,
                         axis: str = TIME_AXIS) -> list[torch.Tensor]:
    """This rank's span, (L, 2) int16 with L = D_local * block -> its
    shards' (block + halo, 2) buffers on their devices, each its block then
    the head of the next global shard (the next rank's, for the last),
    as halo.shard_iq lays them out. Every rank passes a span of the same
    length."""
    pm = mesh if isinstance(mesh, ProcessMesh) else global_mesh(axis, local=mesh)
    local = torch.from_numpy(np.ascontiguousarray(local_iq, dtype=np.int16)) \
        if isinstance(local_iq, np.ndarray) else local_iq.cpu()
    n_global = local.shape[0] * pm.world
    if n_global % pm.size != 0:
        raise ValueError(f"global samples {n_global} not divisible by {pm.size} devices")
    _, block, n_halo = halo._shape(pm, n_global, axis)
    # Every rank's first TUNED_HALO samples in one all_gather (as bytes: gloo takes no int16).
    head = torch.zeros((halo.TUNED_HALO, 2), dtype=torch.int16)
    head[: min(len(local), halo.TUNED_HALO)] = local[: halo.TUNED_HALO]
    if pm.grouped:
        heads = _all_gather(head.view(torch.uint8).to(_comm_device(pm))).cpu().view(torch.int16)
        head = heads.view(pm.world, halo.TUNED_HALO, 2)[(pm.rank + 1) % pm.world]
    ext = torch.cat([local, head[:n_halo]])
    shards = []
    for i, device in enumerate(pm.local.devices):
        buf = torch.empty((block + n_halo, 2), dtype=torch.int16, device=device)
        buf.copy_(ext[i * block : (i + 1) * block + n_halo])
        shards.append(buf)
    return shards


def _compact_step(pm: ProcessMesh, n_global: int, k: int, c: int, extended: bool):
    """One rank's compact step: its shards' decodes, one shard gather of
    global rows, then the exchange -> the job's compact dict of C rows
    (airjax's replicated buffer) on the backend's device."""
    _, block, n_halo = halo._shape(pm, n_global, pm.local.axis)
    count_key = "n_candidates" if extended else "n_good"
    keys = halo.EXT_COMPACT_ROW_KEYS if extended else _DF17_ROWS

    def step(shards: list[torch.Tensor]) -> dict:
        outs = halo._decode_shards(pm.local, shards, block, n_halo, k, extended)
        mine = shard_gather(outs, block, n_global - WINDOW, c, extended=extended, first_shard=pm.first_shard)
        if not pm.grouped:
            return mine
        scal = _exchange_scalars(pm, [mine[count_key], mine["n_detections"], mine["overflow"]])
        counts = np.minimum(scal[:, 0], c)  # a rank's rows past C were dropped: it overflowed
        m = max(int(counts.max()), 1)  # no empty collective: NCCL is not asked to move 0 bytes
        rows = _all_gather(_pack(mine, keys, m).to(_comm_device(pm)))
        joined = torch.cat([rows[r, : counts[r]] for r in range(pm.world)])[:c]
        buf = torch.zeros((c, joined.shape[1]), dtype=torch.uint8, device=joined.device)
        buf[: len(joined)] = joined
        out = _unpack(buf, mine, keys)
        total = int(scal[:, 0].sum())
        out[count_key] = torch.tensor(total, dtype=torch.int32)
        out["n_detections"] = torch.tensor(int(scal[:, 1].sum()), dtype=torch.int32)
        out["overflow"] = torch.tensor(bool(scal[:, 2].max()) or total > c)
        return out

    return step


def _dense_step(pm: ProcessMesh, n_global: int, k: int, extended: bool):
    """One rank's dense step: its shards' slots, globalized -> every rank's
    D_local * K slots in rank order, and the scalars over the job."""
    _, block, n_halo = halo._shape(pm, n_global, pm.local.axis)
    keys = halo.EXT_DENSE_KEYS if extended else _DF17_DENSE

    def step(shards: list[torch.Tensor]) -> dict:
        outs = halo._decode_shards(pm.local, shards, block, n_halo, k, extended)
        mine = halo.dense_rows(outs, block, n_global, extended, first_shard=pm.first_shard)
        if not pm.grouped:
            return mine
        n_good = mine["n_good"] if not extended else torch.zeros((), dtype=torch.int32)
        scal = _exchange_scalars(pm, [n_good, mine["n_detections"], mine["overflow"]])
        n = len(mine["offsets"])
        rows = _all_gather(_pack(mine, keys, n).to(_comm_device(pm)))
        out = _unpack(rows.reshape(pm.world * n, -1), mine, keys)
        if not extended:
            out["n_good"] = torch.tensor(int(scal[:, 0].sum()), dtype=torch.int32)
        out["n_detections"] = torch.tensor(int(scal[:, 1].sum()), dtype=torch.int32)
        out["overflow"] = torch.tensor(bool(scal[:, 2].max()))
        return out

    return step


def _prepare(local_iq, mesh: Mesh | None, axis: str) -> tuple[ProcessMesh, int, int, list[torch.Tensor]]:
    """(the job's mesh, n_global, block, this rank's shard buffers)."""
    pm = global_mesh(axis, local=mesh)
    shards = ingest_process_local(local_iq, pm, axis)
    n_global = len(local_iq) * pm.world
    return pm, n_global, n_global // pm.size, shards


def _step(pm: ProcessMesh, n_global: int, gather: str, extended: bool):
    """make_step(k, c) for halo.collect_df17 / collect_extended: the
    compact or the dense step of the job."""
    def make_step(k: int, c: int):
        if gather == "compact":
            return _compact_step(pm, n_global, k, c, extended)
        return _dense_step(pm, n_global, k, extended)

    return make_step


def decode_capture(
    local_iq, capacity_per_shard: int = 256, axis: str = TIME_AXIS, gather: str = "compact",
    compact_capacity: int | None = None, *, mesh: Mesh | None = None,
):
    """Decode a capture whose span is split over the job's processes
    (airjax :60-182). Every rank calls it with its own contiguous span (of
    equal sizes) and, by keyword, `mesh`, its shards (default: the card
    global_mesh takes) -> (hits, stats), the same on every rank: hits (0,
    global_offset, frame_bytes, recovered) in offset order;
    stats n_detections, n_good, overflow, capacity_per_shard, and
    compact_capacity, fetched_bytes (compact), processes, devices."""
    pm, n_global, block, shards = _prepare(local_iq, mesh, axis)
    hits, stats = halo.collect_df17(_step(pm, n_global, gather, False), shards, capacity_per_shard,
                                    compact_capacity or max(128, capacity_per_shard), block, pm.size,
                                    n_global - WINDOW, gather)
    return hits, {**stats, "processes": pm.world, "devices": pm.size}


def _gather_extended_arrays(
    local_iq, mesh: Mesh | None, capacity_per_shard: int, axis: str, gather: str = "compact",
    compact_capacity: int | None = None,
) -> tuple[dict, dict, ProcessMesh]:
    """The extended decode over the job, regrown on overflow (airjax
    :185-281) -> (the candidate dict every rank holds, on the host; stats;
    the job's mesh)."""
    pm, n_global, block, shards = _prepare(local_iq, mesh, axis)
    gathered, stats = halo.collect_extended(_step(pm, n_global, gather, True), shards, capacity_per_shard,
                                            compact_capacity or max(512, capacity_per_shard), block, pm.size,
                                            n_global - WINDOW, gather)
    return gathered, {**stats, "processes": pm.world, "devices": pm.size}, pm


def decode_capture_extended(
    local_iq, capacity_per_shard: int = 2048, axis: str = TIME_AXIS, now: float = 0.0, cache=None,
    gather: str = "compact", *, mesh: Mesh | None = None,
):
    """The extended decode (every Mode S downlink format) of a capture
    split over the job (airjax :284-312) -> ([(global_offset, packet)],
    stats), the same on every rank: airjax_torch.extended.assemble_extended
    over the gathered candidates, the ICAO cache seeing every CRC-validated
    frame of the capture before any AP candidate is gated."""
    gathered, stats, _ = _gather_extended_arrays(local_iq, mesh, capacity_per_shard, axis, gather=gather)
    packets = assemble_extended(gathered, now, cache if cache is not None else IcaoCache())
    return packets, stats


def attach_candidate_fields(gathered: dict, *, device: torch.device | str = "cuda") -> dict:
    """Add `fields` and `short_fields` to a gathered extended candidate
    dict (numpy), in place (airjax :315-332): one block_fields launch over
    its frames and raw frames on `device`, the input of
    track.batch.ExtendedBatchTracker.on_extended_block."""
    fields, short = block_fields(torch.as_tensor(gathered["frames"]).to(device),
                                 torch.as_tensor(gathered["frames_raw"]).to(device))
    gathered["fields"], gathered["short_fields"] = to_host(fields), to_host(short)
    return gathered


def decode_capture_extended_batched(
    local_iq, tracker, capacity_per_shard: int = 2048, axis: str = TIME_AXIS, now: float = 0.0, cache=None,
    gather: str = "compact", *, mesh: Mesh | None = None,
):
    """The extended decode of a capture split over the job into a batched
    tracker (airjax :335-360): every rank gathers the same candidates, adds
    their fields and applies one on_extended_block to its `tracker`
    (track.batch.ExtendedBatchTracker), so every replica ends in the same
    state -> (messages applied, stats)."""
    gathered, stats, pm = _gather_extended_arrays(local_iq, mesh, capacity_per_shard, axis, gather=gather)
    attach_candidate_fields(gathered, device=pm.local.devices[0])
    applied = tracker.on_extended_block(gathered, now, cache if cache is not None else IcaoCache())
    return applied, stats
