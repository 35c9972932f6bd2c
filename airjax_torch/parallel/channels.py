"""Multi-channel decode: independent receivers split over a mesh
(airjax/parallel/channels.py).

Each channel is one antenna's IQ stream: no halo between channels. The
channels are split over the mesh's devices in order, and a device decodes
its channels one after another, one front and block-decode launch pair a
channel (pipeline.decode_iq_block, or decode_iq_block_extended), on its
current stream. airjax decodes its local channels with `lax.map` in
sequence too (:40-45). A channel index in the kernels' grids instead
waits in queue B.
"""

from __future__ import annotations

import numpy as np
import torch

from airjax_torch.dsp.demod import WINDOW
from airjax_torch.extended import assemble_extended
from airjax_torch.parallel.mesh import Mesh
from airjax_torch.pipeline import decode_iq_block, decode_iq_block_extended, to_host
from airjax_torch.track.icao_cache import IcaoCache

CHANNEL_AXIS = "c"


def _channel_step(mesh: Mesh, n_channels: int, block_len: int, capacity: int, axis: str, decode):
    n_dev = mesh.shape[axis]
    if n_channels % n_dev != 0:
        raise ValueError(f"{n_channels} channels not divisible by {n_dev} devices")
    per_device = n_channels // n_dev

    def step(iq) -> dict[str, torch.Tensor]:
        """(n_channels, block_len + 239, 2) int16 IQ, numpy or a tensor ->
        the decode's dict with a leading channel axis, on the mesh's
        first device."""
        src = torch.from_numpy(np.ascontiguousarray(iq, dtype=np.int16)) if isinstance(iq, np.ndarray) else iq
        outs = []
        for ch in range(n_channels):
            # A fresh buffer on the channel's device keeps the front's base aligned.
            ext = torch.empty(tuple(src.shape[1:]), dtype=torch.int16, device=mesh.devices[ch // per_device])
            ext.copy_(src[ch])
            outs.append(decode(ext, block_len, capacity))
        first = mesh.devices[0]
        return {k: torch.stack([out[k].to(first) for out in outs]) for k in outs[0]}

    return step


def build_channel_decoder(mesh: Mesh, n_channels: int, block_len: int, capacity: int, axis: str = CHANNEL_AXIS):
    """A step for (n_channels, block_len + 239, 2) int16 batches (airjax
    :23-70) -> per-channel candidate dicts with a leading channel axis
    (offsets are channel-local)."""
    return _channel_step(mesh, n_channels, block_len, capacity, axis, decode_iq_block)


def build_channel_decoder_extended(
    mesh: Mesh, n_channels: int, block_len: int, capacity: int, axis: str = CHANNEL_AXIS
):
    """The extended channel step (airjax :116-161): decode_iq_block_extended
    per channel, the dicts with a leading channel axis."""
    return _channel_step(mesh, n_channels, block_len, capacity, axis, decode_iq_block_extended)


def _decode_all(build, iq_channels, mesh: Mesh, capacity: int, axis: str):
    """(channels' host arrays, n, or None when too short) through the step,
    regrowing the capacity 4x while any channel overflows (airjax :95-100)."""
    arr = np.asarray(iq_channels, dtype=np.int16)
    c, n, _ = arr.shape
    block_len = n - (WINDOW - 1) if n > WINDOW - 1 else 0
    if block_len <= 0:
        return None, n
    out = to_host(build(mesh, c, block_len, capacity, axis)(arr))
    while bool(np.any(out["overflow"])) and capacity < block_len:
        capacity = min(capacity * 4, block_len)
        out = to_host(build(mesh, c, block_len, capacity, axis)(arr))
    return out, n


def decode_channels(iq_channels, mesh: Mesh, capacity: int = 1024, axis: str = CHANNEL_AXIS):
    """A (C, L, 2) multi-channel capture -> one list a channel of (0,
    offset, frame_bytes, recovered) hits in offset order (airjax :73-113)."""
    out, n = _decode_all(build_channel_decoder, iq_channels, mesh, capacity, axis)
    if out is None:
        return [[] for _ in range(len(iq_channels))]
    max_offset = n - WINDOW
    results = []
    for ch in range(out["offsets"].shape[0]):
        hits = []
        for k in np.nonzero(out["good"][ch])[0]:
            off = int(out["offsets"][ch][k])
            if off <= max_offset:
                hits.append((0, off, out["frames"][ch][k].tobytes(), bool(out["recovered"][ch][k])))
        results.append(hits)
    return results


def decode_channels_extended(
    iq_channels, mesh: Mesh, capacity: int = 2048, axis: str = CHANNEL_AXIS, now: float = 0.0
):
    """A (C, L, 2) capture in the extended mode -> one [(offset, packet)]
    list a channel through assemble_extended, each channel with its own
    ICAO cache (independent receivers; airjax :164-199)."""
    out, _ = _decode_all(build_channel_decoder_extended, iq_channels, mesh, capacity, axis)
    if out is None:
        return [[] for _ in range(len(iq_channels))]
    return [assemble_extended({k: v[ch] for k, v in out.items()}, now, IcaoCache())
            for ch in range(out["offsets"].shape[0])]
