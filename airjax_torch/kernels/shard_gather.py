"""Shard-gather kernel wrapper: the D shards' block-decode dicts of a
sharded decode -> one offset-sorted buffer of C rows, in one launch.

No Pallas ancestor: on the TPU, XLA fuses airjax/parallel/halo.py::
_compact_local (:259), _global_base (:322) and _scatter_to_global (:269),
which end in an all_gather of the shard counts and a psum of zero-padded
rows. Here it is csrc/shard_gather.cu, on the mesh's first device, and its
plain version `shard_gather_plain` is the same function in torch.

Shard s's slot r is selected when it is valid, its global offset
offsets[r] + (first_shard + s) * block is at most `max_offset` and, DF17,
it is `good`
(airjax/parallel/halo.py:376) or, extended, one of the six classes of
`MASK_KEYS` is set (:561-566). The selected slots keep their order, shard
by shard, so the rows come out sorted by offset; a row whose place is C or
more is dropped, the rows from the total up to C are zero, as the psum
leaves them. The result is airjax's compact dict: DF17 `offsets`,
`recovered`, `frames`, `n_good`, `n_detections`, `overflow`; extended
`offsets`, `classmask` (bit c = MASK_KEYS[c]), `df`, `icao_ap_short`,
`icao_ap_long`, `frames`, `frames_raw`, `n_candidates`, `n_detections`,
`overflow`; with recover2 also `recovered2`. `overflow` is any shard's
overflow or a total above C (:416, :612). `first_shard` is the global
index of the first dict: a process of the multi-process decode
(parallel/multihost.py) gathers its own shards into rows that are already
global (0 in one process).

`shard_gather` launches the kernel when the shards lie on one CUDA device
and runs `shard_gather_plain` when they lie on the CPU. `launches` counts
kernel launches.
"""

from __future__ import annotations

import torch

from airjax_torch._dispatch import check_launch, use_kernel
from airjax_torch.kernels.candidate import CLASSES
from airjax_torch.protocol.crc import FRAME_BYTES

launches = 0
MAX_SHARDS = 32  # csrc/shard_gather.cu kMaxShards
MASK_KEYS = CLASSES  # airjax/parallel/halo.py _EXT_MASK_KEYS, in its order
_DF17_KEYS = ("offsets", "valid", "good", "recovered", "frames", "n_detections", "overflow")
_EXT_KEYS = ("offsets", "valid", *MASK_KEYS, "df", "icao_ap_short", "icao_ap_long", "frames", "frames_raw",
             "n_detections", "overflow")


def _selection(shard: dict, index: int, block: int, max_offset: int, extended: bool) -> torch.Tensor:
    """(K,) int32: 0, or the slot's selection (1 for DF17, the packed classes)."""
    in_range = shard["valid"] & (shard["offsets"].to(torch.int64) + index * block <= max_offset)
    if not extended:
        return (shard["good"] & in_range).to(torch.int32)
    mask = torch.zeros_like(shard["offsets"])
    for c, key in enumerate(MASK_KEYS):
        mask |= (shard[key] & in_range).to(torch.int32) << c
    return mask


def shard_gather_plain(
    shards: list[dict], block: int, max_offset: int, capacity: int, *, extended: bool = False,
    recover2: bool = False, first_shard: int = 0,
) -> dict[str, torch.Tensor]:
    """Plain torch version: each shard's selected slots (nonzero), their
    rows concatenated in shard order, the first C of them at the front of a
    zero (C,) buffer."""
    rows: dict[str, list[torch.Tensor]] = {}
    for i, shard in enumerate(shards, first_shard):
        mask = _selection(shard, i, block, max_offset, extended)
        sel = torch.nonzero(mask).flatten()
        picked = {"offsets": shard["offsets"][sel] + i * block, "frames": shard["frames"][sel]}
        if extended:
            picked.update(classmask=mask[sel].to(torch.uint8), frames_raw=shard["frames_raw"][sel],
                          **{key: shard[key][sel] for key in ("df", "icao_ap_short", "icao_ap_long")})
        else:
            picked["recovered"] = shard["recovered"][sel]
        if recover2:
            picked["recovered2"] = shard["recovered2"][sel]
        for key, v in picked.items():
            rows.setdefault(key, []).append(v)
    total = sum(int(v.shape[0]) for v in rows["offsets"])
    out = {}
    for key, parts in rows.items():
        v = torch.cat(parts)[:capacity]
        buf = torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        buf[: v.shape[0]] = v
        out[key] = buf
    dev = shards[0]["offsets"].device
    out["n_candidates" if extended else "n_good"] = torch.tensor(total, dtype=torch.int32, device=dev)
    out["n_detections"] = torch.stack([s["n_detections"] for s in shards]).sum(dtype=torch.int32)
    out["overflow"] = torch.stack([s["overflow"] for s in shards]).any() | (total > capacity)
    return out


def shard_gather(
    shards: list[dict], block: int, max_offset: int, capacity: int, *, extended: bool = False,
    recover2: bool = False, first_shard: int = 0,
) -> dict[str, torch.Tensor]:
    """The D shards' block-decode dicts (capacity K each; shard s covers
    global offsets (first_shard + s) * block + [0, block)) -> airjax's compact dict of
    capacity C = `capacity` (module docstring). The dicts are those of
    pipeline.decode_iq_block(_extended), with `recovered2` under recover2."""
    if not shards:
        raise ValueError("shard_gather: no shards")
    if capacity < 0 or block < 0 or first_shard < 0:
        raise ValueError(f"shard_gather: capacity {capacity}, block {block}, first shard {first_shard}")
    keys = (_EXT_KEYS if extended else _DF17_KEYS) + (("recovered2",) if recover2 else ())
    k = shards[0]["offsets"].shape[0]
    for shard in shards:
        missing = [key for key in keys if key not in shard]
        if missing:
            raise ValueError(f"shard_gather: a shard lacks {missing}")
        if any(shard[key].shape[:1] != (k,) for key in keys if shard[key].dim()):
            raise ValueError("shard_gather: the shards' capacities differ")
    if use_kernel(*(shard[key] for shard in shards for key in keys)):
        return _shard_gather_cuda(shards, keys, k, block, max_offset, capacity, extended, recover2, first_shard)
    return shard_gather_plain(shards, block, max_offset, capacity, extended=extended, recover2=recover2,
                              first_shard=first_shard)


def _pointer(t: torch.Tensor | None, dtype: torch.dtype, shape: tuple) -> int | None:
    if t is None:
        return None
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"shard_gather: expected {dtype} {shape} contiguous, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def _shard_gather_cuda(
    shards: list[dict], keys: tuple, k: int, block: int, max_offset: int, capacity: int, extended: bool,
    recover2: bool, first_shard: int = 0,
) -> dict[str, torch.Tensor]:
    global launches
    import ctypes

    from airjax_torch._build import library

    if len(shards) > MAX_SHARDS:
        raise ValueError(f"shard_gather: the kernel takes at most {MAX_SHARDS} shards, got {len(shards)}")
    lib = library()
    device = shards[0]["offsets"].device
    vec, frame = (k,), (k, FRAME_BYTES)
    ptrs = []
    for shard in shards:
        if extended:
            # The kernel reads the six classes as one (6, K) block.
            first = shard[MASK_KEYS[0]]
            if any(shard[key].data_ptr() != first.data_ptr() + c * k for c, key in enumerate(MASK_KEYS)):
                raise ValueError("shard_gather: the extended classes are not one (6, K) block")
        ptrs += [
            _pointer(shard["offsets"], torch.int32, vec), _pointer(shard["valid"], torch.bool, vec),
            _pointer(shard[MASK_KEYS[0]] if extended else shard["good"], torch.bool, vec),
            None if extended else _pointer(shard["recovered"], torch.bool, vec),
            _pointer(shard["frames"], torch.uint8, frame),
            *((_pointer(shard["frames_raw"], torch.uint8, frame), _pointer(shard["df"], torch.int32, vec),
               _pointer(shard["icao_ap_short"], torch.int32, vec), _pointer(shard["icao_ap_long"], torch.int32, vec))
              if extended else (None,) * 4),
            _pointer(shard["recovered2"], torch.bool, vec) if recover2 else None,
            _pointer(shard["n_detections"], torch.int32, ()), _pointer(shard["overflow"], torch.bool, ()),
        ]
    c = capacity
    # One int32 and one byte buffer, sliced into the outputs.
    n_int = (4 if extended else 1) * c + 2
    n_byte = c * (2 * FRAME_BYTES + 1 if extended else FRAME_BYTES + 1) + (c if recover2 else 0) + 1
    ints = torch.empty(n_int, dtype=torch.int32, device=device)
    byts = torch.empty(n_byte, dtype=torch.uint8, device=device)
    out = {"offsets": ints[:c]}
    if extended:
        out.update(classmask=byts[:c], df=ints[c : 2 * c], icao_ap_short=ints[2 * c : 3 * c],
                   icao_ap_long=ints[3 * c : 4 * c], frames=byts[c : c + FRAME_BYTES * c].view(c, FRAME_BYTES),
                   frames_raw=byts[c + FRAME_BYTES * c : c + 2 * FRAME_BYTES * c].view(c, FRAME_BYTES))
        end = c + 2 * FRAME_BYTES * c
    else:
        out.update(recovered=byts[:c].view(torch.bool), frames=byts[c : c + FRAME_BYTES * c].view(c, FRAME_BYTES))
        end = c + FRAME_BYTES * c
    if recover2:
        out["recovered2"] = byts[end : end + c].view(torch.bool)
    count_key = "n_candidates" if extended else "n_good"
    out[count_key], out["n_detections"] = ints[-2], ints[-1]
    out["overflow"] = byts[-1:].view(torch.bool)[0]
    out_ptrs = [out["offsets"].data_ptr(), None if extended else out["recovered"].data_ptr(),
                out["classmask"].data_ptr() if extended else None, out["frames"].data_ptr(),
                *((out[key].data_ptr() for key in ("frames_raw", "df", "icao_ap_short", "icao_ap_long")) if extended
                  else (None,) * 4),
                out["recovered2"].data_ptr() if recover2 else None,
                out[count_key].data_ptr(), out["n_detections"].data_ptr(), out["overflow"].data_ptr()]
    shard_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    out_arr = (ctypes.c_void_p * len(out_ptrs))(*out_ptrs)
    with torch.cuda.device(device):
        rc = lib.airjax_shard_gather(shard_arr, len(shards), k, c, block, max_offset, out_arr, int(extended),
                                     int(recover2), first_shard, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "shard-gather kernel")
    launches += 1
    return out
