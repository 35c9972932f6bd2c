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

With `with_fields` the dict also holds the rows' protocol fields, as
airjax's builders with `with_fields` (:417-423, :613-620) run
extract_fields (and, extended, extract_short_fields_from_raw) over the
whole C-row buffer, zero rows included: `fields` (and `short_fields`), in
kernels/fields.py::field_views' layout. On the card they are the kernel's
flag F, in the same launch; its plain version runs
kernels/fields.py::block_fields_plain over the gathered rows.

`shard_gather` launches the kernel when the shards lie on one CUDA device
and runs `shard_gather_plain` when they lie on the CPU;
`shard_gather_into` does the same into two buffers the caller keeps (a
CUDA graph's outputs, parallel/halo.py::StepGraphs). `gather_layout` is
the one definition of where each key of the dict lies in those two
buffers: the device wrapper's views and the host's views of a fetched
copy are both built from it. `launches` counts kernel launches,
`fields_launches` those with F.
"""

from __future__ import annotations

import functools

import torch

from airjax_torch._dispatch import check_launch, use_kernel
from airjax_torch.kernels import candidate
from airjax_torch.kernels.candidate import CLASSES
from airjax_torch.kernels.fields import (
    DictLayout,
    block_fields_plain,
    check_layout_buffers,
    field_layout,
    field_sizes,
    fill_layout,
    layout_views,
)
from airjax_torch.protocol.crc import FRAME_BYTES

launches = 0
fields_launches = 0
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
    recover2: bool = False, first_shard: int = 0, with_fields: bool = False,
) -> dict:
    """Plain torch version: each shard's selected slots (nonzero), their
    rows concatenated in shard order, the first C of them at the front of a
    zero (C,) buffer; with_fields, block_fields_plain of its frames."""
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
    if with_fields:
        fields, short = block_fields_plain(out["frames"], out["frames_raw"] if extended else None)
        out["fields"] = fields
        if extended:
            out["short_fields"] = short
    return out


@functools.cache
def gather_layout(capacity: int, extended: bool = False, recover2: bool = False,
                  with_fields: bool = False) -> DictLayout:
    """The one definition of the compact dict's layout in the kernel's two
    buffers (csrc/shard_gather.cu's Out and Fields), read on the device by
    shard_gather and on the host by a fetch of the buffers
    (parallel/halo.py::StepGraphs). The int32 buffer: offsets (C), the
    extended df, icao_ap_short and icao_ap_long (C each), F's int rows, then
    the count (n_good, or extended n_candidates) and n_detections. The byte
    buffer: F's bytes first (its callsign codes take 4-byte stores), then
    DF17's recovered or the extended classmask (C), frames (C, 14), the
    extended frames_raw (C, 14), recovered2 (R2), and last overflow."""
    c = capacity
    cols = 4 if extended else 1
    f_int, f_byte = field_sizes(c, extended) if with_fields else (0, 0)
    n_int = cols * c + f_int + 2
    n_byte = f_byte + c * (2 * FRAME_BYTES + 1 if extended else FRAME_BYTES + 1) + (c if recover2 else 0) + 1

    def i(key, start, shape=(c,)):
        return ((key,), "i", start, shape, False)

    def by(key, start, shape=(c,), as_bool=False):
        return ((key,), "b", start, shape, as_bool)

    frames = f_byte + c
    entries = [i("offsets", 0), by("frames", frames, (c, FRAME_BYTES))]
    if extended:
        entries += [by("classmask", f_byte), i("df", c), i("icao_ap_short", 2 * c), i("icao_ap_long", 3 * c),
                    by("frames_raw", frames + FRAME_BYTES * c, (c, FRAME_BYTES))]
        end = frames + 2 * FRAME_BYTES * c
    else:
        entries.append(by("recovered", f_byte, as_bool=True))
        end = frames + FRAME_BYTES * c
    if recover2:
        entries.append(by("recovered2", end, as_bool=True))
    entries += [i("n_candidates" if extended else "n_good", n_int - 2, ()), i("n_detections", n_int - 1, ()),
                by("overflow", n_byte - 1, (), True)]
    if with_fields:
        entries += [(path, buf, start + (cols * c if buf == "i" else 0), shape, as_bool)
                    for path, buf, start, shape, as_bool in field_layout(c, extended)]
    return DictLayout(n_int, n_byte, tuple(entries))


def _check_shards(shards: list[dict], block: int, capacity: int, first_shard: int, extended: bool,
                  recover2: bool) -> tuple[tuple, int]:
    """Raise on shards the gather does not take -> (the keys it reads, K)."""
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
    return keys, k


def shard_gather(
    shards: list[dict], block: int, max_offset: int, capacity: int, *, extended: bool = False,
    recover2: bool = False, first_shard: int = 0, with_fields: bool = False,
) -> dict:
    """The D shards' block-decode dicts (capacity K each; shard s covers
    global offsets (first_shard + s) * block + [0, block)) -> airjax's compact dict of
    capacity C = `capacity` (module docstring), with_fields also its
    `fields` (and, extended, `short_fields`). The dicts are those of
    pipeline.decode_iq_block(_extended), with `recovered2` under recover2.
    On the card the dict is views of the kernel's two buffers
    (`gather_layout`)."""
    keys, k = _check_shards(shards, block, capacity, first_shard, extended, recover2)
    if use_kernel(*(shard[key] for shard in shards for key in keys)):
        return _shard_gather_cuda(shards, keys, k, block, max_offset, capacity, extended, recover2, first_shard,
                                  with_fields)
    return shard_gather_plain(shards, block, max_offset, capacity, extended=extended, recover2=recover2,
                              first_shard=first_shard, with_fields=with_fields)


def shard_gather_into(
    shards: list[dict], block: int, max_offset: int, capacity: int, ints: torch.Tensor, byts: torch.Tensor, *,
    extended: bool = False, recover2: bool = False, first_shard: int = 0, with_fields: bool = False,
) -> None:
    """shard_gather writing its dict into `ints` (int32) and `byts`
    (uint8), buffers of `gather_layout`'s sizes on the shards' device that
    the caller keeps (a CUDA graph's static outputs); `layout_views` reads
    the dict back from them. On the card one launch; on the CPU the plain
    version's dict is copied in."""
    keys, k = _check_shards(shards, block, capacity, first_shard, extended, recover2)
    lay = gather_layout(capacity, extended, recover2, with_fields)
    check_layout_buffers(lay, ints, byts, shards[0]["offsets"].device)
    if use_kernel(*(shard[key] for shard in shards for key in keys)):
        _shard_gather_cuda(shards, keys, k, block, max_offset, capacity, extended, recover2, first_shard,
                           with_fields, (ints, byts))
        return
    fill_layout(layout_views(lay.entries, ints, byts),
                shard_gather_plain(shards, block, max_offset, capacity, extended=extended, recover2=recover2,
                                   first_shard=first_shard, with_fields=with_fields))


def _pointer(t: torch.Tensor | None, dtype: torch.dtype, shape: tuple) -> int | None:
    if t is None:
        return None
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"shard_gather: expected {dtype} {shape} contiguous, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def _shard_gather_cuda(
    shards: list[dict], keys: tuple, k: int, block: int, max_offset: int, capacity: int, extended: bool,
    recover2: bool, first_shard: int = 0, with_fields: bool = False, buffers: tuple | None = None,
) -> dict:
    """One launch into `buffers` (ints, byts), or into two it allocates,
    laid out by gather_layout -> the dict's views of them."""
    global launches, fields_launches
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
    lay = gather_layout(capacity, extended, recover2, with_fields)
    if buffers is None:
        buffers = (torch.empty(lay.n_int, dtype=torch.int32, device=device),
                   torch.empty(lay.n_byte, dtype=torch.uint8, device=device))
    ints, byts = buffers
    out = layout_views(lay.entries, ints, byts)

    def ptr(key, here=True):
        return out[key].data_ptr() if here else None

    count_key = "n_candidates" if extended else "n_good"
    out_ptrs = [ptr("offsets"), ptr("recovered", not extended), ptr("classmask", extended), ptr("frames"),
                *(ptr(key, extended) for key in ("frames_raw", "df", "icao_ap_short", "icao_ap_long")),
                ptr("recovered2", recover2), ptr(count_key), ptr("n_detections"), ptr("overflow")]
    f_ptrs = (None, None)
    if with_fields:
        # F's two buffers: the fields' int32 rows from the first (df), their
        # bytes from the callsign codes (field_layout). Pointer arithmetic,
        # not the views' data_ptr(), which is 0 when C is.
        start = {path: start for path, _, start, _, _ in lay.entries}
        f_ptrs = (ints.data_ptr() + 4 * start[("fields", "df")], byts.data_ptr() + start[("fields", "callsign_codes")])
    shard_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    out_arr = (ctypes.c_void_p * len(out_ptrs))(*out_ptrs)
    with torch.cuda.device(device):
        if with_fields and extended:
            candidate.load_syndromes(lib)  # F's short CRC reads this kernel's copy
        rc = lib.airjax_shard_gather(shard_arr, len(shards), k, capacity, block, max_offset, out_arr, int(extended),
                                     int(recover2), first_shard, *f_ptrs, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "shard-gather kernel")
    launches += 1
    fields_launches += with_fields
    return out
