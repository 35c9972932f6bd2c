"""Fields kernel wrapper: a block's frames -> every protocol field of every
slot, in one launch.

No Pallas ancestor: on the TPU, XLA fuses airjax/protocol/fields.py::
extract_fields (:36-143) into the batched decode program
(airjax/pipeline.py:287-304), and the extended one also
airjax/protocol/shortframe.py::extract_short_fields_from_raw (:337-349) of
the raw frames (:307-328). Here both are csrc/fields.cuh, run by the
block-decode kernel's F flag (kernels/block_decode.py::decode_block_bits
(fields=True)), so a batched pass is two launches. csrc/fields.cu runs the
same code as a kernel of its own, one thread per slot over all K slots
(airjax computes the fields of invalid slots too): the F flag's A/B
baseline and second oracle, launched by no decode path.

`block_fields` launches the kernel for CUDA tensors and runs
`block_fields_plain` (the plain torch extract_fields and
extract_short_fields_from_raw) for CPU tensors. Both kernels write one
int32 (rows, K) buffer and one byte buffer; the dicts hold views of them
(`field_views`, laid out by `field_layout`) under airjax's keys and dtypes (airjax's uint32 CRC fields
as int32). `launches` counts this kernel's launches, both modes together.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from airjax_torch._dispatch import check_launch, check_tensor, use_kernel
from airjax_torch.kernels import candidate
from airjax_torch.protocol.crc import FRAME_BYTES
from airjax_torch.protocol.fields import extract_fields
from airjax_torch.protocol.shortframe import extract_short_fields_from_raw

launches = 0

# The int32 rows of the kernels' buffer, in their order (csrc/fields.cuh).
LONG_ROWS = (
    "df", "subformat", "capability", "icao", "msg_type", "msg_class", "altitude_ft",
    "surveillance_status", "nic_supplement", "cpr_time", "cpr_odd", "cpr_lat", "cpr_lon",
    "msg_class_ext", "vel_subtype", "vel_sign_a", "vel_val_a", "vel_sign_b", "vel_val_b",
    "vel_vr_source_baro", "vel_vr_sign", "vel_vr_val", "vel_gbd_sign", "vel_gbd_val",
)
SHORT_ROWS = (
    "df", "fs", "dr", "um", "vs", "cc", "sl", "ri", "capability", "icao_aa", "crc_calc",
    "parity_field", "icao_ap", "altitude_ft", "squawk",
)


def field_sizes(k: int, extended: bool) -> tuple[int, int]:
    """The int32 and byte buffers' lengths for K = k slots."""
    return (len(LONG_ROWS) + (len(SHORT_ROWS) if extended else 0)) * k, (10 if extended else 9) * k


def field_layout(k: int, extended: bool) -> tuple[tuple, ...]:
    """Where each field lies in the kernels' two buffers (csrc/fields.cuh),
    as `layout_views` entries: ints, the int32 (rows, K) rows, LONG_ROWS
    then SHORT_ROWS; byts, the callsign codes (K, 8), alt_mode_25 and,
    extended, altitude_valid."""
    entries = [(("fields", name), "i", r * k, (k,), False) for r, name in enumerate(LONG_ROWS)]
    entries += [(("fields", "alt_mode_25"), "b", 8 * k, (k,), True),
                (("fields", "callsign_codes"), "b", 0, (k, 8), False)]
    if extended:
        entries += [(("short_fields", name), "i", (len(LONG_ROWS) + r) * k, (k,), False)
                    for r, name in enumerate(SHORT_ROWS)]
        entries.append((("short_fields", "altitude_valid"), "b", 9 * k, (k,), True))
    return tuple(entries)


class DictLayout(NamedTuple):
    """A kernel's two output buffers: n_int int32 words and n_byte bytes,
    and where each key of its dict lies in them (`layout_views` entries):
    kernels/block_decode.py::dict_layout, kernels/shard_gather.py::
    gather_layout."""

    n_int: int
    n_byte: int
    entries: tuple[tuple, ...]


def check_layout_buffers(lay: DictLayout, ints: torch.Tensor, byts: torch.Tensor, device: torch.device) -> None:
    """Raise unless `ints` and `byts` are the int32 and byte buffers of `lay` on `device`."""
    for t, name, dtype, n in ((ints, "ints", torch.int32, lay.n_int), (byts, "byts", torch.uint8, lay.n_byte)):
        check_tensor(t, name, dtype, 1)
        if t.shape[0] != n or t.device != device:
            raise ValueError(f"{name}: expected ({n},) on {device}, got {tuple(t.shape)} on {t.device}")


def fill_layout(views: dict, values: dict) -> None:
    """Copy a dict (nested field dicts included) into `layout_views`' views
    of the same keys."""
    if views.keys() != values.keys():
        raise ValueError(f"the dict's keys {sorted(values)} are not the layout's {sorted(views)}")
    for key, v in views.items():
        fill_layout(v, values[key]) if isinstance(v, dict) else v.copy_(values[key])


def layout_views(entries, ints, byts) -> dict:
    """The dict that `entries` lays out over an int32 buffer and a uint8
    one, as views of them: torch tensors (on either device) or the numpy
    arrays a fetch copied them into. An entry is (key path, "i" or "b",
    start, shape, bool?); a path of two keys is a nested dict's entry."""
    out: dict = {}
    for path, buf, start, shape, as_bool in entries:
        v = (ints if buf == "i" else byts)[start : start + math.prod(shape)]
        if as_bool:
            v = v.view(torch.bool) if isinstance(v, torch.Tensor) else v.view(np.bool_)
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = v.reshape(shape)
    return out


def field_views(ints, byts, k: int, extended: bool) -> tuple[dict, dict | None]:
    """The dicts of block_fields over the buffers the kernels write
    (`field_layout`), torch tensors or numpy arrays alike."""
    out = layout_views(field_layout(k, extended), ints, byts)
    return out["fields"], out.get("short_fields")


def block_fields_plain(
    frames: torch.Tensor, frames_raw: torch.Tensor | None = None
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
    """Plain torch version: extract_fields(frames), and with frames_raw
    extract_short_fields_from_raw(frames_raw)."""
    short = None if frames_raw is None else extract_short_fields_from_raw(frames_raw)
    return extract_fields(frames), short


def block_fields(
    frames: torch.Tensor, frames_raw: torch.Tensor | None = None
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
    """(K, 14) uint8 frames (and, for the extended decode, (K, 14) uint8
    raw frames) -> (airjax's extract_fields dict, airjax's
    extract_short_fields_from_raw dict or None)."""
    check_tensor(frames, "frames", torch.uint8, 2)
    if frames.shape[1] != FRAME_BYTES:
        raise ValueError(f"frames: expected (K, {FRAME_BYTES}), got {tuple(frames.shape)}")
    tensors = (frames,)
    if frames_raw is not None:
        check_tensor(frames_raw, "frames_raw", torch.uint8, 2)
        if frames_raw.shape != frames.shape:
            raise ValueError(f"frames_raw: expected {tuple(frames.shape)}, got {tuple(frames_raw.shape)}")
        tensors += (frames_raw,)
    if use_kernel(*tensors):
        return _fields_cuda(frames, frames_raw)
    return block_fields_plain(frames, frames_raw)


def _fields_cuda(frames: torch.Tensor, frames_raw: torch.Tensor | None):
    global launches
    from airjax_torch._build import library

    lib = library()
    device = frames.device
    k = frames.shape[0]
    n_int, n_byte = field_sizes(k, frames_raw is not None)
    ints = torch.empty(n_int, dtype=torch.int32, device=device)
    byts = torch.empty(n_byte, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        candidate.load_syndromes(lib)  # fields.cu's copy: the short CRC
        rc = lib.airjax_fields(
            frames.data_ptr(), None if frames_raw is None else frames_raw.data_ptr(), k,
            ints.data_ptr(), byts.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_launch(rc, "fields kernel")
    if k:
        launches += 1
    return field_views(ints, byts, k, frames_raw is not None)
