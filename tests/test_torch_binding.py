"""The kernel wrappers' calls into the C library, on the CPU: each passes
exactly the arguments its entry point is bound with (ctypes passes surplus
arguments on unchecked, so one too many would shift the stream argument),
the stream last, and its outputs' pointers. The library is a stand-in that
records the calls; the kernels themselves run on the card
(tests/test_torch_cuda.py)."""

import contextlib

import numpy as np
import pytest
import torch

from airjax_torch import _build
from airjax_torch.kernels import block_decode, candidate, compact, fields, magdet, stencil3

STREAM = 0x5EED


class RecordingLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        _, argtypes = _build._SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(argtypes), f"{name}: {len(args)} arguments, bound with {len(argtypes)}"
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": STREAM})())
    monkeypatch.setattr(candidate, "_syndromes_loaded", {0})
    return fake


def _iq(n=3000):
    return torch.as_tensor(np.random.default_rng(0).integers(-99, 99, (n, 2), dtype=np.int16))


@pytest.mark.parametrize("gate", ["df17", "preamble"])
@pytest.mark.parametrize("packed", [True, False])
def test_front_call(lib, gate, packed):
    det, out = magdet._magdet_cuda(_iq(), 2500, packed, gate)
    (name, args), = lib.calls
    assert name == "airjax_magdet" and args[-1] == STREAM
    assert args[3] == det.data_ptr() and args[4] == out.data_ptr()
    assert args[6:8] == (int(packed), magdet.GATES[gate])


@pytest.mark.parametrize("gate", ["df17", "preamble"])
def test_bits_front_call(lib, gate):
    det_words, words, counts = magdet._bits_cuda(_iq(), 2500, gate)
    (name, args), = lib.calls
    assert name == "airjax_magdet_bits" and args[-1] == STREAM
    assert args[1:3] == (3000, 2500)
    assert args[3:8] == (det_words.data_ptr(), words.data_ptr(), words.numel(), counts.data_ptr(),
                         magdet.GATES[gate])
    assert (det_words.numel(), counts.numel()) == (magdet.n_det_words(2500), magdet.n_tiles(2500))


@pytest.mark.parametrize("capacity", [0, 64])
def test_compact_call(lib, capacity):
    n_off = 20000
    det_words = torch.zeros(magdet.n_det_words(n_off), dtype=torch.int32)
    counts = torch.zeros(magdet.n_tiles(n_off), dtype=torch.int32)
    offsets, valid, n_det, gather = compact._compact_cuda(det_words, counts, n_off, capacity)
    (name, args), = lib.calls
    assert name == "airjax_compact" and args[-1] == STREAM
    assert args[:4] == (det_words.data_ptr(), counts.data_ptr(), n_off, capacity)
    assert args[5:9] == (offsets.data_ptr(), valid.data_ptr(), gather.data_ptr(), n_det.data_ptr())
    assert offsets.shape == valid.shape == gather.shape == (capacity,) and n_det.shape == ()
    assert (offsets.dtype, valid.dtype, gather.dtype, n_det.dtype) == (torch.int32, torch.bool, torch.int32, torch.int32)


@pytest.mark.parametrize("variant", list(stencil3.VARIANTS))
def test_stencil_call(lib, variant):
    det, cmp = stencil3._tree_cuda(_iq(), 2500, variant)
    (name, args), = lib.calls
    assert name == "airjax_magdet_stencil" and args[-1] == STREAM
    assert args[3:6] == (det.data_ptr(), cmp.data_ptr(), stencil3.VARIANTS[variant])


@pytest.mark.parametrize("extended", [False, True])
def test_candidate_call(lib, extended):
    words = torch.zeros(200, dtype=torch.int32)
    offsets = torch.arange(5, dtype=torch.int32)
    if extended:
        valid = torch.ones(5, dtype=torch.bool)
        out = candidate._candidates_cuda(words, offsets, valid)
        assert sorted(out) == sorted(["df", "frames", "frames_raw", "icao_ap_short", "icao_ap_long",
                                      *candidate.CLASSES])
    else:
        out = candidate._candidates_cuda(words, offsets)
        assert len(out) == 3
    (name, args), = lib.calls
    assert name == "airjax_candidates" and args[-1] == STREAM
    nulls = [a is None for a in args[5:13]]
    assert nulls == ([True, True] + [False] * 6 if extended else [False, False] + [True] * 6)


@pytest.mark.parametrize("with_fields", [False, True])
@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("capacity", [0, 64])
@pytest.mark.parametrize("extended", [False, True])
def test_block_decode_call(lib, extended, capacity, recover2, with_fields):
    n_off = 20000
    det_words = torch.zeros(magdet.n_det_words(n_off), dtype=torch.int32)
    words = torch.zeros(700, dtype=torch.int32)
    counts = torch.zeros(magdet.n_tiles(n_off), dtype=torch.int32)
    out = block_decode._block_decode_cuda(det_words, words, counts, n_off, capacity, extended, recover2, with_fields)
    (name, args), = lib.calls
    assert name == "airjax_block_decode" and args[-1] == STREAM
    assert args[-4:-1] == (int(extended), int(recover2), int(with_fields))  # the kernel's Mode, R2, F
    if recover2:
        pairs = block_decode._pairs(det_words.device)
        assert args[19:21] == (out.pop("recovered2").data_ptr(), pairs.data_ptr())
        assert np.array_equal(pairs.numpy().view(np.uint32), block_decode.pair_hash_table().reshape(-1))
    else:
        assert args[19:21] == (None, None) and "recovered2" not in out
    field_dicts = [out.pop("fields")] + ([out.pop("short_fields")] if extended else []) if with_fields else []
    if with_fields:
        # The fields' int32 rows and their byte buffer (callsign codes first).
        assert args[21:23] == (field_dicts[0]["df"].data_ptr(), field_dicts[0]["callsign_codes"].data_ptr())
        assert args[22] % 4 == 0
        assert sorted(field_dicts[0]) == sorted(long_extract(capacity))
        if extended:
            assert sorted(field_dicts[1]) == sorted(short_extract(capacity))
            assert field_dicts[1]["df"].data_ptr() == field_dicts[0]["df"].data_ptr() + 4 * 24 * capacity
    else:
        assert args[21:23] == (None, None) and "fields" not in out and "short_fields" not in out
    assert args[:6] == (det_words.data_ptr(), words.data_ptr(), 700, counts.data_ptr(), n_off, capacity)
    common = ("offsets", "valid", "frames", "n_detections", "overflow")
    assert args[6:11] == tuple(out[key].data_ptr() for key in common)
    if extended:
        keys = ("frames_raw", "df", "icao_ap_long", "icao_ap_short")
        assert args[11:14] == (None,) * 3 and args[14:18] == tuple(out[key].data_ptr() for key in keys)
        assert args[18] == out[block_decode.CLASSES[0]].data_ptr()
        assert sorted(out) == sorted(["offsets", "valid", "df", "frames", "frames_raw", "icao_ap_short",
                                      "icao_ap_long", "n_detections", "overflow", *candidate.CLASSES])
    else:
        assert args[11:14] == tuple(out[key].data_ptr() for key in ("good", "recovered", "n_good"))
        assert args[14:19] == (None,) * 5
        assert list(out) == ["offsets", "valid", "good", "recovered", "frames", "n_detections", "n_good",
                             "overflow"]
    ints = ("offsets", "df", "icao_ap_long", "icao_ap_short", "n_detections", "n_good")
    for key, t in out.items():
        scalar = key in ("n_detections", "n_good", "overflow")
        assert tuple(t.shape) == ((capacity, 14) if key.startswith("frames") else () if scalar else (capacity,)), key
        assert t.dtype == (torch.uint8 if key.startswith("frames") else torch.int32 if key in ints else torch.bool), key
    for key, t in (item for d in field_dicts for item in d.items()):
        want = (torch.uint8, (capacity, 8)) if key == "callsign_codes" else (
            (torch.bool, (capacity,)) if key in ("alt_mode_25", "altitude_valid") else (torch.int32, (capacity,)))
        assert (t.dtype, tuple(t.shape)) == want, key
    # The outputs are disjoint slices of two buffers.
    tensors = [*out.values(), *(t for d in field_dicts for t in d.values())]
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in tensors if t.numel())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def long_extract(k: int) -> dict:
    return fields.extract_fields(torch.zeros((k, 14), dtype=torch.uint8))


def short_extract(k: int) -> dict:
    return fields.extract_short_fields_from_raw(torch.zeros((k, 14), dtype=torch.uint8))


@pytest.mark.parametrize("k", [0, 5, 64])
@pytest.mark.parametrize("extended", [False, True])
def test_fields_call(lib, extended, k):
    frames = torch.zeros((k, 14), dtype=torch.uint8)
    raw = torch.zeros((k, 14), dtype=torch.uint8) if extended else None
    long, short = fields._fields_cuda(frames, raw)
    (name, args), = lib.calls
    assert name == "airjax_fields" and args[-1] == STREAM
    assert args[:3] == (frames.data_ptr(), raw.data_ptr() if extended else None, k)
    assert sorted(long) == sorted(fields.extract_fields(frames))
    assert (sorted(short) == sorted(fields.extract_short_fields_from_raw(raw))) if extended else short is None
    for key, t in {**long, **(short or {})}.items():
        want = (torch.uint8, (k, 8)) if key == "callsign_codes" else (
            (torch.bool, (k,)) if key in ("alt_mode_25", "altitude_valid") else (torch.int32, (k,)))
        assert (t.dtype, tuple(t.shape)) == want, key
    if k:
        # Views of one int32 and one byte buffer, the callsign codes first
        # (their 4-byte stores need the buffer's alignment).
        assert long["callsign_codes"].data_ptr() == args[4]
        spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                       for t in {**long, **(short or {})}.values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("capacity", [0, 10])
def test_shard_gather_call(lib, extended, recover2, capacity):
    """12 pointers a shard in csrc/shard_gather.cu's `Shard` order, the 12 of
    `Out`, the flags and the stream; the outputs disjoint slices of two
    buffers, with airjax's keys, dtypes and shapes."""
    from airjax_torch.kernels import shard_gather

    n_off, k = 2000, 16
    shards = []
    for _ in range(3):
        det_words = torch.zeros(magdet.n_det_words(n_off), dtype=torch.int32)
        counts = torch.zeros(magdet.n_tiles(n_off), dtype=torch.int32)
        shards.append(block_decode._block_decode_cuda(det_words, torch.zeros(100, dtype=torch.int32), counts, n_off,
                                                      k, extended, recover2))
    lib.calls.clear()
    out = shard_gather._shard_gather_cuda(shards, tuple(shards[0]), k, n_off, 3 * n_off - 240, capacity, extended,
                                          recover2)
    (name, args), = lib.calls
    assert name == "airjax_shard_gather" and args[-1] == STREAM
    assert args[1:6] == (3, k, capacity, n_off, 3 * n_off - 240) and args[7:9] == (int(extended), int(recover2))
    ptrs = list(args[0])
    assert len(ptrs) == 36
    for s, shard in enumerate(shards):
        p = ptrs[12 * s : 12 * s + 12]
        keys = ("offsets", "valid", shard_gather.MASK_KEYS[0] if extended else "good",
                None if extended else "recovered", "frames", *(("frames_raw", "df", "icao_ap_short", "icao_ap_long")
                                                               if extended else (None,) * 4),
                "recovered2" if recover2 else None, "n_detections", "overflow")
        assert p == [None if key is None else shard[key].data_ptr() for key in keys]
    count_key = "n_candidates" if extended else "n_good"
    out_keys = ("offsets", None if extended else "recovered", "classmask" if extended else None, "frames",
                *(("frames_raw", "df", "icao_ap_short", "icao_ap_long") if extended else (None,) * 4),
                "recovered2" if recover2 else None, count_key, "n_detections", "overflow")
    assert list(args[6]) == [None if key is None else out[key].data_ptr() or None for key in out_keys]  # NULL: None
    want = {"offsets": (torch.int32, (capacity,)), "frames": (torch.uint8, (capacity, 14)),
            count_key: (torch.int32, ()), "n_detections": (torch.int32, ()), "overflow": (torch.bool, ())}
    if extended:
        want.update(classmask=(torch.uint8, (capacity,)), frames_raw=(torch.uint8, (capacity, 14)),
                    **{key: (torch.int32, (capacity,)) for key in ("df", "icao_ap_short", "icao_ap_long")})
    else:
        want["recovered"] = (torch.bool, (capacity,))
    if recover2:
        want["recovered2"] = (torch.bool, (capacity,))
    assert {key: (t.dtype, tuple(t.shape)) for key, t in out.items()} == want
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in out.values() if t.numel())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
