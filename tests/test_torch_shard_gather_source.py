"""The shard-gather kernel's own source, run on the CPU: csrc/shard_gather.cu
compiled by the host C++ compiler against tests/cuda_emu/cuda_runtime.h
(one thread a CUDA thread, the blocks in turn), called through the
wrapper's own argument marshaling (kernels/shard_gather.py::
_shard_gather_cuda, on CPU tensors) and held against shard_gather_plain.
This checks the kernel's ranking, copies and zeroing here, and its flag F
(the rows' fields, with_fields); its launch on the card is
tests/test_torch_cuda.py's."""

import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from airjax_torch import _build
from airjax_torch.kernels import candidate
from airjax_torch.kernels import shard_gather as sg
from airjax_torch.protocol import crc

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source as a host library, bound as _build binds the
    card's, with the syndromes (flag F's short CRC) loaded into its copy."""
    src = (REPO / "airjax_torch" / "csrc" / "shard_gather.cu").read_text()
    src, n = re.subn(r"(shard_gather_kernel<kExtended, kR2, kF>)<<<(\w+), kThreads, 0, stream>>>\(([^;]*)\);",
                     r"emulate(\2, kThreads, [&] { \1(\3); });", src, flags=re.S)
    assert n == 1, "the kernel's launch statement changed form"
    src += 'extern "C" int emu_load_syndromes(const void* host) { return load_shard_gather_syndromes(host); }\n'

    tmp = tmp_path_factory.mktemp("shard_gather_emu")
    (tmp / "shard_gather.cpp").write_text(src)
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{REPO / 'tests' / 'cuda_emu'}", f"-I{REPO / 'airjax_torch' / 'csrc'}", "-o",
                    str(tmp / "libsg.so"), str(tmp / "shard_gather.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(tmp / "libsg.so"))
    restype, argtypes = _build._SIGNATURES["airjax_shard_gather"]
    lib.airjax_shard_gather.restype, lib.airjax_shard_gather.argtypes = restype, argtypes
    syn = np.ascontiguousarray(crc._tables()[1], dtype=np.uint32)
    assert lib.emu_load_syndromes(ctypes.c_void_p(syn.ctypes.data)) == 0
    return lib


@pytest.fixture
def on_cpu(emulated, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: emulated)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(candidate, "load_syndromes", lambda lib: None)  # loaded by `emulated`


def _shards(d: int, k: int, block: int, extended: bool, seed: int) -> list[dict]:
    """D shard dicts as the block decode lays them out: the valid slots
    first, offsets sorted, the six extended classes one (6, K) block."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(d):
        n = int(rng.integers(0, k + 1))
        valid = np.arange(k) < n
        offsets = np.zeros(k, np.int32)
        offsets[:n] = np.sort(rng.integers(0, block, n))
        s = {"offsets": offsets, "valid": valid,
             "frames": rng.integers(0, 256, (k, 14), np.uint8), "n_detections": np.int32(n),
             "overflow": np.bool_(rng.random() < 0.2), "recovered2": rng.random(k) < 0.3}
        if extended:
            s.update(frames_raw=rng.integers(0, 256, (k, 14), np.uint8), df=rng.integers(0, 25, k).astype(np.int32),
                     icao_ap_short=rng.integers(0, 1 << 24, k).astype(np.int32),
                     icao_ap_long=rng.integers(0, 1 << 24, k).astype(np.int32))
        else:
            s.update(good=valid & (rng.random(k) < 0.7), recovered=rng.random(k) < 0.3)
        t = {key: torch.as_tensor(v) for key, v in s.items()}
        if extended:
            t.update(zip(sg.MASK_KEYS, torch.as_tensor(rng.random((6, k)) < 0.3).unbind(0)))
        out.append(t)
    return out


def _check_source(d: int, k: int, extended: bool, recover2: bool, first_shard: int, with_fields: bool = False) -> None:
    """The emulated kernel == shard_gather_plain for C 0, below and above
    the total, with a max_offset that cuts the last shard."""
    block = 3000
    shards = _shards(d, k, block, extended, seed=d * 1000 + k)
    max_offset = (first_shard + d) * block - 240 - 311
    keys = (sg._EXT_KEYS if extended else sg._DF17_KEYS) + (("recovered2",) if recover2 else ())
    total = int(sg.shard_gather_plain(shards, block, max_offset, 1 << 20, extended=extended, first_shard=first_shard)[
        "n_candidates" if extended else "n_good"])
    for c in sorted({0, total // 2, total + 9}):
        got = sg._shard_gather_cuda(shards, keys, k, block, max_offset, c, extended, recover2, first_shard,
                                    with_fields)
        want = sg.shard_gather_plain(shards, block, max_offset, c, extended=extended, recover2=recover2,
                                     first_shard=first_shard, with_fields=with_fields)
        assert sorted(got) == sorted(want)
        for key in want:
            if key in ("fields", "short_fields"):
                assert sorted(got[key]) == sorted(want[key])
                for f in want[key]:
                    assert got[key][f].dtype == want[key][f].dtype and torch.equal(got[key][f], want[key][f]), \
                        (key, f, c)
            else:
                assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), (key, c)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("d, k", [(1, 0), (1, 37), (3, 700), (4, 2100), (2, 8194), (1, 16384)])
def test_kernel_source_equals_plain(on_cpu, d, k, extended, recover2):
    """K from 0 to several tiles (2048 rows), counted in whole steps and a
    clamped last one; C 0, below and above the total; a max_offset that
    cuts the last shard."""
    _check_source(d, k, extended, recover2, first_shard=0)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("d, k, first_shard", [(2, 700, 2), (1, 2100, 3)])
def test_kernel_source_first_shard(on_cpu, d, k, extended, recover2, first_shard):
    """A process's shards of a multi-process decode: rows global from
    first_shard * block, the range test against the global max_offset."""
    _check_source(d, k, extended, recover2, first_shard)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("d, k, first_shard", [(1, 0, 0), (1, 37, 0), (3, 700, 0), (2, 2100, 0), (2, 700, 2)])
def test_kernel_source_fields_equals_plain(on_cpu, d, k, extended, recover2, first_shard):
    """Flag F: the rows' fields (and, extended, the short fields) equal
    block_fields_plain over the plain gather's C rows, zero rows included
    (C above the total), for C 0 and below the total (an overflow), with
    the random frames taking every byte value."""
    _check_source(d, k, extended, recover2, first_shard, with_fields=True)
