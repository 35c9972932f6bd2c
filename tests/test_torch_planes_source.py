"""The planes kernel's own source, run on the CPU: csrc/planes.cu compiled
by the host C++ compiler against tests/cuda_emu/cuda_runtime.h (one fiber
a CUDA thread, the blocks in turn), called through the wrapper's own
argument marshaling (kernels/magdet.py::_planes_cuda, on CPU tensors) and
held against the plain versions: `magdet_plain(packed=False)` for the
front form (both gates), `magdet_tree_plain` for tree32, tree16 and
flat16. This checks the kernel's loads (the 16-byte vectors, word by word
at the tensor's edges and from a base 4 bytes past a 16-byte boundary),
its four formulations of the gate, its byte packing and its stores (16
bytes at a time, byte by byte at a plane's ragged end) here; its launch
on the card is tests/test_torch_cuda.py's. Every output is a byte 0 or 1:
the tolerance is exact equality. The emulator's SIMD and byte intrinsics
are held to their definitions at the end."""

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
from airjax_torch.kernels import magdet as magdet_mod
from airjax_torch.kernels.magdet import magdet_plain
from airjax_torch.kernels.stencil3 import magdet_tree_plain

REPO = pathlib.Path(__file__).resolve().parent.parent
EMU = REPO / "tests" / "cuda_emu"
CSRC = REPO / "airjax_torch" / "csrc"
BLOCK = 8192  # offsets a block (csrc/planes.cu kOffsets)


def _compile(tmp: pathlib.Path, name: str, src: str) -> ctypes.CDLL:
    (tmp / f"{name}.cpp").write_text(src)
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{EMU}", f"-I{CSRC}", "-o", str(tmp / f"lib{name}.so"),
                    str(tmp / f"{name}.cpp")], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(tmp / f"lib{name}.so"))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source as a host library, bound as _build binds the card's."""
    src = (CSRC / "planes.cu").read_text()
    src, n = re.subn(r"(planes_kernel<F, G>)<<<(\w+), kThreads, 0, stream>>>\(([^;]*)\);",
                     r"emulate(\2, kThreads, [&] { \1(\3); });", src, flags=re.S)
    assert n == 1, "the kernel's launch statement changed form"
    lib = _compile(tmp_path_factory.mktemp("planes_emu"), "planes", src)
    restype, argtypes = _build._SIGNATURES["airjax_planes"]
    lib.airjax_planes.restype, lib.airjax_planes.argtypes = restype, argtypes
    return lib


@pytest.fixture
def on_cpu(emulated, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: emulated)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0})())
    return emulated


def _iq(n: int, kind: str, seed: int) -> np.ndarray:
    """Small-range noise (ties, and detections at nearly every block edge)
    or full-range noise with the int16 extremes."""
    rng = np.random.default_rng(seed)
    if kind == "small":
        return rng.integers(-2, 3, size=(n, 2), dtype=np.int16)
    iq = rng.integers(-32768, 32768, size=(n, 2), dtype=np.int16)
    iq[: min(n, 8)] = [[-32768, -32768], [32767, 32767], [-32768, 32767], [0, 0], [1, 0], [3, 4],
                       [255, 255], [256, 256]][: min(n, 8)]
    return iq


def _plain(iq: torch.Tensor, n_off: int, form: str, gate: str) -> tuple[torch.Tensor, torch.Tensor]:
    if form == "front":
        return magdet_plain(iq, n_off, False, gate)
    return magdet_tree_plain(iq, n_off, form)


# (L, n_off, kind, misaligned): around the 8192-offset block edges, the
# cmp plane one block past the last det byte, n_off at its largest (L-25),
# n_off 0, and bases 4 bytes past a 16-byte boundary.
CASES = [
    (265, 25, "small", False),
    (25, 0, "random", False),
    (BLOCK + 1, BLOCK + 1 - 240, "small", False),  # cmp exactly one block
    (BLOCK + 2, BLOCK + 2 - 25, "random", False),  # cmp one byte into the second block
    (BLOCK + 25, BLOCK, "small", False),  # det exactly one block
    (2 * BLOCK + 777, 2 * BLOCK + 777 - 240, "small", True),
    (3 * BLOCK - 5, 3 * BLOCK - 30, "random", True),
    (BLOCK + 31, BLOCK + 6, "small", True),
]
FORM_GATES = [("front", "df17"), ("front", "preamble"), ("tree32", "df17"), ("tree16", "df17"),
              ("flat16", "df17")]


@pytest.mark.parametrize("form, gate", FORM_GATES)
@pytest.mark.parametrize("n, n_off, kind, misaligned", CASES)
def test_kernel_source_equals_plain(on_cpu, form, gate, n, n_off, kind, misaligned):
    raw = torch.as_tensor(_iq(n + misaligned, kind, n)).clone()  # torch's 64-byte aligned allocation
    iq = raw[1:] if misaligned else raw
    assert (iq.data_ptr() % 16 == 4) == misaligned
    det, cmp = magdet_mod._planes_cuda(iq, n_off, form, gate)
    want_det, want_cmp = _plain(iq, n_off, form, gate)
    assert det.dtype == cmp.dtype == torch.uint8 and det.shape == (n_off,) and cmp.shape == (n - 1,)
    assert torch.equal(det, want_det) and torch.equal(cmp, want_cmp)
    if kind == "small" and n_off > 1000:
        assert 0 < int(det.sum()) < n_off  # the gate both passes and fails


def test_kernel_source_detections_at_block_edges(on_cpu):
    """DF17-shaped pulses whose windows start just before, at and after the
    8192-offset block edges: each form finds each where its plain version
    does, and the edges' windows read the next block's magnitudes."""
    n = 2 * BLOCK + 600
    iq = np.zeros((n, 2), np.int16)
    starts = [BLOCK - 25, BLOCK - 1, BLOCK, BLOCK + 7, 2 * BLOCK - 13, 2 * BLOCK + 31]
    for s in starts:
        for tap in (0, 2, 7, 9, 16, 19, 21, 23, 24):
            iq[s + tap, 0] = 1000
    iq_t = torch.as_tensor(iq)
    for form, gate in FORM_GATES:
        det, cmp = magdet_mod._planes_cuda(iq_t, n - 240, form, gate)
        want_det, want_cmp = _plain(iq_t, n - 240, form, gate)
        assert torch.equal(det, want_det) and torch.equal(cmp, want_cmp), form
        assert set(starts) <= set(torch.nonzero(det).flatten().tolist()), form


def test_kernel_source_each_tap_decides(on_cpu):
    """The gate where one tap decides it: a DF17 pattern (highs 1000, lows
    100) with each one of its 26 taps moved just past the other level (the
    gate fails) or to a tie (it passes), every pattern at several slots of a
    thread's window (65 samples apart) and across the 8192-offset block
    edges. Each form == its plain version, both gates of the front form."""
    highs = (0, 2, 7, 9, 16, 19, 21, 23, 24)
    pattern = np.full(26, 100, np.int16)
    pattern[list(highs)] = 1000
    variants = [pattern]
    for tap in range(26):
        for level in ((99, 100) if tap in highs else (1001, 1000)):
            v = pattern.copy()
            v[tap] = level
            variants.append(v)
    n = 3 * BLOCK + 300
    iq = np.zeros((n, 2), np.int16)
    starts = range(7, n - 300, 65)
    for k, s in enumerate(starts):
        iq[s : s + 26, 0] = variants[k % len(variants)]
    iq_t = torch.as_tensor(iq)
    for form, gate in FORM_GATES:
        det, cmp = magdet_mod._planes_cuda(iq_t, n - 240, form, gate)
        want_det, want_cmp = _plain(iq_t, n - 240, form, gate)
        assert torch.equal(det, want_det) and torch.equal(cmp, want_cmp), (form, gate)
        passed = det[list(starts)].bool()
        assert 0 < int(passed.sum()) < len(starts), (form, gate)


@pytest.mark.parametrize("form, gate, det_offset, rc", [
    ("tree16", "preamble", 0, 1),  # the stencil forms run DF17 alone
    ("front", "df17", 4, 1),  # det not 16-byte aligned
    ("front", "df17", 0, 0),
])
def test_entry_point_refuses_what_the_kernel_does_not_take(emulated, form, gate, det_offset, rc):
    iq = torch.as_tensor(_iq(600, "small", 1))
    det = torch.zeros(600 + 16, dtype=torch.uint8)
    cmp = torch.zeros(600, dtype=torch.uint8)
    got = emulated.airjax_planes(iq.data_ptr(), 600, 360, det.data_ptr() + det_offset, cmp.data_ptr(),
                                 magdet_mod.FORMS[form], magdet_mod.GATES[gate], None)
    assert got == rc
    if rc:
        assert not det.any() and not cmp.any()  # nothing launched


# The intrinsics: csrc/planes.cu's SIMD and byte operations in the
# emulator, against their definitions (PTX vmin2/vmax2/vset2 on signed
# 16-bit halves; CUDA's __byte_perm, the low 3 bits of each selector
# nibble picking a byte of {y, x}).


def _halves(v: int) -> list[int]:
    return [((v >> s) & 0xFFFF) - (0x10000 if (v >> s) & 0x8000 else 0) for s in (0, 16)]


def _join(hs: list[int]) -> int:
    return (hs[0] & 0xFFFF) | (hs[1] & 0xFFFF) << 16


REFERENCE = {
    "__vmins2": lambda a, b: _join([min(x, y) for x, y in zip(_halves(a), _halves(b))]),
    "__vmaxs2": lambda a, b: _join([max(x, y) for x, y in zip(_halves(a), _halves(b))]),
    "__vcmpges2": lambda a, b: _join([0xFFFF if x >= y else 0 for x, y in zip(_halves(a), _halves(b))]),
    "__vcmpgts2": lambda a, b: _join([0xFFFF if x > y else 0 for x, y in zip(_halves(a), _halves(b))]),
}


@pytest.fixture(scope="module")
def intrinsics(tmp_path_factory):
    shims = "".join(f'extern "C" unsigned emu{name}(unsigned a, unsigned b) {{ return {name}(a, b); }}\n'
                    for name in REFERENCE)
    shims += ('extern "C" unsigned emu_byte_perm(unsigned x, unsigned y, unsigned s) '
              "{ return __byte_perm(x, y, s); }\n"
              'extern "C" unsigned emu_ldg_uint4(const unsigned* p, int k) '
              "{ const uint4 v = __ldg(reinterpret_cast<const uint4*>(p)); "
              "const uint4 w = make_uint4(v.x, v.y, v.z, v.w); return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w; }\n")
    lib = _compile(tmp_path_factory.mktemp("intrinsics_emu"), "intrinsics", '#include "cuda_runtime.h"\n' + shims)
    for name in [f"emu{n}" for n in REFERENCE] + ["emu_byte_perm"]:
        getattr(lib, name).restype = ctypes.c_uint
        getattr(lib, name).argtypes = [ctypes.c_uint] * (3 if name == "emu_byte_perm" else 2)
    lib.emu_ldg_uint4.restype, lib.emu_ldg_uint4.argtypes = ctypes.c_uint, [ctypes.c_void_p, ctypes.c_int]
    return lib


def _words(seed: int, n: int = 300) -> list[int]:
    """Random words, and every pair of the edge halves 0x0000, 0x0001,
    0x7FFF, 0x8000, 0x8001, 0xFFFF."""
    edges = [0x0000, 0x0001, 0x7FFF, 0x8000, 0x8001, 0xFFFF]
    rng = np.random.default_rng(seed)
    return [lo | hi << 16 for lo in edges for hi in edges] + [int(v) for v in rng.integers(0, 1 << 32, n)]


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_simd_intrinsic_equals_its_definition(intrinsics, name):
    words = _words(len(name))
    for a in words[:36]:
        for b in words[:36]:
            assert getattr(intrinsics, f"emu{name}")(a, b) == REFERENCE[name](a, b), (hex(a), hex(b))
    for a, b in zip(words[36:], reversed(words[36:])):
        assert getattr(intrinsics, f"emu{name}")(a, b) == REFERENCE[name](a, b), (hex(a), hex(b))


def test_byte_perm_equals_its_definition(intrinsics):
    rng = np.random.default_rng(7)
    selectors = [0x6240, 0x7632, 0x5410, 0x0040, 0x3210, 0x7654] + [int(s) for s in rng.integers(0, 1 << 16, 200)]
    for s in selectors:
        x, y = (int(v) for v in rng.integers(0, 1 << 32, 2))
        xy = y << 32 | x
        want = sum(((xy >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))
        assert intrinsics.emu_byte_perm(x, y, s) == want, (hex(x), hex(y), hex(s))


def test_uint4_vector_load(intrinsics):
    words = np.array([0x11111111, 0x22222222, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    assert [intrinsics.emu_ldg_uint4(words.ctypes.data, k) for k in range(4)] == words.tolist()


def test_planes_sass_reads_each_instantiation(monkeypatch):
    """tools/planes_sass.py's reading of ptxas' and cuobjdump's text (run on
    a machine with the toolkit): each instantiation by form and gate, its
    opcodes past a 4-digit address and under a predicate."""
    from airjax_torch.tools import planes_sass

    sass = """
\t\tFunction : _ZN41_GLOBAL__N__c2_9_planes_cu_a13planes_kernelILNS_4FormE2ELNS_4GateE0EEEvPKjxxPhS5_
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*fff0*/              @!P0 VIMNMX.S16x2 R2, R3, R4, PT ;         /* 0x0000000403027248 */
        /*10000*/             @UP1 PRMT R5, R2, 0x6240, R3 ;             /* 0x0000624002057816 */
\t\tFunction : _ZN41_GLOBAL__N__c2_9_planes_cu_a13planes_kernelILNS_4FormE0ELNS_4GateE1EEEvPKjxxPhS5_
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
"""
    ptxas = ("ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__c2_9_planes_cu_a13planes_kernelILNS_4FormE2E"
             "LNS_4GateE0EEEvPKjxxPhS5_' for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
             "loads\nptxas info    : Used 64 registers, used 1 barriers, 17476 bytes smem\n")
    monkeypatch.setattr(planes_sass.subprocess, "run",
                        lambda cmd, **kw: type("P", (), {"stdout": sass, "stderr": ptxas})())
    assert planes_sass.opcodes("x.o") == {"tree16/df17": ["LDC", "VIMNMX.S16x2", "PRMT"], "front/preamble": ["EXIT"]}
    info = planes_sass.compile_planes(".", "x.o")
    assert list(info) == ["tree16/df17"] and "0 bytes spill stores" in info["tree16/df17"]
    assert "Used 64 registers" in info["tree16/df17"]
