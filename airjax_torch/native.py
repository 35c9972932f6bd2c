"""ctypes bindings of the native C++ runtime (airjax/native.py), the port's
own copy: the library is built from the repository's
native/airjax_native.cpp with g++ into build/airjax_torch/, named by a
hash of the source and the flags, and only that file is loaded.
native/libairjax_native.so (airjax's, tracked, built elsewhere with
-march=native) is neither written nor loaded here.

  * load_c16 / save_c16       — capture IO
  * magnitude                 — reference-exact u32 magnitudes
  * crc24                     — table-driven Mode S CRC
  * decode_chunk              — reference-exact scalar decoder (the native
                                parity oracle)
  * decode_chunk_extended     — its extended form, `recover2` classing the
                                unique 2-flip repairs as 'long2'
  * Ring                      — lock-free SPSC block ring (the live input's
                                channel, sdr.SdrSource.blocks_ringbuffered)

`build_fake_soapysdr` compiles native/fake_soapysdr.c, the SoapySDR 0.8
C-ABI double that the live input is tested against (sdr.py), with gcc into
the same directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = _REPO_ROOT / "native"
BUILD_DIR = _REPO_ROOT / "build" / "airjax_torch"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
CFLAGS = ("-O2", "-fPIC", "-Wall", "-shared")
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _compile(compiler: str, flags: tuple[str, ...], source: pathlib.Path, stem: str) -> pathlib.Path:
    """build/airjax_torch/<stem>_<hash>.so from `source`, unless it exists;
    NativeUnavailable when the compiler fails or is missing."""
    h = hashlib.sha256(" ".join((compiler, *flags)).encode() + source.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"{stem}_{h}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([compiler, *flags, "-o", str(tmp), str(source)], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeUnavailable(f"failed to build {source.name}: {e} {getattr(e, 'stderr', b'')!r}") from e
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    return path


def library_path() -> pathlib.Path:
    """The port's build of native/airjax_native.cpp (built on first call)."""
    return _compile("g++", CXXFLAGS, NATIVE_DIR / "airjax_native.cpp", "libairjax_native")


def build_fake_soapysdr() -> pathlib.Path:
    """native/fake_soapysdr.c built with gcc; point AIRJAX_SOAPY_LIB at it."""
    return _compile("gcc", CFLAGS, NATIVE_DIR / "fake_soapysdr.c", "libfake_soapysdr")


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(library_path()))
        i16p = ctypes.POINTER(ctypes.c_int16)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_longlong)
        lib.airjax_load_c16.restype = ctypes.c_longlong
        lib.airjax_load_c16.argtypes = [ctypes.c_char_p, ctypes.POINTER(i16p)]
        lib.airjax_save_c16.restype = ctypes.c_int
        lib.airjax_save_c16.argtypes = [ctypes.c_char_p, i16p, ctypes.c_longlong]
        lib.airjax_free.restype = None
        lib.airjax_free.argtypes = [ctypes.c_void_p]
        lib.airjax_magnitude.restype = None
        lib.airjax_magnitude.argtypes = [i16p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)]
        lib.airjax_crc24.restype = ctypes.c_uint32
        lib.airjax_crc24.argtypes = [u8p, ctypes.c_int]
        lib.airjax_decode_chunk.restype = ctypes.c_longlong
        lib.airjax_decode_chunk.argtypes = [i16p, ctypes.c_longlong, i64p, u8p, u8p, ctypes.c_longlong, i64p]
        ext_args = [i16p, ctypes.c_longlong, i64p, u8p, u8p, ctypes.POINTER(ctypes.c_uint32), u8p,
                    ctypes.c_longlong, i64p]
        for name in ("airjax_decode_chunk_extended", "airjax_decode_chunk_extended_r2"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = ext_args
        lib.airjax_ring_create.restype = ctypes.c_void_p
        lib.airjax_ring_create.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        lib.airjax_ring_destroy.restype = None
        lib.airjax_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.airjax_ring_push.restype = ctypes.c_int
        lib.airjax_ring_push.argtypes = [ctypes.c_void_p, i16p, ctypes.c_longlong]
        lib.airjax_ring_pop.restype = ctypes.c_longlong
        lib.airjax_ring_pop.argtypes = [ctypes.c_void_p, i16p]
        lib.airjax_ring_size.restype = ctypes.c_longlong
        lib.airjax_ring_size.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def load_c16(path: str | os.PathLike) -> np.ndarray:
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_int16)()
    n = lib.airjax_load_c16(str(path).encode(), ctypes.byref(out))
    if n < 0:
        raise ValueError(f"couldn't load c16 file {path}")
    try:
        return np.ctypeslib.as_array(out, shape=(int(n), 2)).copy()
    finally:
        lib.airjax_free(out)


def save_c16(data: np.ndarray, path: str | os.PathLike) -> None:
    lib = get_lib()
    arr = np.ascontiguousarray(data, dtype=np.int16)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"expected (N, 2) I/Q array, got {arr.shape}")
    if lib.airjax_save_c16(str(path).encode(), _ptr(arr, ctypes.c_int16), arr.shape[0]) != 0:
        raise OSError(f"couldn't save c16 file {path}")


def _iq(iq: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(iq, dtype=np.int16)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"expected (N, 2) I/Q array, got {arr.shape}")
    return arr


def magnitude(iq: np.ndarray) -> np.ndarray:
    lib = get_lib()
    arr = _iq(iq)
    out = np.empty(arr.shape[0], dtype=np.uint32)
    lib.airjax_magnitude(_ptr(arr, ctypes.c_int16), arr.shape[0], _ptr(out, ctypes.c_uint32))
    return out


def crc24(data: bytes) -> int:
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return int(get_lib().airjax_crc24(buf, len(data)))


def decode_chunk(iq: np.ndarray, max_hits: int = 4096) -> tuple[list[tuple[int, bytes, bool]], int]:
    """Reference-exact scalar decode of one chunk -> (hits, n_detections);
    hits are (offset, frame bytes, recovered) in scan order."""
    lib = get_lib()
    arr = _iq(iq)
    offsets = np.empty(max_hits, dtype=np.int64)
    packets = np.empty(max_hits * 14, dtype=np.uint8)
    recovered = np.empty(max_hits, dtype=np.uint8)
    n_det = ctypes.c_longlong(0)
    n = lib.airjax_decode_chunk(
        _ptr(arr, ctypes.c_int16), arr.shape[0], _ptr(offsets, ctypes.c_longlong), _ptr(packets, ctypes.c_uint8),
        _ptr(recovered, ctypes.c_uint8), max_hits, ctypes.byref(n_det),
    )
    hits = [(int(offsets[i]), packets[14 * i : 14 * (i + 1)].tobytes(), bool(recovered[i])) for i in range(int(n))]
    return hits, int(n_det.value)


_EXT_KINDS = ("long", "df11", "short_ap", "long_ap", "df11_ic", "long2")


def decode_chunk_extended(
    iq: np.ndarray, max_hits: int = 4096, recover2: bool = False
) -> tuple[list[tuple[int, str, bytes, int]], int]:
    """The extended scalar decode -> (hits, n_detections); hits are
    (offset, kind, frame bytes, icao_ap) in scan order, the shape of
    golden.decode_chunk_extended (short kinds carry 7 bytes, long kinds 14).
    recover2=True classes the unique 2-flip repairs as 'long2' (before any
    gate), as golden.decode_chunk_extended(recover2=True) does."""
    lib = get_lib()
    arr = _iq(iq)
    offsets = np.empty(max_hits, dtype=np.int64)
    kinds = np.empty(max_hits, dtype=np.uint8)
    packets = np.empty(max_hits * 14, dtype=np.uint8)
    icao_ap = np.empty(max_hits, dtype=np.uint32)
    recovered = np.empty(max_hits, dtype=np.uint8)
    n_det = ctypes.c_longlong(0)
    fn = lib.airjax_decode_chunk_extended_r2 if recover2 else lib.airjax_decode_chunk_extended
    n = fn(
        _ptr(arr, ctypes.c_int16), arr.shape[0], _ptr(offsets, ctypes.c_longlong), _ptr(kinds, ctypes.c_uint8),
        _ptr(packets, ctypes.c_uint8), _ptr(icao_ap, ctypes.c_uint32), _ptr(recovered, ctypes.c_uint8), max_hits,
        ctypes.byref(n_det),
    )
    hits = []
    for i in range(int(n)):
        kind = _EXT_KINDS[int(kinds[i])]
        nbytes = 14 if kind in ("long", "long2", "long_ap") else 7
        hits.append((int(offsets[i]), kind, packets[14 * i : 14 * i + nbytes].tobytes(), int(icao_ap[i])))
    return hits, int(n_det.value)


class Ring:
    """Bounded lock-free single-producer single-consumer ring of IQ blocks
    of at most `block_samples` samples; push and pop release the GIL."""

    def __init__(self, block_samples: int, depth: int = 8):
        self._lib = get_lib()
        self._block = block_samples
        self._handle = self._lib.airjax_ring_create(block_samples, depth)
        if not self._handle:
            raise NativeUnavailable("ring allocation failed")

    def push(self, iq: np.ndarray) -> bool:
        """Copy a block in; False when the ring is full (or the block is
        longer than the ring's blocks)."""
        arr = _iq(iq)
        return bool(self._lib.airjax_ring_push(self._handle, _ptr(arr, ctypes.c_int16), arr.shape[0]))

    def pop(self) -> np.ndarray | None:
        """The oldest block, or None when the ring is empty."""
        out = np.empty((self._block, 2), dtype=np.int16)
        n = self._lib.airjax_ring_pop(self._handle, _ptr(out, ctypes.c_int16))
        if n < 0:
            return None
        return out[: int(n)]

    def __len__(self) -> int:
        return int(self._lib.airjax_ring_size(self._handle))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.airjax_ring_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
