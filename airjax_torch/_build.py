"""Build the port's CUDA kernels at first use and bind them with ctypes.

The counterpart of airjax/native.py:37-45, which builds `native/` with make
and loads it through ctypes. Here `nvcc` compiles each `csrc/*.cu` into an
object, one process per source and all started together, then links them
into one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds):

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
       -c -o build/airjax_torch/<lib>.<pid>/<name>.o csrc/<name>.cu   # each source
  nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
       -o build/airjax_torch/<lib>.so build/airjax_torch/<lib>.<pid>/*.o

where <lib> is libairjax_torch_<hash>.

No `--use_fast_math`: the magnitude's exactness argument assumes a
correctly rounded `sqrtf` (the fixup then makes it exact either way).
The library is named by a hash of the flags and sources, so an edited
source rebuilds and an unchanged one loads the cached file. Every pointer
and the stream are passed as `c_void_p`; every entry point returns
`cudaGetLastError()`, which the wrappers check (_dispatch.check_launch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "airjax_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# name -> (restype, argtypes); see the extern "C" blocks in csrc/*.cu.
_SIGNATURES = {
    "airjax_magdet": (ctypes.c_int, [_P, _I64, _I64, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P]),
    "airjax_magdet_bits": (ctypes.c_int, [_P, _I64, _I64, _P, _P, _I64, _P, ctypes.c_int, _P]),
    "airjax_chunked_count": (ctypes.c_int, [_P, _I64, _I64, _I64, _P, _P]),
    "airjax_compact": (ctypes.c_int, [_P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P]),
    "airjax_magdet_stencil": (ctypes.c_int, [_P, _I64, _I64, _P, _P, ctypes.c_int, _P]),
    "airjax_planes": (ctypes.c_int, [_P, _I64, _I64, _P, _P, ctypes.c_int, ctypes.c_int, _P]),
    "airjax_candidates": (ctypes.c_int, [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "airjax_load_syndromes": (ctypes.c_int, [_P]),
    "airjax_block_decode": (
        ctypes.c_int, [_P, _P, _I64, _P, _I64, _I64, *[_P] * 17, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "airjax_fields": (ctypes.c_int, [_P, _P, _I64, _P, _P, _P]),
    "airjax_shard_gather": (
        ctypes.c_int, [_P, ctypes.c_int, _I64, _I64, _I64, _I64, _P, ctypes.c_int, ctypes.c_int, _I64, _P, _P, _P]),
    "airjax_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libairjax_torch_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _run(cmds: list[list[str]]) -> None:
    """Run the commands all at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{err}")


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    path = library_path()
    if path.exists():
        return path
    objs = BUILD_DIR / f"{path.stem}.{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    cu = [s for s in sources() if s.suffix == ".cu"]
    obj = [objs / f"{s.stem}.o" for s in cu]
    _run([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(cu, obj)])
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    _run([[nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, obj)]])
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    shutil.rmtree(objs)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def error_string(rc: int) -> str:
    return library().airjax_error_string(rc).decode()
