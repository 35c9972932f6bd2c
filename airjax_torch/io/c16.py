"""SatDump-compatible `.c16` IQ capture files (airjax/io/c16.py:14-27):
little-endian int16 pairs, I then Q per sample, held as an (N, 2) int16
array (column 0 = I, column 1 = Q)."""

from __future__ import annotations

import os

import numpy as np


def save_c16(data: np.ndarray, path: str | os.PathLike) -> None:
    """Write (N, 2) int16 I/Q samples as little-endian .c16."""
    arr = np.ascontiguousarray(np.asarray(data, dtype="<i2"))
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"expected (N, 2) I/Q array, got {arr.shape}")
    arr.tofile(path)


def load_c16(path: str | os.PathLike) -> np.ndarray:
    """Read a .c16 file -> (N, 2) int16 (I, Q). Rejects bad lengths."""
    raw = np.fromfile(path, dtype="<i2")
    if raw.size % 2 != 0:
        raise ValueError("Invalid file length (not divisible by 4)")
    return raw.reshape(-1, 2)
