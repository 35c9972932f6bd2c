"""Exact |IQ| magnitude in plain torch (airjax/dsp/magnitude.py:29-63).

The reference truncates an f64 sqrt of re^2 + im^2 to an integer; for
every integer s <= 2^31 that equals the exact integer square root, which
an f32 sqrt plus a two-sided one-step fixup reproduces whatever way the
f32 sqrt rounds (see the airjax module's docstring for the argument).

Two differences from airjax, both forced by torch's CPU integer support:
  * re^2 + im^2 is computed in int64. (-32768, -32768) gives exactly
    2^31, which wraps in int32; airjax adds in uint32, and torch's CPU
    build has no uint32 add.
  * magnitudes are returned as int32 (<= 46340), not uint16/uint32:
    torch's CPU build has no `gt`, `minimum` or `>>` for uint32. Every
    downstream comparison is the same on int32 as on the unsigned forms.

The `_u32` functions return airjax's uint32 values and dtype: they compute
in int64 as the others do and convert at the end (torch has the
conversion to uint32 on every device). No decode path reads them.

The CUDA front kernel (csrc/magdet.cu, mag_from_word) computes the same
value in uint32 registers.
"""

from __future__ import annotations

import torch


def squared_magnitude(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 I/Q -> (...) int64 re^2+im^2 (exact, max 2^31)."""
    re = iq[..., 0].to(torch.int64)
    im = iq[..., 1].to(torch.int64)
    return re * re + im * im


def isqrt(s: torch.Tensor) -> torch.Tensor:
    """Elementwise exact floor(sqrt(s)) for int64 0 <= s <= 2^31 -> int32."""
    k = torch.sqrt(s.to(torch.float32)).to(torch.int64)
    up = k + 1
    k = torch.where(up * up <= s, up, k)
    k = torch.where((k > 0) & (k * k > s), k - 1, k)
    return k.to(torch.int32)


def magnitude_u16(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 I/Q -> (...) int32 magnitudes, bit-exact vs reference.

    Named for its airjax counterpart; the values fit uint16 (<= 46340).
    """
    return isqrt(squared_magnitude(iq))


def squared_magnitude_u32(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 I/Q -> (...) uint32 re^2+im^2, exact (max 2^31)
    (airjax/dsp/magnitude.py:29-35)."""
    return squared_magnitude(iq).to(torch.uint32)


def isqrt_u32(s: torch.Tensor) -> torch.Tensor:
    """Elementwise exact floor(sqrt(s)) -> uint32, for uint32 or int64
    0 <= s <= 2^31 (airjax/dsp/magnitude.py:38-44)."""
    return isqrt(s.to(torch.int64)).to(torch.uint32)


def magnitude_u32(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 I/Q -> (...) uint32 magnitudes, bit-exact vs the
    reference (airjax/dsp/magnitude.py:47-49)."""
    return isqrt(squared_magnitude(iq)).to(torch.uint32)
