"""airjax_torch.dsp.magnitude against airjax.dsp.magnitude, exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from airjax.dsp import magnitude as jmag
from airjax.dsp.magnitude import magnitude_u16 as jax_magnitude_u16
from airjax_torch.dsp.magnitude import (
    isqrt,
    isqrt_u32,
    magnitude_u16,
    magnitude_u32,
    squared_magnitude,
    squared_magnitude_u32,
)
from torch_parity import assert_same

EXTREMES = np.array(
    [
        [-32768, -32768], [-32768, 32767], [32767, -32768], [32767, 32767],
        [-32768, 0], [0, -32768], [32767, 0], [0, 0], [1, 0], [0, 1],
        [-1, -1], [3, 4], [255, 255], [256, 256], [46340 // 2, 46340 // 2],
    ],
    dtype=np.int16,
)


def _check(iq: np.ndarray) -> None:
    expected = np.asarray(jax_magnitude_u16(jnp.asarray(iq))).astype(np.int32)
    got = magnitude_u16(torch.as_tensor(iq))
    assert got.dtype == torch.int32
    assert_same(expected, got)


def test_int16_extremes():
    _check(EXTREMES)
    s = squared_magnitude(torch.as_tensor(EXTREMES[:1]))
    assert int(s[0]) == 2**31  # would wrap in int32
    assert int(magnitude_u16(torch.as_tensor(EXTREMES[:1]))[0]) == 46340


def test_near_perfect_squares():
    """Pairs whose re^2+im^2 sits just below, on and just above m^2."""
    rng = np.random.default_rng(5)
    re = rng.integers(0, 32768, 20000)
    m = re + rng.integers(1, 200, re.shape)
    im_lo = np.floor(np.sqrt(m.astype(np.float64) ** 2 - re.astype(np.float64) ** 2)).astype(np.int64)
    pairs = []
    for im in (im_lo - 1, im_lo, im_lo + 1):
        ok = (im >= 0) & (im <= 32767)
        pairs.append(np.stack([re[ok], im[ok]], axis=1))
    k = np.arange(0, 32768)
    pairs.append(np.stack([k, np.zeros_like(k)], axis=1))  # exact squares
    pairs.append(np.stack([k, np.ones_like(k)], axis=1))  # squares + 1
    iq = np.concatenate(pairs).astype(np.int16)
    signs = rng.choice([-1, 1], size=iq.shape).astype(np.int16)
    _check(iq)
    _check(iq * signs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_iq(seed):
    rng = np.random.default_rng(seed)
    _check(rng.integers(-32768, 32768, size=(50000, 2), dtype=np.int16))


def test_isqrt_exact_over_range():
    rng = np.random.default_rng(11)
    k = rng.integers(0, 46341, 20000, dtype=np.int64)
    s = np.concatenate([k * k - 1, k * k, k * k + 1, rng.integers(0, 2**31 + 1, 20000)])
    s = np.clip(s, 0, 2**31)
    expected = np.floor(np.sqrt(s.astype(np.float64))).astype(np.int32)
    assert_same(expected, isqrt(torch.as_tensor(s)))


def _u32_corners(seed: int) -> np.ndarray:
    """Random int16 IQ, the int16 extremes, and pairs whose re^2 + im^2
    sits next to 46340^2 (the largest square under 2^31)."""
    rng = np.random.default_rng(seed)
    near = []
    for re in (46340 // 2, 32767, 32760, 30000, 12345):
        for d in (-2, -1, 0, 1, 2):
            im = int(np.floor(np.sqrt(max(46340**2 + d - re * re, 0))))
            near += [[re, min(im + e, 32767)] for e in (-1, 0, 1)]
    return np.concatenate([
        rng.integers(-32768, 32768, size=(4000, 2), dtype=np.int16), EXTREMES,
        np.asarray(near, dtype=np.int16), -np.asarray(near, dtype=np.int16),
    ])


@pytest.mark.parametrize("seed", [0, 1])
def test_u32_functions_equal_airjax(seed):
    """squared_magnitude_u32, isqrt_u32 (from uint32 and from int64) and
    magnitude_u32: airjax's values, and its dtype, uint32."""
    iq = _u32_corners(seed)
    s_j = np.asarray(jmag.squared_magnitude_u32(jnp.asarray(iq)))
    s_t = squared_magnitude_u32(torch.as_tensor(iq))
    assert s_t.dtype == torch.uint32 and str(s_t.numpy().dtype) == str(s_j.dtype) == "uint32"
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    assert int(s_t.numpy().max()) == 2**31
    k_j = np.asarray(jmag.isqrt_u32(jnp.asarray(s_j)))
    for s in (s_t, s_t.to(torch.int64)):
        k_t = isqrt_u32(s)
        assert k_t.dtype == torch.uint32
        np.testing.assert_array_equal(k_t.numpy(), k_j)
    m_j = np.asarray(jmag.magnitude_u32(jnp.asarray(iq)))
    m_t = magnitude_u32(torch.as_tensor(iq))
    assert m_t.dtype == torch.uint32 and m_j.dtype == np.uint32
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    assert int(m_t.numpy().max()) == 46340
