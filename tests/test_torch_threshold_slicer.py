"""airjax_torch.dsp.demod.threshold_slice_bits (the reference's dead
threshold slicer) against airjax's, on tests/test_threshold_slicer.py's
vectors (src/adsb/demod.rs:281-320) and on random windows: bits and the
accept flag equal, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax.dsp.demod import threshold_slice_bits as jslice
from airjax_torch.dsp.demod import threshold_slice_bits


def _buf_valid():
    buf = np.zeros(224, dtype=np.uint32)  # demod.rs:286-291: (120, 50, 50, 120) repeated
    buf[0::4], buf[1::4], buf[2::4], buf[3::4] = 120, 50, 50, 120
    return buf


def _both(mags, offsets, high, derate):
    want = jslice(jnp.asarray(mags.astype(np.uint32)), jnp.asarray(offsets), jnp.uint32(high), derate=derate)
    got = threshold_slice_bits(torch.as_tensor(mags.astype(np.int32)), torch.as_tensor(offsets), high, derate=derate)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    return got


@pytest.mark.parametrize("head, ok", [(None, True), ([50, 50, 120, 120, 50, 50], False), ([50, 50, 120, 120], True)])
@pytest.mark.parametrize("high, derate", [(100, 1.0), (112, 0.9)])
def test_reference_vectors(head, ok, high, derate):
    buf = _buf_valid()
    if head is not None:
        buf[: len(head)] = head
    mags = np.zeros(300, dtype=np.uint32)
    mags[16:240] = buf
    bits, accepted = _both(mags, np.array([0]), high, derate)
    assert bool(accepted[0]) == ok
    if head is None:
        assert np.array_equal(bits[0].numpy(), np.tile([1, 0], 56))
    elif ok:
        assert int(bits[0][0]) == int(bits[0][1]) == 0  # invalid pairs decode as 0


def test_random_windows_and_derates():
    rng = np.random.default_rng(8)
    mags = rng.integers(0, 200, 4000)
    offsets = rng.integers(0, 4000 - 240, 64)
    for high, derate in ((150, 0.9), (90, 1.0), (130, 0.75)):
        _both(mags, offsets, high, derate)


def test_per_offset_highs_at_the_derate_edges():
    """A high per offset, over the magnitude range, each window holding its
    derated threshold and the values beside it: the exact x * 9 // 10."""
    rng = np.random.default_rng(9)
    highs = np.sort(rng.integers(0, 46341, 32))
    mags = np.concatenate([np.repeat(h * 9 // 10 + rng.integers(-1, 2, 240), 1) for h in highs])
    offsets = np.arange(len(highs)) * 240
    want = jslice(jnp.asarray(mags.astype(np.uint32)), jnp.asarray(offsets), jnp.asarray(highs.astype(np.uint32)))
    got = threshold_slice_bits(torch.as_tensor(mags.astype(np.int32)), torch.as_tensor(offsets), torch.as_tensor(highs))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_windows_outside_the_block_start_where_airjax_starts_them():
    """Offsets past L - 240 and below -16: airjax's dynamic_slice counts a
    negative start from the end, then clamps it into the block."""
    mags = np.random.default_rng(10).permutation(1000)
    offsets = np.array([-1, -16, -17, -40, -500, -1016, -1017, -3000, 761, 990, 5000])
    _both(mags, offsets, 500, 0.9)
