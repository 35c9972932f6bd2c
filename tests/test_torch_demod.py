"""airjax_torch.dsp.demod's other formulations against airjax/dsp/demod.py:
compact_detections at every tile, slice_bits (its clamp included),
slice_bits_sparse_bytes on the plane airjax's Pallas front writes (in
interpret mode, as tests/test_pallas_kernel.py runs it) and
pack_cmp_words_reduce. Inputs from numpy seeds; every output is a bit or
an integer, so the tolerance is exact equality."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from airjax.dsp import demod as jd
from airjax.dsp.magnitude import magnitude_u16 as jax_magnitude_u16
from airjax.kernels.magdet import magdet_packed, pad_for_kernel
from airjax_torch.dsp import demod as td
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.io import synth
from torch_parity import assert_same


def _mask(n: int, density: float, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < density


@pytest.mark.parametrize("tile", [1, 7, 512, 5000])
@pytest.mark.parametrize("capacity", [64, 400])
def test_compact_detections_tile_equals_airjax(tile, capacity):
    """n_off 3001 at ~10% density (~300 detections): capacity 64
    overflows, 400 does not; tile 5000 is larger than n_off."""
    det = _mask(3001, 0.1, tile)
    want = jd.compact_detections(jnp.asarray(det), capacity, tile=tile)
    got = td.compact_detections(torch.as_tensor(det), capacity, tile=tile)
    for w, g, name in zip(want, got, ("offsets", "valid", "n_detections")):
        assert_same(np.asarray(w), g, name)
    assert (int(got[2]) > capacity) == (capacity == 64)
    for w, d in zip(got, td.compact_detections(torch.as_tensor(det), capacity)):
        assert torch.equal(w, d)  # the same result at the default tile


@pytest.mark.parametrize("tile", [0, -3])
def test_compact_detections_refuses_a_tile_below_1(tile):
    with pytest.raises(ValueError, match="tile"):
        td.compact_detections(torch.zeros(10, dtype=torch.bool), 4, tile=tile)
    assert td.COMPACT_TILE == jd.COMPACT_TILE == 512


def _mags(n: int, seed: int) -> tuple[np.ndarray, torch.Tensor]:
    """DF17 traffic and noise -> (airjax's uint16 magnitudes, the port's)."""
    frames = [synth.make_df17(0x3C0000 + i, synth.make_id_me(f"DEMOD{i}")) for i in range(3)]
    iq = synth.modulate(frames, [5, n // 3, n - 240], n, seed=seed)
    return np.asarray(jax_magnitude_u16(jnp.asarray(iq))), magnitude_u16(torch.as_tensor(iq))


@pytest.mark.parametrize("kind", ["in_range", "clamped"])
def test_slice_bits_equals_airjax(kind):
    """In-range offsets (the frames' own among them), and offsets past
    L - 240 or below 0, which airjax's dynamic_slice clamps."""
    n = 4000
    mags_j, mags_t = _mags(n, 3)
    rng = np.random.default_rng(len(kind))
    if kind == "in_range":
        offsets = np.concatenate([[5, n // 3, n - 240, 0], rng.integers(0, n - 240 + 1, 40)])
    else:
        offsets = np.concatenate([[n - 239, n - 224, n - 16, n, n + 500, -1, -16, -40], rng.integers(n - 239, n, 20)])
    offsets = offsets.astype(np.int32)
    want = np.asarray(jd.slice_bits(jnp.asarray(mags_j), jnp.asarray(offsets)))
    got = td.slice_bits(mags_t, torch.as_tensor(offsets))
    assert got.dtype == torch.uint8 and got.shape == (len(offsets), 112)
    assert_same(want, got)
    if kind == "clamped":
        last = td.slice_bits(mags_t, [n - 240])
        assert torch.equal(got[: 4], last.expand(4, -1))  # past the end: the last window
    else:
        frame = synth.make_df17(0x3C0001, synth.make_id_me("DEMOD1"))
        np.testing.assert_array_equal(np.packbits(got[1].numpy()), np.frombuffer(frame, np.uint8))


def test_slice_bits_refuses_a_block_shorter_than_a_frame():
    with pytest.raises(ValueError, match="224"):
        td.slice_bits(torch.zeros(223, dtype=torch.int32), [0])


def test_slice_bits_sparse_bytes_reads_airjax_plane():
    """airjax's magdet_packed plane (Pallas, interpret mode) through the
    port's reader == airjax's reader == the port's slice_bits of the same
    magnitudes, at the detections and at random offsets."""
    n = 60000
    frames = [synth.make_df17(0x4D0000 + i, synth.make_id_me(f"SPARSE{i}")) for i in range(6)]
    iq = synth.modulate(frames, [0, 9000, 21000, 33333, 47000, n - 240], n, seed=5)
    padded, n_dom = pad_for_kernel(jnp.asarray(iq))
    det, pbytes = jax.device_get(magdet_packed(padded, interpret=True))
    rng = np.random.default_rng(8)
    offsets = np.concatenate([np.nonzero(det[: n - 240 + 1])[0], rng.integers(0, n - 240 + 1, 100)]).astype(np.int32)
    outside = np.array([-1, -17, -300, -(1 << 20), len(pbytes), len(pbytes) * 4], dtype=np.int32)
    plane = torch.as_tensor(np.array(pbytes))
    for offs in (offsets, outside):  # outside the plane: what airjax's gather reads there
        want = np.asarray(jd.slice_bits_sparse_bytes(jnp.asarray(pbytes), jnp.asarray(offs)))
        got = td.slice_bits_sparse_bytes(plane, torch.as_tensor(offs))
        assert got.dtype == torch.uint8
        assert_same(want, got)
    got = td.slice_bits_sparse_bytes(plane, torch.as_tensor(offsets))
    assert torch.equal(got, td.slice_bits(magnitude_u16(torch.as_tensor(iq)), offsets))
    assert len(np.nonzero(det[: n - 240 + 1])[0]) >= len(frames)


def test_slice_bits_packed_outside_the_words_equals_airjax():
    """Offsets whose words lie past the end or before the start read what
    airjax's gather reads there (a negative index counts from the end,
    then the index is clamped)."""
    mags_j, mags_t = _mags(3000, 4)
    words_j = jd.pack_cmp_words(jnp.asarray(mags_j))
    offsets = np.array([0, 5, 2760, 2761, 2900, 3000, 9000, -1, -16, -17, -100, -2900, -100000], dtype=np.int32)
    want = np.asarray(jd.slice_bits_packed(words_j, jnp.asarray(offsets)))
    assert_same(want, td.slice_bits_packed(td.pack_cmp_words(mags_t), torch.as_tensor(offsets)))


@pytest.mark.parametrize("n", [2, 33, 1000, 1153, 1281, 4097])
def test_pack_cmp_words_reduce_equals_airjax_and_pack_cmp_words(n):
    """(n - 1) compares: a multiple of 32 at 33, 1153, 1281 and 4097 (of 128
    at 1281 and 4097), not at 2 and 1000."""
    mags_j, mags_t = _mags(max(n, 1000), n)
    mags_j, mags_t = mags_j[:n], mags_t[:n]
    want = np.asarray(jd.pack_cmp_words_reduce(jnp.asarray(mags_j)))
    got = td.pack_cmp_words_reduce(mags_t)
    assert got.dtype == torch.int32 and want.dtype == np.uint32
    assert_same(want, got)
    dense = td.pack_cmp_words(mags_t)
    k = len(want) - td.WORDS_PER_CAND
    assert torch.equal(got[:k], dense[:k]) and not got[k:].any() and not dense[k:].any()
