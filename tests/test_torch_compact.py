"""The bit-emitting front (kernels/magdet.py::magdet_bits) and the
compaction kernel's wrapper (kernels/compact.py::compact_bits) against
airjax, on the CPU, where both wrappers run their plain versions:

- the detection words against airjax's `detect` / `detect_preamble_only`
  on airjax's magnitudes, packed with numpy (bit 31-k of word w = offset
  32w+k); the compare words against airjax's `pack_cmp_words`; the tile
  counts against numpy;
- the compaction against airjax's `compact_detections` on the inputs that
  chip_smoke.py holds the kernel to, at a small size: a DF17 block's and an
  extended block's masks, an empty mask, a dense random mask with K below
  the total and with K = n_off, and an n_off that is a multiple of neither
  32 nor TILE;
- the block decodes through the two wrappers, whole dicts.

Inputs are made with numpy from a seed; every output is an integer or a
bit, so the tolerance is exact equality. The kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax.dsp.demod import compact_detections as jax_compact_detections
from airjax.dsp.demod import detect as jax_detect
from airjax.dsp.demod import detect_preamble_only as jax_detect_preamble_only
from airjax.dsp.demod import pack_cmp_words as jax_pack_cmp_words
from airjax.dsp.magnitude import magnitude_u16 as jax_magnitude_u16
from airjax.pipeline import decode_iq_block as jax_decode_iq_block
from airjax.pipeline import decode_iq_block_extended as jax_decode_iq_block_extended
from airjax_torch import pipeline
from airjax_torch.dsp.demod import pack_msb_words, unpack_msb_words
from airjax_torch.io import synth
from airjax_torch.kernels import compact as compact_mod
from airjax_torch.kernels import magdet as magdet_mod
from airjax_torch.kernels.compact import compact_bits, compact_bits_plain
from airjax_torch.kernels.magdet import TILE, magdet_bits, magdet_bits_plain, n_det_words, n_tiles
from torch_parity import assert_same, assert_same_dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "airjax_torch" / "csrc"
JAX_GATES = {"df17": jax_detect, "preamble": jax_detect_preamble_only}


def np_pack_words(bits: np.ndarray, n_words: int) -> np.ndarray:
    """bits (m,) -> (n_words,) uint32, bit 31-k of word w = bits[32w+k]."""
    padded = np.zeros(32 * n_words, np.uint8)
    padded[: len(bits)] = bits
    return np.packbits(padded, bitorder="big").view(">u4").astype(np.uint32)


def np_tile_counts(det: np.ndarray) -> np.ndarray:
    padded = np.zeros(n_tiles(len(det)) * TILE, np.int32)
    padded[: len(det)] = det
    return padded.reshape(-1, TILE).sum(axis=1).astype(np.int32)


def _iq(n: int, seed: int, kind: str) -> np.ndarray:
    """Full-range noise with int16 extremes, small-range noise (ties and
    detections at every tile edge), or DF17 frames in noise."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        iq = rng.integers(-32768, 32768, size=(n, 2), dtype=np.int16)
        iq[:6] = [[-32768, -32768], [32767, 32767], [-32768, 32767], [0, 0], [1, 0], [3, 4]]
        return iq
    if kind == "small":
        return rng.integers(-2, 3, size=(n, 2), dtype=np.int16)
    frame = synth.make_df17(0x4CA2B1, synth.make_id_me("BITS01"))
    offsets = list(range(min(37, (n - 240) // 2), n - 240, 2999))
    return synth.modulate([frame] * len(offsets), offsets, n, noise_std=50.0, seed=seed)


def _mixed_iq(n: int, seed: int) -> np.ndarray:
    frames = synth.make_mixed_frames(max(1, (n - 600) // 3000), seed)
    return synth.modulate(frames, [300 + 300 * i for i in range(len(frames))], n, seed=seed)


@pytest.mark.parametrize("n", [265, 20239, TILE + 265, 3 * TILE + 777])
@pytest.mark.parametrize("kind", ["random", "small", "frames"])
@pytest.mark.parametrize("gate", ["df17", "preamble"])
def test_bits_front_matches_airjax(gate, kind, n):
    iq = _iq(n, n + len(kind), kind)
    n_off = n - 240
    mags = jax_magnitude_u16(jnp.asarray(iq))
    det = np.asarray(JAX_GATES[gate](mags, n_off))
    det_words, words, counts = magdet_bits(torch.as_tensor(iq), n_off, gate)
    assert det_words.dtype == words.dtype == counts.dtype == torch.int32
    assert_same(np_pack_words(det, n_det_words(n_off)), det_words, "det_words")
    assert_same(np.asarray(jax_pack_cmp_words(mags)), words, "words")
    assert_same(np_tile_counts(det), counts, "tile_counts")
    if kind == "frames":
        assert int(counts.sum()) > 0


def _compaction_cases():
    """name -> (mask (n_off,) bool, capacity K), the inputs chip_smoke.py
    holds the compaction kernel to, at a small size."""
    rng = np.random.default_rng(31)
    n = 3 * TILE + 1000
    df17 = np.asarray(jax_detect(jax_magnitude_u16(jnp.asarray(_iq(n, 4, "frames"))), n - 240))
    ext = np.asarray(jax_detect_preamble_only(jax_magnitude_u16(jnp.asarray(_mixed_iq(n, 5))), n - 240))
    dense = rng.random(2 * TILE + 77) < 0.3
    return {
        "df17 block": (df17, 64),
        "extended block": (ext, 1024),
        "empty": (np.zeros(3 * TILE, bool), 2048),
        "dense, K < total": (dense, 1000),
        "dense, K = n_off": (dense, len(dense)),
        "ragged": (rng.random(3 * TILE + 1007) < 0.5, 64),
    }


@pytest.mark.parametrize("case", list(_compaction_cases()))
def test_compaction_matches_airjax(case):
    det, k = _compaction_cases()[case]
    n_off = len(det)
    det_t = torch.as_tensor(np.array(det))
    det_words = pack_msb_words(det_t, n_det_words(n_off))
    counts = magdet_mod.tile_counts(det_t)
    want = jax.device_get(jax_compact_detections(jnp.asarray(det), k))
    offsets, valid, n_det, gather = compact_bits(det_words, counts, n_off, k)
    for name, a, b in zip(("offsets", "valid", "n_detections"), want, (offsets, valid, n_det)):
        assert_same(np.asarray(a), b, name)
    assert_same(np.where(np.asarray(want[1]), np.asarray(want[0]), 0).astype(np.int32), gather, "gather")
    assert int(n_det) == int(det.sum())
    if case.startswith("dense, K <") or case == "ragged":
        assert int(n_det) > k  # the overflow cases overflow


def test_pack_and_unpack_are_inverse():
    bits = torch.as_tensor(np.random.default_rng(2).random(1000) < 0.5)
    words = pack_msb_words(bits, 33)  # 1000 bits fill 31.25 words; the rest is 0
    assert words.dtype == torch.int32 and not words[-1].any() and not (words[31] & 0x00FFFFFF).any()
    assert torch.equal(unpack_msb_words(words, 1000), bits)
    assert_same(np_pack_words(bits.numpy(), 33), words)


@pytest.mark.parametrize("extended", [False, True])
def test_block_decode_runs_the_bits_front_and_compaction(monkeypatch, extended):
    """decode_iq_block(_extended) on the CPU goes through magdet_bits and
    compact_bits, and its dict equals airjax's."""
    calls = []
    for mod, name in ((pipeline, "magdet_bits"), (pipeline, "compact_bits")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    n = 2 * TILE + 3000
    n_off = n - 240
    if extended:
        iq = _mixed_iq(n, 6)
        want = jax.device_get(jax_decode_iq_block_extended(jnp.asarray(iq), n_off, 512))
        got = pipeline.decode_iq_block_extended(torch.as_tensor(iq), n_off, 512)
    else:
        iq = _iq(n, 7, "frames")
        want = jax.device_get(jax_decode_iq_block(jnp.asarray(iq), n_off, 16))
        got = pipeline.decode_iq_block(torch.as_tensor(iq), n_off, 16)
    assert calls == ["magdet_bits", "compact_bits"]
    assert_same_dict(want, pipeline.to_host(got))
    assert int(got["n_detections"]) > 0


def test_tile_equals_the_kernels_constant():
    for src in ("front.cu", "compact.cu"):
        (tile,) = re.findall(r"constexpr int kTile = (\d+);", (CSRC / src).read_text())
        assert int(tile) == TILE, src


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    iq = torch.as_tensor(_iq(3000, 8, "small"))
    b0, c0 = magdet_mod.bits_launches, compact_mod.launches
    got = magdet_bits(iq, 2500)
    assert all(torch.equal(a, b) for a, b in zip(got, magdet_bits_plain(iq, 2500)))
    det_words, _, counts = got
    out = compact_bits(det_words, counts, 2500, 300)
    assert all(torch.equal(a, b) for a, b in zip(out, compact_bits_plain(det_words, counts, 2500, 300)))
    assert (magdet_mod.bits_launches, compact_mod.launches) == (b0, c0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    iq = torch.as_tensor(_iq(1000, 9, "small"))
    with pytest.raises(ValueError):
        magdet_bits(iq, 500, gate="df11")
    with pytest.raises(ValueError):
        magdet_bits(iq, 1000 - 24)  # the taps would reach past the block
    det_words, _, counts = magdet_bits(iq, 500)
    with pytest.raises(ValueError):
        compact_bits(det_words, counts, 600, 16)  # words for another n_off
    with pytest.raises(ValueError):
        compact_bits(det_words, counts[:0], 500, 16)
    with pytest.raises(ValueError):
        compact_bits(det_words.to(torch.int64), counts, 500, 16)
    with pytest.raises(ValueError):
        compact_bits(det_words, counts, 500, -1)
    with pytest.raises(ValueError):
        compact_bits(det_words.to("meta"), counts.to("meta"), 500, 16)  # neither CPU nor CUDA
