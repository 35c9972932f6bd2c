"""The block-decode kernel's wrapper (kernels/block_decode.py::
decode_block_bits) against airjax, on the CPU, where it runs its plain
version: fed by the bit-emitting front (kernels/magdet.py::magdet_bits),
its dict equals airjax's `decode_iq_block` and `decode_iq_block_extended`
(airjax/pipeline.py:111-116, :279-284), whole dicts, on the inputs that
chip_smoke.py and tests/test_torch_cuda.py hold the kernel to at a small
size: DF17 frames in noise, every downlink format, 1-bit flips, an empty
mask, dense masks with K below the total and K = n_off, K = 0, and an n_off
that is a multiple of neither 32 nor TILE.

Inputs are made with numpy from a seed; every output is an integer or a
bit, so the tolerance is exact equality.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax.pipeline import decode_iq_block as jax_decode_iq_block
from airjax.pipeline import decode_iq_block_extended as jax_decode_iq_block_extended
from airjax_torch import pipeline
from airjax_torch.io import synth
from airjax_torch.kernels import block_decode as block_decode_mod
from airjax_torch.kernels.block_decode import decode_block_bits, decode_block_bits_plain
from airjax_torch.kernels.candidate import decode_candidates_extended_plain, decode_candidates_plain
from airjax_torch.kernels.magdet import TILE, magdet_bits
from torch_parity import assert_same_dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "airjax_torch" / "csrc"
N = 3 * TILE + 1000  # samples: 3 whole tiles and a ragged one


def _df17_traffic(n: int, seed: int, flips: bool) -> np.ndarray:
    """DF17 frames every 1999 samples; with flips, a third carry a 1-bit
    flip in data bits 5-87 (a DF-field flip fails the DF17 gate, so such a
    frame is never a candidate) and a third one in the CRC field."""
    rng = np.random.default_rng(seed)
    offsets = list(range(37, n - 240, 1999))
    frames = []
    for i, _ in enumerate(offsets):
        f = synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"BD{i:04d}"))
        if flips and i % 3 == 1:
            f = synth.flip_bit(f, int(rng.integers(5, 88)))
        elif flips and i % 3 == 2:
            f = synth.flip_bit(f, int(rng.integers(88, 112)))
        frames.append(f)
    return synth.modulate(frames, offsets, n, noise_std=50.0, seed=seed)


def _mixed(n: int, seed: int) -> np.ndarray:
    """Every downlink format, a third of the frames flipped in the data
    bits past the DF field, a third in the CRC field."""
    rng = np.random.default_rng(seed)
    frames = synth.make_mixed_frames(max(1, (n - 600) // 3000), seed)
    for i in range(1, len(frames), 3):
        frames[i] = synth.flip_bit(frames[i], int(rng.integers(5, 88 if len(frames[i]) == 14 else 32)))
    for i in range(2, len(frames), 3):
        lo = 88 if len(frames[i]) == 14 else 32
        frames[i] = synth.flip_bit(frames[i], int(rng.integers(lo, 8 * len(frames[i]))))
    return synth.modulate(frames, [300 + 300 * i for i in range(len(frames))], n, seed=seed)


def _case(name: str) -> tuple[np.ndarray, int, int]:
    """name -> (IQ, n_off, capacity K)."""
    if name == "df17 frames":
        return _df17_traffic(N, 1, flips=False), N - 240, 64
    if name == "flips":
        return _df17_traffic(N, 2, flips=True), N - 240, 64
    if name == "mixed":
        return _mixed(N, 3), N - 240, 512
    if name == "empty":  # the non-detecting pad pattern: no offset passes either gate
        return pipeline.pad_iq_non_detecting(np.zeros((0, 2), np.int16), N), N - 240, 128
    # Dense: constant magnitudes pass both gates at every offset (a whole
    # tile of 8192 detections and more), then small-range noise (ties).
    dense = np.random.default_rng(4).integers(-2, 3, size=(N, 2), dtype=np.int16)
    dense[: TILE + 3000] = (7, -3)
    if name == "dense, K < total":
        return dense, N - 240, 300
    if name == "dense, K = n_off":
        return dense, N - 240, N - 240
    if name == "K = 0":
        return _df17_traffic(N, 5, flips=True), N - 240, 0
    if name == "ragged":  # n_off a multiple of neither 32 nor TILE, n_off < TILE too
        n = 5000 + 241 + 13
        return _df17_traffic(n, 6, flips=True), n - 240 - 7, 16
    raise KeyError(name)


CASES = ["df17 frames", "flips", "mixed", "empty", "dense, K < total", "dense, K = n_off", "K = 0", "ragged"]


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_block_decode_matches_airjax(case, extended):
    iq, n_off, k = _case(case)
    if extended:
        want = jax.device_get(jax_decode_iq_block_extended(jnp.asarray(iq), n_off, k))
    else:
        want = jax.device_get(jax_decode_iq_block(jnp.asarray(iq), n_off, k))
    det_words, words, counts = magdet_bits(torch.as_tensor(iq), n_off, "preamble" if extended else "df17")
    got = decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
    assert_same_dict(want, pipeline.to_host(got))
    total = int(counts.sum())
    assert int(got["n_detections"]) == total
    if case == "empty":
        assert total == 0
    elif case.startswith("dense"):
        assert total > TILE + 2000 and (total > k) == (case == "dense, K < total")
    elif case == "K = 0":
        assert total > 0
    else:
        assert 0 < total <= k
    if case in ("df17 frames", "flips") and not extended:
        assert int(got["n_good"]) > 0 and (case == "df17 frames" or bool(got["recovered"].any()))


@pytest.mark.parametrize("extended", [False, True])
def test_empty_slots_carry_the_offset_zero_decode(extended):
    """airjax slices an empty slot (s >= min(total, K)) at offset 0 and
    leaves its frame unmasked: offsets n_off, every flag false, and the
    frame bytes, DF and residuals of the decode at offset 0. A DF17 frame
    sits at offset 0 here, so that decode is a valid frame, not zeros."""
    frame = synth.make_df17(0x4840D6, synth.make_id_me("EMPTY01"))
    n = 3000
    iq = synth.modulate([frame, frame], [0, 1500], n, noise_std=40.0, seed=7)
    n_off, k = n - 240, 8
    det_words, words, counts = magdet_bits(torch.as_tensor(iq), n_off, "preamble" if extended else "df17")
    got = decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
    total = int(got["n_detections"])
    assert 0 < total < k and int(got["offsets"][0]) == 0
    empty = slice(total, k)
    assert (got["offsets"][empty] == n_off).all() and not got["valid"][empty].any()
    zero = torch.zeros(1, dtype=torch.int32)
    if extended:
        at0 = decode_candidates_extended_plain(words, zero, torch.zeros(1, dtype=torch.bool))
        for key in ("frames", "frames_raw", "df", "icao_ap_long", "icao_ap_short"):
            assert torch.equal(got[key][empty], at0[key].expand_as(got[key][empty])), key
        for key in block_decode_mod.CLASSES:
            assert not got[key][empty].any(), key
        assert bytes(got["frames"][k - 1].numpy()) == frame and int(got["df"][k - 1]) == 17
    else:
        frames0, ok0, _ = decode_candidates_plain(words, zero)
        assert bool(ok0[0]) and bytes(frames0[0].numpy()) == frame
        assert torch.equal(got["frames"][empty], frames0.expand(k - total, -1))
        assert not got["good"][empty].any() and not got["recovered"][empty].any()
        assert int(got["n_good"]) == int(got["good"].sum()) == total


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    iq, n_off, k = _case("flips")
    det_words, words, counts = magdet_bits(torch.as_tensor(iq), n_off)
    before = block_decode_mod.launches
    for extended in (False, True):
        got = decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
        want = decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended)
        assert_same_dict(pipeline.to_host(want), pipeline.to_host(got))
    assert block_decode_mod.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    iq = torch.as_tensor(np.random.default_rng(9).integers(-99, 99, (1000, 2), dtype=np.int16))
    det_words, words, counts = magdet_bits(iq, 500)
    with pytest.raises(ValueError):
        decode_block_bits(det_words, words, counts, 600, 16)  # words for another n_off
    with pytest.raises(ValueError):
        decode_block_bits(det_words, words, counts[:0], 500, 16)
    with pytest.raises(ValueError):
        decode_block_bits(det_words, words.to(torch.int64), counts, 500, 16)
    with pytest.raises(ValueError):
        decode_block_bits(det_words, words[:0], counts, 500, 16)
    with pytest.raises(ValueError):
        decode_block_bits(det_words, words, counts, 500, -1)
    with pytest.raises(ValueError):
        decode_block_bits(det_words.to("meta"), words.to("meta"), counts.to("meta"), 500, 16)


def test_kernel_sources_share_the_candidate_decode():
    """Both kernels decode through candidate.cuh, whose __constant__
    syndromes exist once per translation unit: the one loader fills both
    copies, and the tile size is the front's."""
    header = (CSRC / "candidate.cuh").read_text()
    cand, block = (CSRC / "candidate.cu").read_text(), (CSRC / "block_decode.cu").read_text()
    for src in (cand, block):
        assert '#include "candidate.cuh"' in src and "slice_candidate(" in src and "repair(" in src
        assert not re.search(r"__constant__ \w+ c_syndromes", src)
    assert header.count("__constant__ uint32_t c_syndromes") == 1
    assert "load_block_decode_syndromes(host)" in cand
    assert "int load_block_decode_syndromes(const void* host) { return load_syndromes(host); }" in block
    (tile,) = re.findall(r"constexpr int kTile = (\d+);", block)
    assert int(tile) == TILE
