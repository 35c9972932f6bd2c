"""The port's front kernel wrapper (airjax_torch.kernels.magdet) against
airjax: mode planes against the Pallas `magdet_fused` in interpret mode,
mode packed against `detect` + `pack_cmp_words`. On the CPU the wrapper
runs the plain version; the kernel itself is compared with it on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from airjax.dsp.demod import detect as jax_detect
from airjax.dsp.demod import pack_cmp_words as jax_pack_cmp_words
from airjax.dsp.magnitude import magnitude_u16 as jax_magnitude_u16
from airjax.kernels.magdet import TILE, magdet_fused, pad_for_kernel
from airjax_torch.dsp.demod import n_words
from airjax_torch.kernels import magdet as magdet_mod
from airjax_torch.kernels.magdet import magdet, magdet_plain
from torch_parity import assert_same

EXTREMES = [
    [-32768, -32768], [32767, 32767], [0, 0], [1, 0],
    [-32768, 0], [3, 4], [255, 255], [256, 256],
]


def _iq(n: int, seed: int, lo: int = -32768, hi: int = 32768) -> np.ndarray:
    rng = np.random.default_rng(seed)
    iq = rng.integers(lo, hi, size=(n, 2), dtype=np.int16)
    iq[:8] = EXTREMES
    return iq


def _frames_iq(n: int, seed: int) -> np.ndarray:
    """Noise with decodable DF17 frames, so that detections occur."""
    from airjax_torch.io import synth

    frame = synth.make_df17(0x40621D, synth.make_id_me("FRONT01"))
    offsets = list(range(min(37, (n - 240) // 2), n - 240, 3001))
    return synth.modulate([frame] * len(offsets), offsets, n, noise_std=50.0, seed=seed)


def test_planes_match_pallas_magdet_fused():
    padded, n_dom = pad_for_kernel(jnp.asarray(_iq(TILE + 777, 0)))
    det_k, cmp_k = magdet_fused(padded, interpret=True)
    det, cmp = magdet(torch.as_tensor(np.array(padded)), n_dom, packed=False)
    assert det.dtype == torch.uint8 and cmp.dtype == torch.uint8
    assert cmp.shape[0] == padded.shape[0] - 1
    assert_same(np.asarray(det_k), det)
    assert_same(np.asarray(cmp_k), cmp[:n_dom])


@pytest.mark.parametrize("n", [265, 20239, 65536 + 777, 4096 + 1])
@pytest.mark.parametrize("noise", ["random", "frames"])
def test_packed_matches_detect_and_pack_cmp_words(n, noise):
    iq = _iq(n, n) if noise == "random" else _frames_iq(n, n)
    n_off = n - 240
    mags = jax_magnitude_u16(jnp.asarray(iq))
    det_x = np.asarray(jax_detect(mags, n_off)).astype(np.uint8)
    words_x = np.asarray(jax_pack_cmp_words(mags))
    det, words = magdet(torch.as_tensor(iq), n_off)
    assert words.dtype == torch.int32
    assert words.shape[0] == n_words(n) == 4 * -(-(n - 1) // 128) + 8
    assert_same(det_x, det)
    assert_same(words_x, words)
    assert not words[-8:].any()
    if noise == "frames":
        assert int(det.sum()) > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    iq = torch.as_tensor(_iq(1000, 1))
    with pytest.raises(ValueError):
        magdet(iq.to(torch.int32), 500)
    with pytest.raises(ValueError):
        magdet(iq.t().contiguous().t(), 500)  # non-contiguous view
    with pytest.raises(ValueError):
        magdet(iq, 1000 - 24)  # the taps would reach past the block
    with pytest.raises(ValueError):
        magdet(iq.to("meta"), 500)  # neither CPU nor CUDA


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    iq = torch.as_tensor(_iq(3000, 2))
    before = magdet_mod.launches
    det, words = magdet(iq, 2500)
    det_p, words_p = magdet_plain(iq, 2500)
    assert magdet_mod.launches == before
    assert torch.equal(det, det_p) and torch.equal(words, words_p)
