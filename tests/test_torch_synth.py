"""airjax_torch.io.synth.modulate_device against airjax/io/synth.py's, on
the CPU. Without noise the capture is airjax's bit for bit: overlapping
frames, four frames on one sample (the int16 clip), the first and the
last offset that fit, and offsets outside (airjax's dynamic_slice moves
them: a negative start counts from the end, then the start is clamped).
With noise (whose stream is torch's, not JAX's) a seed gives one capture,
the noise has the asked-for mean and deviation, and the port's decode
finds every embedded frame at its offset, as airjax's decode of airjax's
capture does."""

import numpy as np
import jax
import pytest
import torch

from airjax import pipeline as jp
from airjax.io import synth as jsynth
from airjax_torch import pipeline as tp
from airjax_torch.io import synth

N = 20000


def _frames(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"DEV{i:05d}")) for i in range(n)]


CASES = {
    "spread": list(range(0, N - 240, 997)),
    "overlapping": [100, 150, 151, 230, 5000, 5001],
    "four_on_one_sample": [300, 300, 300, 300, 9000],
    "edges": [0, N - 240, 7000],
    "outside": [N - 239, N + 5000, -1, -10, -300, -N - 500, 2000],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_without_noise_equals_airjax(case):
    offsets = CASES[case]
    frames = _frames(len(offsets), len(case))
    want = np.asarray(jsynth.modulate_device(frames, offsets, N, noise_std=0.0))
    got = synth.modulate_device(frames, offsets, N, noise_std=0.0, device="cpu")
    assert got.dtype == torch.int16 and got.shape == (N, 2) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "four_on_one_sample":
        assert int(got[300, 0]) == 32767  # 4 x 10,000 clipped
    if case == "edges":
        np.testing.assert_array_equal(got.numpy(), synth.modulate(frames, offsets, N, noise_std=0.0))
    assert not got[:, 1].any()


def test_noise_is_seeded_and_has_its_moments():
    """Q holds noise alone: mean within 1.0 of 0 (4 standard errors at
    2 x 10^5 samples) and deviation within 2% of sigma (the rounding adds
    1/12 to the variance)."""
    frames = _frames(8, 1)
    offsets = [1000 * (i + 1) for i in range(8)]
    n = 200_000
    a = synth.modulate_device(frames, offsets, n, seed=3, device="cpu")
    assert torch.equal(a, synth.modulate_device(frames, offsets, n, seed=3, device="cpu"))
    assert not torch.equal(a, synth.modulate_device(frames, offsets, n, seed=4, device="cpu"))
    for sigma in (60.0, 7.5):
        q = synth.modulate_device(frames, offsets, n, noise_std=sigma, seed=5, device="cpu")[:, 1].double()
        assert abs(float(q.mean())) < 1.0
        assert abs(float(q.std()) / sigma - 1.0) < 0.02


def test_its_capture_decodes_to_the_embedded_frames():
    frames = _frames(30, 2)
    offsets = [211 + 3001 * i for i in range(30)]
    n = 92_000
    iq = synth.modulate_device(frames, offsets, n, seed=6, device="cpu").numpy()
    hits, _ = tp.decode_capture_overlap(iq, device="cpu")
    assert [(h[1], h[2]) for h in hits] == list(zip(offsets, frames))
    j_iq = np.asarray(jsynth.modulate_device(frames, offsets, n, seed=6))
    j_hits, _ = jp.decode_capture_overlap(j_iq)
    assert [(h[1], h[2]) for h in j_hits] == list(zip(offsets, frames))


@pytest.mark.parametrize("bad", ["empty", "short_frame", "offsets", "short_capture"])
def test_refuses_what_airjax_cannot_build(bad):
    frames, offsets, n = _frames(2, 3), [0, 500], 2000
    if bad == "empty":
        frames, offsets = [], []
    elif bad == "short_frame":
        frames = [frames[0], frames[1][:7]]
    elif bad == "offsets":
        offsets = [0]
    else:
        n = 239
    with pytest.raises(ValueError):
        synth.modulate_device(frames, offsets, n, device="cpu")
    with pytest.raises(Exception):
        jax.block_until_ready(jsynth.modulate_device(frames, offsets, n))
