"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no jax, so that it also runs where only torch is installed:

  python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(--noconftest: tests/conftest.py configures jax). The equality of the
plain versions with airjax is tested on the CPU by the other
tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

from airjax_torch import pipeline
from airjax_torch.dsp.demod import pack_cmp_words
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.io import synth
from airjax_torch.kernels import candidate as candidate_mod
from airjax_torch.kernels import magdet as magdet_mod
from torch_parity import assert_same_dict, cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _random_iq(n: int, seed: int) -> np.ndarray:
    iq = np.random.default_rng(seed).integers(-32768, 32768, size=(n, 2), dtype=np.int16)
    iq[:6] = [[-32768, -32768], [32767, 32767], [-32768, 32767], [0, 0], [1, 0], [3, 4]]
    return iq


def _traffic(n: int, seed: int, spacing: int = 3001) -> tuple[np.ndarray, list[bytes]]:
    """DF17 frames every `spacing` samples: a third with a data-bit flip
    (past the DF field, whose flip would fail the DF17 gate), a third with
    a CRC-field flip."""
    rng = np.random.default_rng(seed)
    offsets = list(range(100, n - 240, spacing))
    clean, sent = [], []
    for i, _ in enumerate(offsets):
        f = synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"CU{i % 1000:03d}"))
        clean.append(f)
        if i % 3 == 1:
            f = synth.flip_bit(f, int(rng.integers(5, 88)))
        elif i % 3 == 2:
            f = synth.flip_bit(f, int(rng.integers(88, 112)))
        sent.append(f)
    return synth.modulate(sent, offsets, n, seed=seed), clean


@pytest.mark.parametrize("n", [265, 20239, 65536 + 777, (1 << 20) + 1024])
@pytest.mark.parametrize("packed", [True, False])
def test_front_kernel_matches_plain(cuda_device, n, packed):  # noqa: F811
    iq = torch.as_tensor(_random_iq(n, n)).to(cuda_device)
    before = magdet_mod.launches
    det, out = magdet_mod.magdet(iq, n - 240, packed=packed)
    assert magdet_mod.launches == before + 1
    det_p, out_p = magdet_mod.magdet_plain(iq, n - 240, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(det, det_p) and torch.equal(out, out_p)


@pytest.mark.parametrize("kind", ["frames", "random"])
def test_candidate_kernel_matches_plain(cuda_device, kind):  # noqa: F811
    rng = np.random.default_rng(5)
    n = 30000
    if kind == "frames":
        iq, _ = _traffic(n, 5, spacing=297)
        words = pack_cmp_words(magnitude_u16(torch.as_tensor(iq)))
        offsets = np.concatenate([np.arange(100, n - 240, 297), [0, n - 240]])
    else:
        words = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, n // 32 + 8, dtype=np.int32))
        offsets = rng.integers(0, n - 240, 300)
    w = words.to(cuda_device)
    o = torch.as_tensor(offsets.astype(np.int32)).to(cuda_device)
    before = candidate_mod.launches
    got = candidate_mod.decode_candidates(w, o)
    assert candidate_mod.launches == before + 1
    want = candidate_mod.decode_candidates_plain(w, o)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_block_kernel_path_matches_plain_path(cuda_device):  # noqa: F811
    n = (1 << 20) + 1024
    iq, clean = _traffic(n, 6)
    iq_dev = torch.as_tensor(iq).to(cuda_device)
    n_off = (1 << 20) - 240
    m0, c0 = magdet_mod.launches, candidate_mod.launches
    got = pipeline.to_host(pipeline.decode_iq_block(iq_dev, n_off, 512))
    assert magdet_mod.launches == m0 + 1 and candidate_mod.launches == c0 + 1
    want = pipeline.to_host(pipeline.decode_mags_block(magnitude_u16(iq_dev), n_off, 512))
    assert_same_dict(want, got)
    cpu = pipeline.to_host(pipeline.decode_iq_block(torch.as_tensor(iq), n_off, 512))
    assert_same_dict(cpu, got)
    decoded = [bytes(f) for f in got["frames"][got["good"]]]
    assert decoded == [f for i, f in enumerate(clean) if i % 3 != 2]


def test_capture_decodes_on_card_equal_cpu(cuda_device):  # noqa: F811
    """decode_capture_overlap / decode_capture_parity through the kernels
    (parity's chunked detection count included) equal the CPU port."""
    iq, _ = _traffic(5 * 20000 + 1234, 8, spacing=4999)
    for decode in (pipeline.decode_capture_overlap, pipeline.decode_capture_parity):
        m0 = magdet_mod.launches
        assert decode(iq, device=cuda_device) == decode(iq, device="cpu")
        assert magdet_mod.launches > m0
