"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no jax, so that it also runs where only torch is installed:

  python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(--noconftest: tests/conftest.py configures jax). The equality of the
plain versions with airjax is tested on the CPU by the other
tests/test_torch_*.py files. Every output is an integer or a bit: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from airjax_torch import pipeline
from airjax_torch.dsp.demod import pack_cmp_words, pack_msb_words
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.io import synth
from airjax_torch.kernels import block_decode as block_decode_mod
from airjax_torch.kernels import candidate as candidate_mod
from airjax_torch.kernels import compact as compact_mod
from airjax_torch.kernels import magdet as magdet_mod
from airjax_torch.kernels import stencil3 as stencil3_mod
from torch_parity import assert_same_dict, cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _random_iq(n: int, seed: int) -> np.ndarray:
    iq = np.random.default_rng(seed).integers(-32768, 32768, size=(n, 2), dtype=np.int16)
    iq[:6] = [[-32768, -32768], [32767, 32767], [-32768, 32767], [0, 0], [1, 0], [3, 4]]
    return iq


def _iq(n: int, seed: int, kind: str) -> np.ndarray:
    """Full-range noise, small-range noise (ties and detections at nearly
    every tile edge) or DF17 traffic."""
    if kind == "random":
        return _random_iq(n, seed)
    if kind == "small":
        return np.random.default_rng(seed).integers(-2, 3, size=(n, 2), dtype=np.int16)
    return _traffic(n, seed, spacing=1999)[0]


def _mixed(n: int, seed: int) -> np.ndarray:
    """Every downlink format, a third of the frames with a 1-bit flip in
    data bits 5-87 or in the CRC field."""
    rng = np.random.default_rng(seed)
    frames = synth.make_mixed_frames(max(1, (n - 600) // 3000), seed)
    for i in range(1, len(frames), 3):
        frames[i] = synth.flip_bit(frames[i], int(rng.integers(5, 88 if len(frames[i]) == 14 else 32)))
    for i in range(2, len(frames), 3):
        lo = 88 if len(frames[i]) == 14 else 32
        frames[i] = synth.flip_bit(frames[i], int(rng.integers(lo, 8 * len(frames[i]))))
    offsets = [300 + 300 * i for i in range(len(frames))]
    return synth.modulate(frames, offsets, n, seed=seed)


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


def _counts() -> tuple[int, int, int, int, int]:
    """Launches of the bit-emitting front, the block-decode kernel, and the
    compaction, candidate and old front kernels (which the block decodes no
    longer run)."""
    return (magdet_mod.bits_launches, block_decode_mod.launches, compact_mod.launches,
            candidate_mod.launches, magdet_mod.launches)


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
    before = _counts()
    got = pipeline.to_host(pipeline.decode_iq_block(iq_dev, n_off, 512))
    assert _counts() == tuple(n + 1 for n in before[:2]) + before[2:]
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
        m0, b0 = magdet_mod.bits_launches, block_decode_mod.launches
        assert decode(iq, device=cuda_device) == decode(iq, device="cpu")
        assert magdet_mod.bits_launches > m0 and block_decode_mod.launches > b0


@pytest.mark.parametrize("n", [265, 20239, 65536 + 777, (1 << 20) + 1024])
@pytest.mark.parametrize("kind", ["random", "small", "frames"])
@pytest.mark.parametrize("variant", ["tree32", "tree16", "flat16"])
def test_stencil_variant_matches_plain_and_flat_front(cuda_device, variant, kind, n):  # noqa: F811
    iq = torch.as_tensor(_iq(n, n, kind)).to(cuda_device)
    before = stencil3_mod.launches
    det, cmp = stencil3_mod.magdet_tree(iq, n - 240, variant)
    assert stencil3_mod.launches == before + 1
    det_p, cmp_p = stencil3_mod.magdet_tree_plain(iq, n - 240, variant)
    det_f, cmp_f = magdet_mod.magdet(iq, n - 240, packed=False)
    torch.cuda.synchronize()
    assert torch.equal(det, det_p) and torch.equal(cmp, cmp_p)
    assert torch.equal(det, det_f) and torch.equal(cmp, cmp_f)


@pytest.mark.parametrize("n", [265, 20239, 65536 + 777, (1 << 20) + 1024])
@pytest.mark.parametrize("packed", [True, False])
def test_preamble_gate_matches_plain(cuda_device, n, packed):  # noqa: F811
    for kind in ("random", "small"):
        iq = torch.as_tensor(_iq(n, n + 1, kind)).to(cuda_device)
        det, out = magdet_mod.magdet(iq, n - 240, packed=packed, gate="preamble")
        det_p, out_p = magdet_mod.magdet_plain(iq, n - 240, packed=packed, gate="preamble")
        torch.cuda.synchronize()
        assert torch.equal(det, det_p) and torch.equal(out, out_p)


@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_extended_candidate_kernel_matches_plain(cuda_device, kind):  # noqa: F811
    rng = np.random.default_rng(9)
    n = 60000
    if kind == "mixed":
        words = pack_cmp_words(magnitude_u16(torch.as_tensor(_mixed(n, 9))))
        offsets = np.concatenate([300 + 300 * np.arange(190), rng.integers(0, n - 240, 300), [0, n - 240]])
    else:
        words = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, n // 32 + 8, dtype=np.int32))
        offsets = rng.integers(0, n - 240, 500)
    w = words.to(cuda_device)
    o = torch.as_tensor(offsets.astype(np.int32)).to(cuda_device)
    valid = torch.as_tensor(rng.random(len(offsets)) < 0.9).to(cuda_device)  # some invalid slots
    before = candidate_mod.launches
    got = candidate_mod.decode_candidates_extended(w, o, valid)
    assert candidate_mod.launches == before + 1
    want = candidate_mod.decode_candidates_extended_plain(w, o, valid)
    torch.cuda.synchronize()
    assert_same_dict(want, got)
    if kind == "mixed":
        assert all(bool(got[c].any()) for c in candidate_mod.CLASSES)


def test_extended_block_kernel_path_matches_plain_path(cuda_device):  # noqa: F811
    n = (1 << 20) + 1024
    iq_dev = torch.as_tensor(_mixed(n, 10)).to(cuda_device)
    n_off = (1 << 20) - 240
    before = _counts()
    got = pipeline.to_host(pipeline.decode_iq_block_extended(iq_dev, n_off, 1 << 14))
    assert _counts() == tuple(n + 1 for n in before[:2]) + before[2:]
    assert not got["overflow"]
    want = pipeline.to_host(pipeline.decode_mags_block_extended(magnitude_u16(iq_dev), n_off, 1 << 14))
    assert_same_dict(want, got)
    cpu = pipeline.to_host(pipeline.decode_iq_block_extended(iq_dev.cpu(), n_off, 1 << 14))
    assert_same_dict(cpu, got)


@pytest.mark.parametrize("n", [265, 20239, 65536 + 777, (1 << 20) + 1024])
@pytest.mark.parametrize("kind", ["random", "small", "frames"])
@pytest.mark.parametrize("gate", ["df17", "preamble"])
@pytest.mark.parametrize("skip", [0, 1, 2, 3])
def test_bits_front_matches_plain_and_old_front(cuda_device, skip, gate, kind, n):  # noqa: F811
    """The bit-emitting front against its plain version and against the old
    front's mask packed, from a base `skip` samples (4 bytes each) past a
    16-byte boundary."""
    iq = torch.as_tensor(_iq(n + skip, n, kind)).to(cuda_device)[skip:]
    assert iq.data_ptr() % 16 == 4 * skip
    n_off = n - 240
    before = magdet_mod.bits_launches
    got = magdet_mod.magdet_bits(iq, n_off, gate)
    assert magdet_mod.bits_launches == before + 1
    want = magdet_mod.magdet_bits_plain(iq, n_off, gate)
    det, words = magdet_mod.magdet(iq, n_off, gate=gate)
    old = (pack_msb_words(det, magdet_mod.n_det_words(n_off)), words, magdet_mod.tile_counts(det))
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, old):
        assert torch.equal(a, b) and torch.equal(a, c)


def _compaction_input(case: str, device) -> tuple[torch.Tensor, int]:
    """(mask, capacity K) for each input chip_smoke.py holds the kernel to."""
    rng = np.random.default_rng(len(case))
    if case == "traffic block":
        iq = torch.as_tensor(_traffic((1 << 20) + 1024, 12, spacing=1999)[0]).to(device)
        return magdet_mod.magdet(iq, 1 << 20)[0].bool(), 1024
    n_off, p, k = {
        "empty": (100_000, 0.0, 2048), "dense, K < total": ((1 << 20) + 77, 0.3, 100_000),
        "dense, K = n_off": ((1 << 20) + 77, 0.3, (1 << 20) + 77), "ragged": (3 * 8192 + 1007, 0.5, 64),
        "all set": (50_000, 1.0, 50_000), "no offsets": (0, 0.0, 16), "capacity 0": (20_000, 0.5, 0),
    }[case]
    return torch.as_tensor(rng.random(n_off) < p).to(device), k


@pytest.mark.parametrize("case", ["traffic block", "empty", "dense, K < total", "dense, K = n_off",
                                  "ragged", "all set", "no offsets", "capacity 0"])
def test_compaction_kernel_matches_plain(cuda_device, case):  # noqa: F811
    det, k = _compaction_input(case, cuda_device)
    n_off = det.shape[0]
    det_words = pack_msb_words(det, magdet_mod.n_det_words(n_off))
    counts = magdet_mod.tile_counts(det)
    before = compact_mod.launches
    got = compact_mod.compact_bits(det_words, counts, n_off, k)
    assert compact_mod.launches == before + 1
    want = compact_mod.compact_bits_plain(det_words, counts, n_off, k)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _block_case(name: str, n: int) -> tuple[np.ndarray, int, int]:
    """(IQ, n_off, capacity K) for each input tests/test_torch_block_decode.py
    holds the plain version to, at n samples."""
    if name == "df17 frames":
        return _traffic(n, 21, spacing=1999)[0], n - 240, 1024
    if name == "flips":
        return _traffic(n, 22, spacing=997)[0], n - 240, 2048
    if name == "mixed":
        return _mixed(n, 23), n - 240, 1 << 14
    if name == "empty":
        return pipeline.pad_iq_non_detecting(np.zeros((0, 2), np.int16), n), n - 240, 2048
    # Dense: constant magnitudes pass both gates at every offset (whole
    # tiles of 8192 detections), then small-range noise (ties).
    dense = np.random.default_rng(24).integers(-2, 3, size=(n, 2), dtype=np.int16)
    dense[: 3 * 8192 + 3000] = (7, -3)
    if name == "dense, K < total":
        return dense, n - 240, 10_000
    if name == "dense, K = n_off":
        return dense, n - 240, n - 240
    if name == "K = 0":
        return _traffic(n, 25)[0], n - 240, 0
    if name == "ragged":  # n_off a multiple of neither 32 nor TILE
        return _traffic(n, 26)[0], n - 240 - 7, 64
    raise KeyError(name)


BLOCK_CASES = ["df17 frames", "flips", "mixed", "empty", "dense, K < total", "dense, K = n_off", "K = 0",
               "ragged"]


def _check_block_decode(iq: torch.Tensor, n_off: int, k: int, extended: bool) -> dict:
    """The block-decode kernel on the front's bits against its plain version
    and the staged chain (compaction and candidate kernels, then the dict
    ops), bit for bit; one launch. Returns the kernel's dict on the host."""
    det_words, words, counts = magdet_mod.magdet_bits(iq, n_off, "preamble" if extended else "df17")
    before = block_decode_mod.launches
    got = block_decode_mod.decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
    assert block_decode_mod.launches == before + 1
    want = block_decode_mod.decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended)
    staged = pipeline.decode_iq_block_staged(iq, n_off, k, extended=extended)
    got = pipeline.to_host(got)
    assert_same_dict(pipeline.to_host(want), got)
    assert_same_dict(pipeline.to_host(staged), got)
    assert int(got["n_detections"]) == int(counts.sum())
    return got


@pytest.mark.parametrize("skip", [0, 1, 2, 3])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_decode_kernel_matches_plain_and_staged(cuda_device, case, extended, skip):  # noqa: F811
    """From a base `skip` samples (4 bytes each) past a 16-byte boundary."""
    iq, n_off, k = _block_case(case, (1 << 17) + 1024)
    iq = torch.as_tensor(np.concatenate([np.zeros((skip, 2), np.int16), iq])).to(cuda_device)[skip:]
    assert iq.data_ptr() % 16 == 4 * skip
    got = _check_block_decode(iq, n_off, k, extended)
    if case in ("df17 frames", "flips") and not extended:
        assert got["n_good"] > 0 and (case == "df17 frames" or got["recovered"].any())


@pytest.mark.parametrize("k", [0, 64, 100_000, (1 << 20) + 77])
def test_block_decode_kernel_on_random_bits(cuda_device, k):  # noqa: F811
    """A random mask (a detection at 3 in 10 offsets) over random compare
    words: random frames at random offsets, in both modes."""
    rng = np.random.default_rng(k)
    n_off = (1 << 20) + 77
    det = torch.as_tensor(rng.random(n_off) < 0.3).to(cuda_device)
    det_words = pack_msb_words(det, magdet_mod.n_det_words(n_off))
    counts = magdet_mod.tile_counts(det)
    words = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, n_off // 32 + 16, dtype=np.int32)).to(cuda_device)
    for extended in (False, True):
        got = block_decode_mod.decode_block_bits(det_words, words, counts, n_off, k, extended=extended)
        want = block_decode_mod.decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended)
        assert_same_dict(pipeline.to_host(want), pipeline.to_host(got))


@pytest.mark.parametrize("extended", [False, True])
def test_block_decode_kernel_at_2_24(cuda_device, extended):  # noqa: F811
    """The 2^24-offset block of chip_smoke.py, K = 2048 (DF17) or the
    detections rounded up to 1024 (extended), through
    decode_iq_block(_extended): two launches."""
    n = (1 << 24) + 1024
    n_off = (1 << 24) - 240
    if extended:
        frames = synth.make_mixed_frames(1024, 27)
        iq = synth.modulate(frames, [300 + 1600 * i for i in range(len(frames))], n, seed=27)
    else:
        iq = _traffic(n, 28, spacing=16001)[0]
    iq_dev = torch.as_tensor(iq).to(cuda_device)
    # The capacity that holds the plain path's detections, rounded up to
    # 1024, as chip_smoke.py sizes it (21,504 there in the extended mode).
    detect = magdet_mod.magdet_plain(iq_dev, n_off, gate="preamble" if extended else "df17")[0]
    k = -(-int(detect.sum()) // 1024) * 1024 if extended else 2048
    got = _check_block_decode(iq_dev, n_off, k, extended)
    assert not got["overflow"] and got["n_detections"] > 0
    before = _counts()
    fused = pipeline.decode_iq_block_extended if extended else pipeline.decode_iq_block
    assert_same_dict(got, pipeline.to_host(fused(iq_dev, n_off, k)))
    assert _counts() == tuple(n + 1 for n in before[:2]) + before[2:]
