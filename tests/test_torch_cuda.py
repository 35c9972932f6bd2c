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
from airjax_torch.kernels import shard_gather as shard_gather_mod
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
    """Mode packed launches csrc/magdet.cu, mode planes csrc/planes.cu."""
    iq = torch.as_tensor(_random_iq(n, n)).to(cuda_device)
    before = (magdet_mod.launches, magdet_mod.planes_launches)
    det, out = magdet_mod.magdet(iq, n - 240, packed=packed)
    assert (magdet_mod.launches, magdet_mod.planes_launches) == (before[0] + packed, before[1] + (not packed))
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


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n, short", [(265, 240), (8193, 25), (8194, 25), (20239, 240), (65536 + 777, 240),
                                      ((1 << 20) + 1024, 240)])
@pytest.mark.parametrize("form, gate", [("front", "df17"), ("front", "preamble"), ("tree32", "df17"),
                                        ("tree16", "df17"), ("flat16", "df17")])
def test_planes_kernel_matches_plain_and_baseline(cuda_device, form, gate, n, short, misaligned):  # noqa: F811
    """csrc/planes.cu in each form and gate (through magdet(packed=False)
    or magdet_tree) == its plain version == the first forms
    (magdet_planes_baseline), at ragged lengths, at n_off = L - 25 and from
    a base 4 bytes past a 16-byte boundary; one launch of the new kernel a
    call and none of the baseline."""
    for kind in ("random", "small"):
        raw = torch.as_tensor(_iq(n + 1, n + short, kind)).to(cuda_device)
        iq = raw[1:] if misaligned else raw[:n]
        assert (iq.data_ptr() % 16 == 4) == misaligned
        n_off = n - short
        before = (magdet_mod.planes_launches, stencil3_mod.launches, magdet_mod.baseline_launches)
        if form == "front":
            det, cmp = magdet_mod.magdet(iq, n_off, packed=False, gate=gate)
            det_p, cmp_p = magdet_mod.magdet_plain(iq, n_off, packed=False, gate=gate)
        else:
            det, cmp = stencil3_mod.magdet_tree(iq, n_off, form)
            det_p, cmp_p = stencil3_mod.magdet_tree_plain(iq, n_off, form)
        new = (1, 0) if form == "front" else (0, 1)
        assert (magdet_mod.planes_launches, stencil3_mod.launches, magdet_mod.baseline_launches) == (
            before[0] + new[0], before[1] + new[1], before[2])
        det_b, cmp_b = magdet_mod.magdet_planes_baseline(iq, n_off, form, gate)
        assert magdet_mod.baseline_launches == before[2] + 1
        torch.cuda.synchronize()
        assert torch.equal(det, det_p) and torch.equal(cmp, cmp_p)
        assert torch.equal(det, det_b) and torch.equal(cmp, cmp_b)


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


def _pair_flips(n: int, seed: int, extended: bool) -> np.ndarray:
    """2-bit flips (bits 5-87 for DF17; anywhere, the DF field included, for
    every format, and bits 5-87 of every second DF17, which the extended
    decode then counts in good_long), 1-bit flips, 3-bit bursts and
    CRC-field flips."""
    rng = np.random.default_rng(seed)
    if extended:
        frames = synth.make_mixed_frames(max(1, (n - 600) // 3000), seed)
    else:
        frames = [synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"R2{i % 1000:03d}"))
                  for i in range((n - 600) // 300)]
    for i, f in enumerate(frames):
        lo, nbits = (0 if extended else 5), 8 * len(f)
        kind = i % 5
        if extended and i % 20 == 0:
            frames[i] = _flip(f, rng.choice(np.arange(5, 88), 2, replace=False))
        elif kind == 1:
            frames[i] = _flip(f, rng.choice(np.arange(lo, nbits - 24), 2, replace=False))
        elif kind == 2:
            frames[i] = _flip(f, [int(rng.integers(lo, nbits - 24))])
        elif kind == 3:
            frames[i] = _flip(f, rng.choice(np.arange(lo, nbits), 3, replace=False))
        elif kind == 4:
            frames[i] = _flip(f, rng.choice(np.arange(nbits - 24, nbits), 2, replace=False))
    offsets = [300 + 300 * i for i in range(len(frames))]
    return synth.modulate(frames, offsets, n, seed=seed)


def _flip(frame: bytes, bits) -> bytes:
    for b in bits:
        frame = synth.flip_bit(frame, int(b))
    return frame


R2_CASES = BLOCK_CASES + ["pair flips"]


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("case", R2_CASES)
def test_block_decode_r2_matches_plain(cuda_device, case, extended):  # noqa: F811
    """The R2 instantiations against their plain version (crc_check_and_
    recover2); where no pair repair applies, the dict without recovered2
    equals the mode without R2."""
    n = (1 << 17) + 1024
    if case == "pair flips":
        iq, n_off, k = _pair_flips(n, 29, extended), n - 240, 1 << 14
    else:
        iq, n_off, k = _block_case(case, n)
    iq = torch.as_tensor(iq).to(cuda_device)
    det_words, words, counts = magdet_mod.magdet_bits(iq, n_off, "preamble" if extended else "df17")
    before = block_decode_mod.launches
    got = block_decode_mod.decode_block_bits(det_words, words, counts, n_off, k, extended=extended, recover2=True)
    assert block_decode_mod.launches == before + 1
    want = block_decode_mod.decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended,
                                                    recover2=True)
    got = pipeline.to_host(got)
    assert_same_dict(pipeline.to_host(want), got)
    base = pipeline.to_host(block_decode_mod.decode_block_bits(det_words, words, counts, n_off, k, extended=extended))
    rec2 = got.pop("recovered2")
    # A pair repair changes its slot's frame; every slot it did not change
    # reads as without R2, and so does the whole dict where none did.
    same = np.all(got["frames"] == base["frames"], axis=1)
    assert not rec2[same].any()
    assert sorted(base) == sorted(got)
    for key, v in base.items():
        if v.ndim and v.shape[0] == k:
            np.testing.assert_array_equal(v[same], got[key][same], err_msg=key)
    if same.all():
        assert_same_dict(base, got)
    if case == "pair flips":
        assert rec2.sum() > 0 and not same.all()


@pytest.mark.parametrize("k", [0, 64, 100_000])
def test_block_decode_r2_on_random_bits(cuda_device, k):  # noqa: F811
    """Random frames at random offsets: many deltas, a few in the pair table."""
    rng = np.random.default_rng(k + 1)
    n_off = (1 << 20) + 77
    det = torch.as_tensor(rng.random(n_off) < 0.3).to(cuda_device)
    det_words = pack_msb_words(det, magdet_mod.n_det_words(n_off))
    counts = magdet_mod.tile_counts(det)
    words = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, n_off // 32 + 16, dtype=np.int32)).to(cuda_device)
    for extended in (False, True):
        got = block_decode_mod.decode_block_bits(det_words, words, counts, n_off, k, extended=extended, recover2=True)
        want = block_decode_mod.decode_block_bits_plain(det_words, words, counts, n_off, k, extended=extended,
                                                        recover2=True)
        assert_same_dict(pipeline.to_host(want), pipeline.to_host(got))


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("k", [0, 1, 777, 21_504])
def test_fields_kernel_matches_plain(cuda_device, extended, k):  # noqa: F811
    """Random 14-byte rows that take every byte value in every column."""
    from airjax_torch.kernels import fields as fields_mod

    rng = np.random.default_rng(k)
    rows = rng.integers(0, 256, (k, 14), dtype=np.uint8)
    rows[: min(k, 256)] = np.arange(min(k, 256), dtype=np.uint8)[:, None]
    frames = torch.as_tensor(rows).to(cuda_device)
    raw = torch.as_tensor(rows[::-1].copy()).to(cuda_device) if extended else None
    before = fields_mod.launches
    got = fields_mod.block_fields(frames, raw)
    assert fields_mod.launches == before + (k > 0)
    want = fields_mod.block_fields_plain(frames, raw)
    assert_same_dict(pipeline.to_host(want[0]), pipeline.to_host(got[0]))
    if extended:
        assert_same_dict(pipeline.to_host(want[1]), pipeline.to_host(got[1]))
    else:
        assert got[1] is None


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_with_fields_path_matches_plain(cuda_device, extended, recover2):  # noqa: F811
    """decode_iq_block(_extended)_with_fields on the card: two launches (the
    front, the block decode with F; the fields kernel none), the whole
    dict equal to the CPU's."""
    from airjax_torch.kernels import fields as fields_mod

    n = (1 << 17) + 1024
    iq = _pair_flips(n, 30, extended)
    fn = pipeline.decode_iq_block_extended_with_fields if extended else pipeline.decode_iq_block_with_fields
    k = 1 << 14 if extended else 1024
    before = _counts() + (fields_mod.launches,)
    got = pipeline.to_host(fn(torch.as_tensor(iq).to(cuda_device), n - 240, k, recover2))
    after = _counts() + (fields_mod.launches,)
    assert after == (before[0] + 1, before[1] + 1) + before[2:]
    want = pipeline.to_host(fn(torch.as_tensor(iq), n - 240, k, recover2))
    _same_with_fields(want, got)


def _same_with_fields(want: dict, got: dict) -> None:
    want, got = dict(want), dict(got)
    for key in ("fields", "short_fields"):
        assert (key in want) == (key in got), key
        if key in want:
            assert_same_dict(want.pop(key), got.pop(key))
    assert_same_dict(want, got)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("case", R2_CASES)
def test_block_decode_fields_matches_plain_and_chain(cuda_device, case, extended, recover2):  # noqa: F811
    """The F instantiations (with and without R2) against their plain
    version, and against the chain they replace: the block decode without
    F, then the fields kernel; one launch each."""
    from airjax_torch.kernels import fields as fields_mod

    n = (1 << 17) + 1024
    if case == "pair flips":
        iq, n_off, k = _pair_flips(n, 31, extended), n - 240, 1 << 14
    else:
        iq, n_off, k = _block_case(case, n)
    iq = torch.as_tensor(iq).to(cuda_device)
    det_words, words, counts = magdet_mod.magdet_bits(iq, n_off, "preamble" if extended else "df17")
    args = (det_words, words, counts, n_off, k)
    before = (block_decode_mod.launches, fields_mod.launches)
    got = block_decode_mod.decode_block_bits(*args, extended=extended, recover2=recover2, fields=True)
    assert (block_decode_mod.launches, fields_mod.launches) == (before[0] + 1, before[1])
    got = pipeline.to_host(got)
    want = block_decode_mod.decode_block_bits_plain(*args, extended=extended, recover2=recover2, fields=True)
    _same_with_fields(pipeline.to_host(want), got)
    chain = block_decode_mod.decode_block_bits(*args, extended=extended, recover2=recover2)
    chain["fields"], short = fields_mod.block_fields(chain["frames"], chain["frames_raw"] if extended else None)
    if extended:
        chain["short_fields"] = short
    _same_with_fields(pipeline.to_host(chain), got)


def _gather_shards(d: int, k: int, block: int, seed: int, extended: bool, device) -> list[dict]:
    """D random shard dicts as the block decode lays them out (the six
    classes one (6, K) block), on `device`."""
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(d):
        valid = rng.random(k) < 0.8
        s = {"offsets": np.where(valid, np.sort(rng.integers(0, block, k)), 0).astype(np.int32), "valid": valid,
             "frames": rng.integers(0, 256, (k, 14), np.uint8), "n_detections": np.int32(rng.integers(0, 2 * k + 1)),
             "overflow": np.bool_(rng.random() < 0.1), "recovered2": rng.random(k) < 0.3}
        if extended:
            s.update(frames_raw=rng.integers(0, 256, (k, 14), np.uint8), df=rng.integers(0, 25, k).astype(np.int32),
                     icao_ap_short=rng.integers(0, 1 << 24, k).astype(np.int32),
                     icao_ap_long=rng.integers(0, 1 << 24, k).astype(np.int32))
        else:
            s.update(good=valid & (rng.random(k) < 0.6), recovered=rng.random(k) < 0.3)
        t = {key: torch.as_tensor(v).to(device) for key, v in s.items()}
        if extended:
            classes = torch.as_tensor(rng.random((6, k)) < 0.25).to(device)
            t.update(zip(shard_gather_mod.MASK_KEYS, classes.unbind(0)))
        shards.append(t)
    return shards


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("d", [1, 3, 4, 32])
def test_shard_gather_kernel_matches_plain(cuda_device, d, extended, recover2):  # noqa: F811
    """The shard-gather kernel against its plain version: C below, near and
    above the total, K from 0 to past a block scan's 512 rows; one launch."""
    for k, block in ((0, 600), (37, 600), (1500, 1 << 16)):
        shards = _gather_shards(d, k, block, seed=d + 7 * k, extended=extended, device=cuda_device)
        max_offset = d * block - 240 - 19
        for c in (0, 5, d * k // 2, d * k + 9):
            before = shard_gather_mod.launches
            got = shard_gather_mod.shard_gather(shards, block, max_offset, c, extended=extended, recover2=recover2)
            assert shard_gather_mod.launches == before + 1
            want = shard_gather_mod.shard_gather_plain(shards, block, max_offset, c, extended=extended,
                                                      recover2=recover2)
            torch.cuda.synchronize()
            assert_same_dict(pipeline.to_host(want), pipeline.to_host(got))


def test_shard_gather_kernel_raises(cuda_device):  # noqa: F811
    shards = _gather_shards(33, 8, 600, 0, False, cuda_device)
    with pytest.raises(ValueError, match="at most 32 shards"):
        shard_gather_mod.shard_gather(shards, 600, 1000, 16)
    ext = _gather_shards(2, 8, 600, 0, True, cuda_device)
    ext[1]["good_df11"] = ext[1]["good_df11"].clone()  # not in the (6, K) block
    with pytest.raises(ValueError, match=r"\(6, K\) block"):
        shard_gather_mod.shard_gather(ext, 600, 1000, 16, extended=True)


@pytest.mark.parametrize("extended", [False, True])
def test_sharded_decode_on_card_matches_cpu(cuda_device, extended):  # noqa: F811
    """decode_capture_sharded(_extended) on 4 shards of the card (a front, a
    block decode a shard, one shard gather) == the same mesh on the CPU."""
    from airjax_torch.parallel import halo
    from airjax_torch.parallel.mesh import Mesh

    n = 4 * halo.tuned_block(1 << 18)
    iq, _ = _traffic(n, 3, spacing=2999)
    if extended:
        iq = _mixed(n, 3)
    decode = halo.decode_capture_sharded_extended if extended else halo.decode_capture_sharded
    before = (*_counts()[:2], shard_gather_mod.launches)
    got = decode(iq, Mesh([cuda_device] * 4), capacity_per_shard=4096)
    after = (*_counts()[:2], shard_gather_mod.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 4, 1)
    want = decode(iq, Mesh(["cpu"] * 4), capacity_per_shard=4096)
    if extended:
        assert [(o, repr(p)) for o, p in got[0]] == [(o, repr(p)) for o, p in want[0]] and got[0]
    else:
        assert got[0] == want[0] and got[0]
    assert got[1] == want[1]


def test_sharded_paths_on_card_match_cpu(cuda_device):  # noqa: F811
    """run_stream_sharded (batched, extended), the channels and the analyses
    on the card == on the CPU."""
    from airjax_torch import analytics
    from airjax_torch.parallel import channels
    from airjax_torch.parallel.mesh import Mesh, make_mesh
    from airjax_torch.runner import run_stream_sharded
    from airjax_torch.track.batch import ExtendedBatchTracker

    iq = _mixed(600_000, 4)
    summaries = []
    for mesh in (Mesh([cuda_device] * 2), Mesh(["cpu"] * 2)):
        tracker = ExtendedBatchTracker()
        stats = run_stream_sharded((iq[i : i + 20000] for i in range(0, len(iq), 20000)), tracker, mesh=mesh,
                                   extended=True, recover2=True).as_dict()
        summaries.append(({a: t.get_summary().to_json(extended=True) | {"lastContact": 0}
                           for a, t in tracker.aircrafts.items()}, {k: stats[k] for k in ("good", "detections")}))
    assert summaries[0] == summaries[1] and summaries[0][0]
    chans = np.stack([_traffic(40_000, s, spacing=3001)[0] for s in range(4)])
    assert channels.decode_channels(chans, make_mesh(1, cuda_device, axis="c")) == channels.decode_channels(
        chans, make_mesh(1, "cpu", axis="c"))
    for analyze in (analytics.analyze_capture, analytics.analyze_capture_extended):
        got, want = analyze(iq, devices=1, device=cuda_device), analyze(iq, devices=1, device="cpu")
        assert repr(got) == repr(want) and got[0]


@pytest.mark.parametrize("extended", [False, True])
def test_shard_gather_kernel_first_shard_matches_plain(cuda_device, extended):  # noqa: F811
    """A process's gather in a multi-process decode (first_shard > 0): the
    kernel against the plain version."""
    for d, first in ((1, 1), (3, 2), (4, 28)):
        shards = _gather_shards(d, 1500, 1 << 16, seed=d + first, extended=extended, device=cuda_device)
        max_offset = (first + d) * (1 << 16) - 240 - 19
        for c in (5, d * 1500 + 9):
            got = shard_gather_mod.shard_gather(shards, 1 << 16, max_offset, c, extended=extended, recover2=True,
                                                first_shard=first)
            want = shard_gather_mod.shard_gather_plain(shards, 1 << 16, max_offset, c, extended=extended,
                                                      recover2=True, first_shard=first)
            torch.cuda.synchronize()
            assert_same_dict(pipeline.to_host(want), pipeline.to_host(got))


def _same_gather(want: dict, got: dict) -> None:
    """Two gathered dicts (with_fields: their field dicts too), key by key."""
    want, got = pipeline.to_host(want), pipeline.to_host(got)
    for key in ("fields", "short_fields"):
        if key in want:
            assert_same_dict(want.pop(key), got.pop(key))
    assert_same_dict(want, got)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("d", [1, 4])
def test_shard_gather_fields_kernel_matches_plain(cuda_device, d, extended, recover2):  # noqa: F811
    """The gather's flag F against its plain version and against the gather
    then the fields kernel: C 0, below the total (an overflow), and above
    it (zero rows), K from 0 to past a tile; one launch, no fields.cu."""
    from airjax_torch.kernels import fields as fields_mod

    for k, block, first in ((0, 600, 0), (37, 600, 0), (2100, 1 << 16, 0), (1500, 1 << 16, 3)):
        shards = _gather_shards(d, k, block, seed=d + 11 * k, extended=extended, device=cuda_device)
        max_offset = (first + d) * block - 240 - 19
        for c in (0, 5, d * k // 2, d * k + 9):
            kw = dict(extended=extended, recover2=recover2, first_shard=first)
            before = (shard_gather_mod.launches, shard_gather_mod.fields_launches, fields_mod.launches)
            got = shard_gather_mod.shard_gather(shards, block, max_offset, c, with_fields=True, **kw)
            after = (shard_gather_mod.launches, shard_gather_mod.fields_launches, fields_mod.launches)
            assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
            want = shard_gather_mod.shard_gather_plain(shards, block, max_offset, c, with_fields=True, **kw)
            chain = shard_gather_mod.shard_gather(shards, block, max_offset, c, **kw)
            chain["fields"], short = fields_mod.block_fields(chain["frames"], chain["frames_raw"] if extended else None)
            if extended:
                chain["short_fields"] = short
            torch.cuda.synchronize()
            _same_gather(want, got)
            _same_gather(chain, got)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_sharded_batched_step_on_card(cuda_device, extended, recover2):  # noqa: F811
    """A with_fields step on 4 shards of the card: 4 fronts, 4 block decodes
    and one gather with F, no fields-kernel launch; its dict == the same
    step on 4 CPU shards."""
    from airjax_torch.kernels import fields as fields_mod
    from airjax_torch.parallel import halo
    from airjax_torch.parallel.mesh import Mesh

    block = halo.tuned_block(1 << 16)
    iq = _mixed(4 * block, 6) if extended else _traffic(4 * block, 6, spacing=2999)[0]
    build = halo.build_sharded_decoder_extended_compact if extended else halo.build_sharded_decoder_compact
    for c in (16, 1024):  # an overflow, then zero rows
        before = (*_counts()[:2], shard_gather_mod.launches, shard_gather_mod.fields_launches, fields_mod.launches)
        got = build(Mesh([cuda_device] * 4), 4 * block, 512, c, with_fields=True, recover2=recover2)(iq)
        after = (*_counts()[:2], shard_gather_mod.launches, shard_gather_mod.fields_launches, fields_mod.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (4, 4, 1, 1, 0)
        want = build(Mesh(["cpu"] * 4), 4 * block, 512, c, with_fields=True, recover2=recover2)(iq)
        _same_gather(want, got)


def _count_with_magdet(iq: torch.Tensor, chunk: int, n_chunks: int) -> int:
    """The chunked detection count from the first front's u8 mask
    (csrc/magdet.cu), padded, viewed by chunk and summed."""
    n_scan = n_chunks * chunk - 240
    det, _ = magdet_mod.magdet(iq[: n_chunks * chunk], n_scan)
    det = torch.nn.functional.pad(det, (0, n_chunks * chunk - n_scan))
    return int(det.view(n_chunks, chunk)[:, : chunk - 240].sum())


@pytest.mark.parametrize("kind", ["random", "small", "traffic"])
@pytest.mark.parametrize("chunk, n_chunks, extra", [(20000, 1, 5000), (20000, 7, 20000), (4096, 9, 13),
                                                    (250, 40, 7), (20000, 839, 1)])
def test_chunked_detection_count_kernel_matches_plain(cuda_device, kind, chunk, n_chunks, extra):  # noqa: F811
    """The front's count mode against its plain version and the first
    front's mask count, from an aligned base and from one 4 bytes past a
    16-byte boundary; one count launch, no other kernel of the wrappers."""
    n = n_chunks * chunk + extra
    iq = torch.as_tensor(_iq(n + 1, n, kind)).to(cuda_device)
    for x in (iq[:n], iq[1:]):
        before = (magdet_mod.count_launches, magdet_mod.bits_launches, magdet_mod.launches)
        got = magdet_mod.chunked_detection_count(x, chunk, n_chunks)
        after = (magdet_mod.count_launches, magdet_mod.bits_launches, magdet_mod.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 0)
        want = magdet_mod.chunked_detection_count_plain(x, chunk, n_chunks)
        assert got.dtype == torch.int32 and got.shape == () and got.device == x.device
        assert int(got) == int(want) == _count_with_magdet(x, chunk, n_chunks)


def test_fused_parity_decode_counts_with_the_count_mode(cuda_device):  # noqa: F811
    """decode_capture_parity(fused=True) on the card: no first-front launch,
    one count-mode launch; its stats == the CPU's."""
    iq = _mixed(11 * 20000 + 333, 8)
    before = (magdet_mod.count_launches, magdet_mod.launches)
    got = pipeline.decode_capture_parity(iq, device=cuda_device)
    assert (magdet_mod.count_launches - before[0], magdet_mod.launches - before[1]) == (1, 0)
    assert got == pipeline.decode_capture_parity(iq, device="cpu") and got[1]["n_detections"] > 0


def test_multihost_and_parity_on_card_match_cpu(cuda_device):  # noqa: F811
    """One process's multihost decodes on 4 shards of the card == on 4 CPU
    shards; the per-chunk parity decode on the card == the fused one ==
    the golden oracle."""
    from airjax_torch import golden
    from airjax_torch.config import PipelineConfig
    from airjax_torch.parallel import multihost
    from airjax_torch.parallel.mesh import Mesh

    iq = _mixed(4 * 65536, 5)
    for gather in ("compact", "dense"):
        got = multihost.decode_capture(iq, Mesh([cuda_device] * 4), gather=gather)
        assert got == multihost.decode_capture(iq, Mesh(["cpu"] * 4), gather=gather) and got[0]
        got = multihost.decode_capture_extended(iq, Mesh([cuda_device] * 4), now=1.0, gather=gather)
        want = multihost.decode_capture_extended(iq, Mesh(["cpu"] * 4), now=1.0, gather=gather)
        assert [(o, repr(p)) for o, p in got[0]] == [(o, repr(p)) for o, p in want[0]] and got[1] == want[1]
    cfg = PipelineConfig(block_len=20000)
    gold = golden.decode_capture_playback(iq)
    for fused in (True, False):
        hits, _ = pipeline.decode_capture_parity(iq, cfg, fused=fused, device=cuda_device)
        assert [(c, o, f) for c, o, f, _ in hits] == gold and gold


def _pipelined_stream(n_blocks: int = 8):
    """20,000-sample blocks, 7 DF17 frames a block (one across its end),
    and a ragged tail that completes the last one -> (blocks, frames)."""
    frames = [synth.make_df17(0xA00000 + i, synth.make_id_me(f"PIPE{i:04d}")) for i in range(3)]
    offsets = [b * 20000 + 300 + k * 2900 for b in range(n_blocks) for k in range(6)]
    offsets = sorted(offsets + [(b + 1) * 20000 - 120 for b in range(n_blocks)])
    n = n_blocks * 20000 + 7000
    iq = synth.modulate([frames[i % 3] for i in range(len(offsets))], offsets, n, noise_std=30.0, seed=14)
    return lambda: (iq[i : i + 20000] for i in range(0, n, 20000)), len(offsets)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_fetch_is_depth_invariant(cuda_device, depth):  # noqa: F811
    """pipeline.Fetcher's stream form (pinned uploads, a copy stream that
    waits on each block's event): run_stream and run_stream_sharded on the
    card give depth 0's packets and stats at every depth, each block fetched
    once, and the packets are the CPU's."""
    from airjax_torch import runner
    from airjax_torch.parallel.mesh import Mesh

    blocks, n_frames = _pipelined_stream()

    def run(device, d):
        got, got_sh = [], []
        st = runner.run_stream(blocks(), got.append, device=device, pipeline_depth=d)
        st_sh = runner.run_stream_sharded(blocks(), got_sh.append, mesh=Mesh([device] * 2), pipeline_depth=d)
        assert st.fetches == st.blocks
        stats = {k: v for k, v in st.as_dict().items() if k not in ("stages", "msamples_per_s")}
        return [p.packet for p in got], stats, [p.packet for p in got_sh], st_sh.good

    serial = run(cuda_device, 0)
    assert run(cuda_device, depth) == serial == run("cpu", depth)
    assert len(serial[0]) == serial[1]["good"] == n_frames


def test_fetcher_reuses_a_staging_buffer_after_its_event(cuda_device):  # noqa: F811
    f = pipeline.Fetcher(cuda_device)
    a = np.ones((1000, 2), np.int16)
    staged = f.stage(a)
    assert staged.is_pinned()
    total = f.upload(staged).sum(dtype=torch.int64)
    ticket = f.launched(staged)
    out = f.fetch({"x": total}, ticket)
    f.done(ticket)
    assert int(out["x"]) == 2000 and f.stage(a[:500]).data_ptr() == staged.data_ptr()


def test_airjax_names_on_card_equal_cpu(cuda_device):  # noqa: F811
    """The u32 magnitudes, slice_bits (offsets past the end and negative
    ones too), pack_cmp_words_reduce and pipeline.compact_mask: torch ops on
    the card, equal to their CPU results."""
    from airjax_torch.dsp import demod, magnitude

    iq = torch.as_tensor(_random_iq(100_001, 17))
    rng = np.random.default_rng(17)
    offsets = torch.as_tensor(np.concatenate([rng.integers(0, 100_001 - 240, 500), [100_000, -1, -40, 0]]))
    mags = magnitude_u16(iq)
    for name, fn, args in (
        ("squared_magnitude_u32", magnitude.squared_magnitude_u32, (iq,)),
        ("isqrt_u32", magnitude.isqrt_u32, (magnitude.squared_magnitude_u32(iq),)),
        ("magnitude_u32", magnitude.magnitude_u32, (iq,)),
        ("slice_bits", demod.slice_bits, (mags, offsets)),
        ("pack_cmp_words_reduce", demod.pack_cmp_words_reduce, (mags,)),
        ("compact_mask", pipeline.compact_mask, (torch.as_tensor(rng.random(50_000) < 0.05), 1024)),
    ):
        want = fn(*args)
        got = fn(*(a.to(cuda_device) if torch.is_tensor(a) else a for a in args))
        for w, g in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
            assert g.device.type == "cuda" and g.dtype == w.dtype, name
            assert torch.equal(g.cpu(), w), name


def test_decode_iq_block_kernel_is_decode_iq_block(cuda_device):  # noqa: F811
    """airjax's name for the decode on the front: the same dict as
    decode_iq_block, through the same two launches (front, block decode)."""
    n = (1 << 20) + 1024
    iq_dev = torch.as_tensor(_traffic(n, 18)[0]).to(cuda_device)
    n_off = (1 << 20) - 240
    before = _counts()
    got = pipeline.to_host(pipeline.decode_iq_block_kernel(iq_dev, n_off, 512))
    assert _counts() == tuple(c + 1 for c in before[:2]) + before[2:]
    assert_same_dict(pipeline.to_host(pipeline.decode_iq_block(iq_dev, n_off, 512)), got)
    assert int(got["n_good"]) > 0


@pytest.mark.parametrize("offsets", [[0, 300, 300, 300, 300, 5000, 5001], [19_760, 25_000, -1, -300, 777]])
def test_modulate_device_on_card_equals_cpu_without_noise(cuda_device, offsets):  # noqa: F811
    frames = [synth.make_df17(0x500000 + i, synth.make_id_me(f"MD{i}")) for i in range(len(offsets))]
    got = synth.modulate_device(frames, offsets, 20_000, noise_std=0.0, device=cuda_device)
    assert got.device.type == "cuda" and got.dtype == torch.int16
    assert torch.equal(got.cpu(), synth.modulate_device(frames, offsets, 20_000, noise_std=0.0, device="cpu"))
    noisy = synth.modulate_device(frames, offsets, 20_000, seed=9, device=cuda_device)
    assert torch.equal(noisy, synth.modulate_device(frames, offsets, 20_000, seed=9, device=cuda_device))
