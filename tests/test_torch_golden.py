"""airjax_torch.golden (the scalar oracle) against airjax.golden, and the
port's parity decode against the port's golden: the cases of
tests/test_golden_parity.py (SNRs 20 to 3 dB, pure noise, magnitude
truncation ties, corrupted frames), each through decode_capture_parity
fused and per chunk (fused=False). Every output is bytes and integers,
so the tolerance is exact equality."""

import numpy as np
import pytest

from airjax import golden as jgolden
from airjax.protocol import crc as jcrc
from airjax_torch import golden
from airjax_torch.config import PipelineConfig
from airjax_torch.io import synth
from airjax_torch.pipeline import decode_capture_parity
from airjax_torch.protocol import crc, shortframe

CFG = PipelineConfig(block_len=4000)  # small blocks: a fast golden scan


def _run_both(iq):
    """(the port's fused hits, its per-chunk hits, the port's golden), each as (chunk, offset, frame)."""
    gold = golden.decode_capture_playback(iq, chunk=CFG.block_len)
    assert gold == jgolden.decode_capture_playback(iq, chunk=CFG.block_len)
    fused, fused_stats = decode_capture_parity(iq, CFG, device="cpu")
    chunks, chunk_stats = decode_capture_parity(iq, CFG, fused=False, device="cpu")
    assert fused_stats == chunk_stats
    return [(c, o, f) for c, o, f, _ in fused], [(c, o, f) for c, o, f, _ in chunks], gold


@pytest.mark.parametrize("snr_db", [20.0, 10.0, 6.0, 3.0])
def test_parity_vs_golden_snr(snr_db):
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("PARITY"))
    offsets = [200, 1200, 2600, 4500, 6100, 7900]
    iq = synth.modulate([frame] * len(offsets), offsets, 12001, snr_db=snr_db, seed=int(snr_db))
    fused, chunks, gold = _run_both(iq)
    assert fused == chunks == gold


def test_parity_pure_noise():
    rng = np.random.default_rng(99)
    iq = np.clip(np.round(rng.normal(0, 200, (8001, 2))), -32768, 32767).astype(np.int16)
    fused, chunks, gold = _run_both(iq)
    assert fused == chunks == gold


def test_parity_low_amplitude_ties():
    rng = np.random.default_rng(7)  # tiny amplitudes: magnitude truncation ties at >= and >
    iq = rng.integers(-4, 5, size=(8001, 2)).astype(np.int16)
    fused, chunks, gold = _run_both(iq)
    assert fused == chunks == gold


def test_parity_corrupted_frames():
    frame = synth.make_df17(0x40621D, synth.make_id_me("RECOVER"))
    bad1 = synth.flip_bit(frame, 17)
    bad2 = synth.flip_bit(frame, 100)  # a flip in the CRC field: not repairable
    iq = synth.modulate([bad1, frame, bad2], [300, 1500, 2800], 8001, seed=3)
    fused, chunks, gold = _run_both(iq)
    assert fused == chunks == gold
    assert [f for _, o, f in fused if o == 300] == [frame]
    assert all(o != 2800 for _, o, _ in fused)


def test_scalar_repair_equals_airjax():
    rng = np.random.default_rng(5)
    frames = [synth.make_df17(int(rng.integers(0, 1 << 24)), synth.make_id_me("CRC%d" % i)) for i in range(6)]
    cases = [frames[0]] + [synth.flip_bit(f, int(b)) for f in frames for b in rng.integers(0, 112, 4)]
    cases += [bytes(rng.integers(0, 256, 14, dtype=np.uint8)) for _ in range(8)]
    for frame in cases:
        assert crc.try_crc_recovery_scalar(frame) == jcrc.try_crc_recovery_scalar(frame)
    assert crc.try_crc_recovery_scalar(synth.flip_bit(frames[1], 30)) == frames[1]


def test_golden_functions_equal_airjax():
    """Every function of the golden module on one noisy mixed capture."""
    frames = synth.make_mixed_frames(3, 4) + [synth.flip_bit(synth.make_df17(0x7C6B30, synth.make_id_me("G")), 9)]
    offsets = [250 * (i + 1) for i in range(len(frames))]
    iq = synth.modulate(frames, offsets, 250 * (len(frames) + 2), noise_std=60.0, seed=4)
    mags = golden.magnitude(iq)
    np.testing.assert_array_equal(mags, jgolden.magnitude(iq))
    assert mags.dtype == jgolden.magnitude(iq).dtype
    for o in range(len(mags) - 240):
        assert golden.check_for_adsb_packet(mags[o : o + 32]) == jgolden.check_for_adsb_packet(mags[o : o + 32])
    for o in offsets:
        assert golden.extract_packet(mags[o + 16 : o + 240]) == jgolden.extract_packet(mags[o + 16 : o + 240])
    assert golden.decode_chunk(iq) == jgolden.decode_chunk(iq)
    for recover2 in (False, True):
        got = golden.decode_chunk_extended(iq, recover2=recover2)
        assert got == jgolden.decode_chunk_extended(iq, recover2=recover2)
    kinds = {kind for _, kind, _, _ in golden.decode_chunk_extended(iq)}
    assert {"long", "df11", "short_ap", "long_ap"} <= kinds


def test_golden_extended_recover2():
    """A 2-bit flip: 'long2' with recover2, nothing without, as airjax's."""
    frame = synth.make_df17(0x40621D, synth.make_id_me("PAIR"))
    bad = synth.flip_bit(synth.flip_bit(frame, 20), 61)
    ap = shortframe.make_df4(0x40621D, 9000)
    iq = synth.modulate([bad, ap], [300, 1500], 3000, seed=6)
    for recover2 in (False, True):
        got = golden.decode_chunk_extended(iq, recover2=recover2)
        assert got == jgolden.decode_chunk_extended(iq, recover2=recover2)
        assert [(o, k, f) for o, k, f, _ in got if o == 300] == ([(300, "long2", frame)] if recover2 else [])
