"""The port's parity decode, fused and per chunk (fused=False), against
each other and against airjax's two forms (tests/test_parity_stats.py):
hits and stats equal, key for key, on frames across chunk edges, pure
noise and a truncation-tie storm whose chunks overflow the candidate
capacity and are decoded again. Also decode_iq_chunks, the per-chunk
helpers and hits_to_packets against airjax's. The tolerance is 0."""

import numpy as np
import pytest
import torch

from airjax import pipeline as jpipeline
from airjax.config import PipelineConfig as JConfig
from airjax_torch import pipeline
from airjax_torch.config import PipelineConfig
from airjax_torch.io import synth
from torch_parity import assert_same_dict

CFG, JCFG = PipelineConfig(block_len=4000, max_candidates=128), JConfig(block_len=4000, max_candidates=128)


def _capture(kind: int) -> np.ndarray:
    rng = np.random.default_rng(kind)
    if kind == 0:  # frames at random offsets, chunk straddles included
        frame = synth.make_df17(0x7C6B30, synth.make_id_me("STAT"))
        offs = [500, 3900, 4100, 7990, 11000]
        return synth.modulate([frame] * len(offs), offs, 13000, snr_db=12, seed=kind)
    if kind == 1:  # pure noise
        return np.clip(np.round(rng.normal(0, 120, (9500, 2))), -32768, 32767).astype(np.int16)
    if kind == 2:
        return rng.integers(-3, 4, size=(8123, 2)).astype(np.int16)  # a truncation-tie storm
    # A storm of |IQ| <= 1 (thousands of detections a chunk) with frames in
    # it past the 128th detection: found only when the chunk is decoded again.
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("STORM"))
    signal = synth.modulate([frame, frame], [3000, 6500], 8123, noise_std=0.0, seed=kind)
    storm = rng.integers(-1, 2, size=(8123, 2))
    return np.clip(signal.astype(np.int64) + storm, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_fused_equals_per_chunk_equals_airjax(kind):
    iq = _capture(kind)
    fused = pipeline.decode_capture_parity(iq, CFG, device="cpu")
    chunks = pipeline.decode_capture_parity(iq, CFG, fused=False, device="cpu")
    assert fused[0] == chunks[0]
    assert fused[1]["n_detections"] == chunks[1]["n_detections"]
    # The per-chunk stats are the first pass's (airjax/pipeline.py:459, :609):
    # a chunk decoded again adds hits but not n_good, in both packages.
    assert fused[1]["n_good"] == chunks[1]["n_good"] + (2 if kind == 3 else 0)
    assert fused == jpipeline.decode_capture_parity(iq, JCFG, fused=True)
    assert chunks == jpipeline.decode_capture_parity(iq, JCFG, fused=False)
    if kind == 3:  # its chunks overflowed K = 128 and were decoded again
        frame = synth.make_df17(0x7C6B30, synth.make_id_me("STORM"))
        assert chunks[1]["overflow"] and chunks[1]["n_detections"] > 1000
        assert [(c, o) for c, o, f, _ in chunks[0] if f == frame] == [(0, 3000), (1, 2500)]


def test_decode_iq_chunks_and_collect_equal_airjax():
    iq = _capture(3)[: 2 * 4000]
    blocks = iq.reshape(2, 4000, 2)
    want = jpipeline.decode_iq_chunks(blocks, 4000 - 240, 128)
    got = pipeline.decode_iq_chunks(torch.as_tensor(blocks), 4000 - 240, 128)
    assert_same_dict({k: np.asarray(v) for k, v in want.items()}, got)
    host = pipeline.to_host(got)
    assert bool(host["overflow"].any())
    want = {k: np.asarray(v) for k, v in want.items()}
    assert pipeline._collect_stats(host) == jpipeline._collect_stats(want)
    to_global = lambda c, o: (c, c * 4000 + o)  # noqa: E731
    assert pipeline._collect_hits(host, to_global) == jpipeline._collect_hits(want, to_global)
    regrown = pipeline._collect_hits(host, to_global, blocks, 4000 - 240, 128, "cpu")
    assert regrown == jpipeline._collect_hits(want, to_global, blocks, 4000 - 240, 128)
    assert len(regrown) >= len(pipeline._collect_hits(host, to_global))


def test_hits_to_packets_equal_airjax():
    frames = [synth.make_df17(0x7C6B30, synth.make_id_me("HTP")), synth.make_df17(0x40621D, synth.make_id_me("P2"))]
    iq = synth.modulate(frames, [300, 5000], 12000, seed=2)
    hits, _ = pipeline.decode_capture_parity(iq, CFG, device="cpu")
    got = [(p.packet, p.icao, p.time_processed) for p in pipeline.hits_to_packets(hits, 12.5)]
    want = [(p.packet, p.icao, p.time_processed) for p in jpipeline.hits_to_packets(hits, 12.5)]
    assert got == want and [g[0] for g in got] == frames


def test_per_chunk_needs_a_chunk():
    assert pipeline.decode_capture_parity(np.zeros((3000, 2), np.int16), CFG, fused=False, device="cpu") == (
        [], {"n_detections": 0, "n_good": 0, "overflow": False})
    with pytest.raises(ValueError, match="iq_chunks"):
        pipeline.decode_iq_chunks(torch.zeros((0, 4000, 2), dtype=torch.int16), 3760, 128)
