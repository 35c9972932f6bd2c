"""airjax_torch.pipeline against airjax.pipeline: whole block dicts, the
adaptive regrow, and the overlap and parity capture decodes (and the
parity hits against the golden scalar decoder)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from airjax import golden
from airjax import pipeline as jp
from airjax.config import DEFAULT_CONFIG
from airjax_torch import config as tconfig
from airjax.kernels.magdet import EXTRA, TILE, pad_for_kernel
from airjax_torch import pipeline as tp
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.kernels import block_decode as block_decode_mod
from airjax_torch.kernels import magdet as magdet_mod
from airjax_torch.io import synth
from torch_parity import assert_same_dict


def _traffic(n: int, offsets, seed: int, flips: dict | None = None, noise: float = 50.0):
    frames = []
    for i, _ in enumerate(offsets):
        if i % 2:
            me = synth.make_position_me(11, 10000 + 25 * i, (i * 7919) % (1 << 17), (i * 104729) % (1 << 17), bool(i % 4 == 1))
        else:
            me = synth.make_id_me(f"PIPE{i:03d}")
        f = synth.make_df17(0x7C6B30 + i, me)
        if flips and i in flips:
            f = synth.flip_bit(f, flips[i])
        frames.append(f)
    return synth.modulate(frames, list(offsets), n, noise_std=noise, seed=seed), frames


def test_decode_iq_block_equals_airjax_and_pallas_path():
    n = TILE + EXTRA
    offsets = [0, 1000, 9000, 20000, 40000, 60000, TILE - 240 - 1]
    iq, _ = _traffic(n, offsets, 7, flips={1: 10, 2: 95, 3: 87})
    n_off = TILE - 240
    want = jax.device_get(jp.decode_iq_block(jnp.asarray(iq), n_off, 64))
    want_k = jax.device_get(jp.decode_iq_block_kernel(jnp.asarray(iq), n_off, 64, interpret=True))
    got = tp.to_host(tp.decode_iq_block(torch.as_tensor(iq), n_off, 64))
    assert_same_dict(want, got)
    assert_same_dict(want_k, got)
    assert int(got["n_good"]) == 6 and int(got["recovered"].sum()) == 2
    plain = tp.to_host(tp.decode_mags_block(magnitude_u16(torch.as_tensor(iq)), n_off, 64))
    assert_same_dict(want, plain)


def test_decode_iq_block_kernel_equals_airjax_on_a_padded_block(monkeypatch):
    """airjax's kernel-padded input (pad_for_kernel of a TILE-sample
    capture) through the port's decode_iq_block_kernel == airjax's
    (Pallas, interpret mode) == the port's decode_iq_block: the same two
    wrappers, each once."""
    offsets = [0, 1000, 9000, 20000, 40000, 60000, TILE - 241]
    iq, _ = _traffic(TILE, offsets, 8, flips={2: 30, 4: 99})
    padded, n_dom = pad_for_kernel(jnp.asarray(iq))
    assert padded.shape == (TILE + EXTRA, 2) and n_dom == TILE
    n_off = TILE - 240
    want = jax.device_get(jp.decode_iq_block_kernel(padded, n_off, 64, interpret=True))
    block = torch.as_tensor(np.array(padded))
    front, decode = magdet_mod.bits_launches, block_decode_mod.launches
    calls = []
    real_bits, real_decode = tp.magdet_bits, tp.decode_block_bits
    monkeypatch.setattr(tp, "magdet_bits", lambda *a, **kw: calls.append("front") or real_bits(*a, **kw))
    monkeypatch.setattr(tp, "decode_block_bits",
                        lambda *a, **kw: calls.append("block decode") or real_decode(*a, **kw))
    got = tp.to_host(tp.decode_iq_block_kernel(block, n_off, 64))
    monkeypatch.undo()
    assert calls == ["front", "block decode"]
    assert (magdet_mod.bits_launches, block_decode_mod.launches) == (front, decode)  # the CPU launches nothing
    assert_same_dict(want, got)
    assert_same_dict(tp.to_host(tp.decode_iq_block(block, n_off, 64)), got)
    assert int(got["n_good"]) == 6 and int(got["recovered"].sum()) == 1


@pytest.mark.parametrize("density", [0.02, 0.3])
def test_compact_mask_equals_airjax(density):
    """(indices, n_true), airjax's pair; at 0.3 past the capacity."""
    det = np.random.default_rng(int(density * 100)).random(5000) < density
    want = jp.compact_mask(jnp.asarray(det), 512)
    got = tp.compact_mask(torch.as_tensor(det), 512)
    assert len(got) == 2
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(w, g.numpy())
    assert (int(got[1]) > 512) == (density == 0.3)


def test_decode_mags_block_r2_equals_airjax():
    """Frames with 2-bit flips in bits 5-87 (the DF17 gate holds), one
    with a 1-bit flip and clean ones: airjax's dict, `recovered2` too."""
    rng = np.random.default_rng(12)
    offsets = [100 + 700 * i for i in range(8)]
    frames = []
    for i in range(len(offsets)):
        f = synth.make_df17(0x7C1000 + i, synth.make_id_me(f"RTWO{i}"))
        for b in (rng.choice(np.arange(5, 88), 2, replace=False) if i % 2 else ([] if i != 2 else [40])):
            f = synth.flip_bit(f, int(b))
        frames.append(f)
    iq = synth.modulate(frames, offsets, 6000, seed=12)
    n_off = 6000 - 240
    want = jax.device_get(jp.decode_mags_block_r2(jp.magnitude_u16(jnp.asarray(iq)), n_off, 32))
    got = tp.to_host(tp.decode_mags_block_r2(magnitude_u16(torch.as_tensor(iq)), n_off, 32))
    assert_same_dict(want, got)
    assert int(got["recovered2"].sum()) >= 3 and int(got["n_good"]) == 8
    assert_same_dict(tp.to_host(tp.decode_iq_block_r2(torch.as_tensor(iq), n_off, 32)), got)


@pytest.mark.parametrize("amplitude", [2, 300])
def test_decode_iq_block_noise_equals_airjax(amplitude):
    # Small amplitudes tie often, and ties pass the gate: many detections,
    # past capacity (overflow) at amplitude 2.
    rng = np.random.default_rng(amplitude)
    iq = rng.integers(-amplitude, amplitude + 1, size=(20000, 2), dtype=np.int16)
    want = jax.device_get(jp.decode_iq_block(jnp.asarray(iq), 20000 - 240, 256))
    got = tp.to_host(tp.decode_iq_block(torch.as_tensor(iq), 20000 - 240, 256))
    assert_same_dict(want, got)
    if amplitude == 2:
        assert bool(got["overflow"])


def test_adaptive_regrow_equals_airjax():
    # Constant magnitudes detect at every offset: capacity must regrow.
    iq = np.zeros((3000, 2), np.int16)
    iq[:, 0] = 100
    n_off = 3000 - 240
    want = jp.decode_iq_block_adaptive(iq, n_off, 16)
    got = tp.decode_iq_block_adaptive(iq, n_off, 16, device="cpu")
    assert_same_dict(want, got)
    assert int(got["n_detections"]) == n_off and not bool(got["overflow"])
    assert got["offsets"].shape[0] == n_off  # 16 -> 64 -> 256 -> 1024 -> n_off


def test_decode_block_rejects_short_input():
    iq = torch.zeros((1000, 2), dtype=torch.int16)
    with pytest.raises(ValueError):
        tp.decode_iq_block(iq, 1000 - 238, 16)


def test_pad_and_chunk_helpers_equal_airjax():
    iq = np.random.default_rng(2).integers(-5, 5, (777, 2), dtype=np.int16)
    np.testing.assert_array_equal(tp.pad_iq_non_detecting(iq, 2000), jp.pad_iq_non_detecting(iq, 2000))
    for n in (0, 19999, 20000, 20001, 40000, 123457):
        assert tp.reference_chunk_count(n) == jp.reference_chunk_count(n)


def test_decode_capture_overlap_equals_airjax():
    cfg = dataclasses.replace(DEFAULT_CONFIG, block_len=8192, max_candidates=8)
    tcfg = tconfig.PipelineConfig(block_len=8192, max_candidates=8)
    n = 50000
    scan = 8192 - 1264
    # Frames straddling every block edge, plus a cluster that overflows.
    offsets = [scan * b - 100 for b in range(1, 7)] + [30000 + 300 * k for k in range(12)]
    iq, frames = _traffic(n, sorted(offsets), 3, flips={4: 20})
    want_hits, want_stats = jp.decode_capture_overlap(iq, cfg)
    got_hits, got_stats = tp.decode_capture_overlap(iq, tcfg, device="cpu")
    assert got_hits == want_hits
    assert got_stats == want_stats
    assert len(got_hits) == len(offsets)


def test_decode_capture_parity_equals_airjax_and_golden():
    n = 5 * 20000 + 1234
    offsets = [500, 19700, 19900, 39990, 52000, 79800, 85000, 99000]
    iq, _ = _traffic(n, offsets, 11, flips={2: 7})
    want_hits, want_stats = jp.decode_capture_parity(iq)
    got_hits, got_stats = tp.decode_capture_parity(iq, device="cpu")
    assert got_hits == want_hits
    assert got_stats == want_stats
    gold = golden.decode_capture_playback(iq)
    assert [(c, o, f) for c, o, f, _ in got_hits] == gold
    assert 0 < len(got_hits) < len(offsets)  # chunk-edge frames are lost


def test_config_defaults_equal_airjax():
    for field in dataclasses.fields(tconfig.PipelineConfig):
        assert getattr(tconfig.DEFAULT_CONFIG, field.name) == getattr(DEFAULT_CONFIG, field.name)
