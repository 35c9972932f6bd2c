"""The port's extended decode (every Mode S downlink format) against airjax:
the front kernel's preamble gate, the short-frame CRC and makers, the
block dict of decode_mags_block_extended / decode_iq_block_extended
against airjax's decode_iq_block_extended, the host assembly, and
run_stream(extended=True) and the CLI in overlap and parity modes. On the
CPU the kernel wrappers run their plain versions; the kernels are held
against those on the card (tests/test_torch_cuda.py). Inputs are made
with numpy from a seed; the tolerance is exact equality everywhere, with
only the wall-clock `Processed Time` line and `time` key masked where two
runs print their own clocks."""

import contextlib
import dataclasses
import enum
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax import runner as jrunner
from airjax.dsp.demod import detect_preamble_only as jax_detect_preamble_only
from airjax.dsp.demod import pack_cmp_words as jax_pack_cmp_words
from airjax.dsp.magnitude import magnitude_u16 as jax_magnitude_u16
from airjax.extended import assemble_extended as jax_assemble_extended
from airjax.io import source as jsource
from airjax.pipeline import decode_iq_block_extended as jax_decode_iq_block_extended
from airjax.protocol import shortframe as jshort
from airjax.track.icao_cache import IcaoCache as JaxIcaoCache
from airjax.ui import stream as jstream
from airjax_torch import cli, pipeline
from airjax_torch import runner as trunner
from airjax_torch.dsp.demod import detect_preamble_only
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.extended import assemble_extended
from airjax_torch.io import c16 as tc16
from airjax_torch.io import synth
from airjax_torch.kernels.magdet import magdet
from airjax_torch.protocol import crc
from airjax_torch.protocol import shortframe as tshort
from airjax_torch.track.icao_cache import IcaoCache
from torch_parity import assert_same, assert_same_dict

STAT_KEYS = ("blocks", "samples", "detections", "good", "recovered", "overflow_blocks")


def _capture(n_aircraft: int, seed: int, spacing: int = 300, tail: int = 2000) -> tuple[np.ndarray, list[bytes]]:
    """Every downlink format (synth.make_mixed_frames), then AP frames of
    address 0, a DF17 with a data-bit flip (repaired), one with a CRC-field
    flip, a DF20 and a DF11 with a flip -> (iq, frames as sent)."""
    frames = synth.make_mixed_frames(n_aircraft, seed)
    frames += [
        tshort.make_df4(0, 5000),
        tshort.make_df20(0, 5000),
        synth.flip_bit(frames[0], 40),
        synth.flip_bit(frames[0], 100),
        synth.flip_bit(frames[7], 60),
        synth.flip_bit(frames[1], 20),
    ]
    offsets = [300 + spacing * i for i in range(len(frames))]
    return synth.modulate(frames, offsets, offsets[-1] + tail, seed=seed), frames


def _mask(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith("Processed Time  : ")]


def _fields(packet) -> tuple:
    """A packet's class name and dataclass fields, enums by name."""
    def factory(items):
        return {k: (v.name if isinstance(v, enum.Enum) else v) for k, v in items}

    return type(packet).__name__, dataclasses.asdict(packet, dict_factory=factory)


def test_short_tables_and_crc_equal_airjax():
    matrix, syn = tshort._short_tables()
    np.testing.assert_array_equal(matrix, jshort._short_tables()[0])
    np.testing.assert_array_equal(syn, jshort._short_tables()[1])
    # The candidate kernel reads the short syndromes off the long table.
    np.testing.assert_array_equal(syn, crc._tables()[1][56:])
    bits = np.random.default_rng(0).integers(0, 2, (500, 32), dtype=np.uint8)
    assert_same(jshort.crc24_short_batch(jnp.asarray(bits)), tshort.crc24_short_batch(torch.as_tensor(bits)))


def test_frame_makers_equal_airjax():
    from airjax.protocol import acas as jacas
    from airjax_torch.protocol import acas as tacas

    mv = tacas.make_mv_ra(ara=0b01000000000001, rac=3, rat=1, mte=1, tti=1, tid=0x4840D6)
    assert mv == jacas.make_mv_ra(ara=0b01000000000001, rac=3, rat=1, mte=1, tti=1, tid=0x4840D6)
    for gillham in (False, True):
        for alt in (-1000, 0, 12000, 36100):
            assert tshort.make_df0(0xABCDEF, alt, vs=1, gillham=gillham) == jshort.make_df0(0xABCDEF, alt, vs=1, gillham=gillham)
            assert tshort.make_df4(0xABCDEF, alt, fs=3, gillham=gillham) == jshort.make_df4(0xABCDEF, alt, fs=3, gillham=gillham)
            assert tshort.make_df16(0x1, alt, mv=mv, gillham=gillham) == jshort.make_df16(0x1, alt, mv=mv, gillham=gillham)
            assert tshort.make_df20(0x2, alt, mb=mv, gillham=gillham) == jshort.make_df20(0x2, alt, mb=mv, gillham=gillham)
    for squawk in (0, 1200, 7700, 7777):
        assert tshort.make_df5(0x3, squawk, fs=1) == jshort.make_df5(0x3, squawk, fs=1)
        assert tshort.make_df21(0x3, squawk, mb=mv) == jshort.make_df21(0x3, squawk, mb=mv)
    assert tshort.make_df11(0x4, 6, 17) == jshort.make_df11(0x4, 6, 17)
    assert tshort.make_df24(0x5, 9, bytes(range(10)), 1) == jshort.make_df24(0x5, 9, bytes(range(10)), 1)
    with pytest.raises(ValueError):
        tshort.make_df24(0x5, 16)


@pytest.mark.parametrize("packed", [True, False])
def test_preamble_gate_equals_airjax(packed):
    iq, _ = _capture(2, 1)
    n_off = len(iq) - 240
    mags = jax_magnitude_u16(jnp.asarray(iq))
    det_x = np.asarray(jax_detect_preamble_only(mags, n_off)).astype(np.uint8)
    det, out = magdet(torch.as_tensor(iq), n_off, packed=packed, gate="preamble")
    assert_same(det_x, det)
    assert_same(det_x.astype(bool), detect_preamble_only(magnitude_u16(torch.as_tensor(iq)), n_off))
    if packed:
        assert_same(np.asarray(jax_pack_cmp_words(mags)), out)
    with pytest.raises(ValueError):
        magdet(torch.as_tensor(iq), n_off, gate="df11")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [8, 256])
def test_block_dict_equals_airjax(seed, capacity):
    """Whole dict, dtypes included (the AP residuals are uint32 in airjax,
    int32 here); capacity 8 overflows."""
    iq, _ = _capture(3, seed)
    n_off = len(iq) - 240
    want = jax.device_get(jax_decode_iq_block_extended(jnp.asarray(iq), n_off, capacity))
    got = pipeline.decode_iq_block_extended(torch.as_tensor(iq), n_off, capacity)
    assert_same_dict(want, got)
    assert_same_dict(want, pipeline.decode_mags_block_extended(magnitude_u16(torch.as_tensor(iq)), n_off, capacity))
    assert bool(got["overflow"]) == (capacity == 8)


def test_every_class_is_reached():
    iq, frames = _capture(3, 4)
    n_off = len(iq) - 240
    out = pipeline.to_host(pipeline.decode_iq_block_extended(torch.as_tensor(iq), n_off, 512))
    at = {int(o): k for k, o in enumerate(out["offsets"]) if out["valid"][k]}
    for i, frame in enumerate(frames[:30]):
        k = at[300 + 300 * i]
        df = frame[0] >> 3
        if df == 17:
            assert out["good_long"][k] and out["frames"][k].tobytes() == frame
        elif df == 11:
            interrogator = crc.crc24(frame[:4]) ^ int.from_bytes(frame[4:7], "big")
            assert (out["good_df11"][k], out["cand_df11_ic"][k]) == (interrogator == 0, interrogator != 0)
        elif df in (0, 4, 5):
            assert out["cand_short_ap"][k] and out["frames_raw"][k].tobytes()[:7] == frame
        else:
            assert out["cand_long_ap"][k] and out["frames_raw"][k].tobytes() == frame
    k0 = at[300 + 300 * 30]  # DF4 of address 0: no candidate
    assert not (out["cand_short_ap"][k0] or out["good_df11"][k0])
    k_rep = at[300 + 300 * 32]
    assert out["recovered"][k_rep] and out["frames"][k_rep].tobytes() == frames[0]
    assert not out["good_long"][at[300 + 300 * 33]]  # a CRC-field flip never validates


@pytest.mark.parametrize("seed", [0, 3])
def test_assemble_extended_equals_airjax(seed):
    iq, _ = _capture(4, seed)
    n_off = len(iq) - 240
    out_j = jax.device_get(jax_decode_iq_block_extended(jnp.asarray(iq), n_off, 512))
    out_t = pipeline.to_host(pipeline.decode_iq_block_extended(torch.as_tensor(iq), n_off, 512))
    now = 1_700_000_000.5
    cache_j, cache_t = JaxIcaoCache(), IcaoCache()
    want = jax_assemble_extended(out_j, now, cache_j)
    got = assemble_extended(out_t, now, cache_t)
    assert [(o, _fields(p)) for o, p in got] == [(o, _fields(p)) for o, p in want]
    assert [p.format() for _, p in got] == [p.format() for _, p in want]
    assert len(cache_t) == len(cache_j) == 4
    kinds = {type(p).__name__ for _, p in got}
    assert kinds == {"AdsbPacket", "AllCallReply", "AcasReply", "SurveillanceReply", "CommDReply"}
    # An unseeded cache rejects every AP candidate of a later block.
    assert not [p for _, p in assemble_extended({**out_t, "good_long": out_t["good_long"] & False,
                                                 "good_df11": out_t["good_df11"] & False},
                                                now, IcaoCache())]


def test_icao_cache_equals_airjax():
    t, j = IcaoCache(max_age_s=10.0), JaxIcaoCache(max_age_s=10.0)
    rng = np.random.default_rng(1)
    for step in range(400):
        icao, now = int(rng.integers(0, 300)), float(step)
        if rng.random() < 0.5:
            t.add(icao, now)
            j.add(icao, now)
        else:
            assert t.contains(icao, now) == j.contains(icao, now)
        assert len(t) == len(j)
    t.add_many([1, 2, 3], 500.0)
    j.add_many([1, 2, 3], 500.0)
    assert len(t) == len(j)


def _blocks(iq: np.ndarray, sizes):
    i, k = 0, 0
    while i < len(iq):
        yield iq[i : i + sizes[k % len(sizes)]]
        i += sizes[k % len(sizes)]
        k += 1


def _run_both(iq, sizes, overlap):
    got, want = [], []
    t_stats = trunner.run_stream(_blocks(iq, sizes), got.append, overlap=overlap, extended=True, device="cpu")
    j_stats = jrunner.run_stream(_blocks(iq, sizes), want.append, overlap=overlap, extended=True)
    return got, t_stats.as_dict(), want, j_stats.as_dict()


@pytest.mark.parametrize("overlap", [True, False])
def test_run_stream_extended_equals_airjax(overlap):
    # Spacing 811 puts frames across the 20000-sample chunk edges.
    iq, frames = _capture(8, 5, spacing=811)
    got, t_stats, want, j_stats = _run_both(iq, [20000], overlap)
    assert [_fields(p)[0] for p in got] == [_fields(p)[0] for p in want]
    assert [_mask(p.format()) for p in got] == [_mask(p.format()) for p in want]
    for key in STAT_KEYS:
        assert t_stats[key] == j_stats[key], key
    if overlap:
        # Every frame of the 8 aircraft and the repaired DF17; the flipped
        # DF20 and DF11 name no known address.
        assert len(got) == 80 + 1
        assert t_stats["recovered"] == 1
    else:
        assert len(got) < 80 + 1  # chunk-edge straddlers are lost


def test_run_stream_extended_short_reads_equal_airjax():
    iq, _ = _capture(1, 6)
    sizes = [100, 900, 37, 5000, 239, 1]
    got, t_stats, want, j_stats = _run_both(iq, sizes, True)
    assert [_mask(p.format()) for p in got] == [_mask(p.format()) for p in want]
    assert len(got) >= 10
    for key in STAT_KEYS:
        assert t_stats[key] == j_stats[key], key


def test_cli_extended_and_jsonl_equal_airjax(tmp_path):
    iq, _ = _capture(3, 7, spacing=700, tail=20000)  # playback drops the last partial chunk
    path = tmp_path / "mixed.c16"
    tc16.save_c16(iq, path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["adsb", "-p", str(path), "--fast", "--extended", "--torch-device", "cpu",
                       "--jsonl", str(tmp_path / "t.jsonl")])
    assert rc == 0
    text = out.getvalue()
    stats_line = text.rindex("\nstats: ")
    want = io.StringIO()
    sink = jstream.tee(jstream.stream_printer(want), jstream.jsonl_writer(str(tmp_path / "j.jsonl")))
    jrunner.run_stream(iter(jsource.playback_blocks(str(path), realtime_factor=None)), sink, extended=True)
    assert _mask(text[:stats_line]) == _mask(want.getvalue())
    # 9 replies of each aircraft, its DF17 and the repaired DF17 once more.
    assert text.count("\n== DF") == 3 * 9 and text.count("\n== ") == 3 * 10 + 1

    def records(name):
        lines = (tmp_path / name).read_text().splitlines()
        return [{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in lines]

    assert records("t.jsonl") == records("j.jsonl") and len(records("t.jsonl")) == 31
