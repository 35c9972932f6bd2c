"""airjax_torch.parallel.channels against airjax.parallel.channels on the
CPU: the cases of tests/test_channels.py and the extended channels case
of test_sharding_extended.py, airjax on its 8-device CPU mesh and the port
on 8 CPU shards (and on fewer shards holding several channels each); the
per-channel hits and packets equal airjax's, the tolerance 0."""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from airjax.io import synth
from airjax.parallel import channels as jchannels
from airjax.parallel.mesh import make_mesh as jmake_mesh
from airjax.protocol import shortframe
from airjax_torch import pipeline
from airjax_torch.config import PipelineConfig
from airjax_torch.parallel import channels
from airjax_torch.parallel.mesh import make_mesh
from airjax_torch.protocol.packet import AdsbPacket, AllCallReply
from airjax_torch.track.aircraft import handle_aircraft_update
from torch_parity import airjax_builders_cached, assert_same_dict


@pytest.fixture(scope="module", autouse=True)
def _airjax_steps_once():
    """Each airjax step shape jit-compiles once in this module."""
    with airjax_builders_cached():
        yield


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8, axis="c")


def _packets(per_channel) -> list:
    def factory(items):
        return {k: (v.name if isinstance(v, enum.Enum) else v) for k, v in items}

    return [[(o, type(p).__name__, dataclasses.asdict(p, dict_factory=factory)) for o, p in pkts]
            for pkts in per_channel]


@pytest.mark.parametrize("shards", [8, 2])
def test_eight_channels_match_single_device(jmesh, shards):
    n = 8000
    channels_iq, expected = [], []
    for ch in range(8):
        frame = synth.make_df17(0x7C0000 + ch, synth.make_id_me(f"CH{ch}FLT"))
        offs = [500 + 700 * ch, 5000]
        channels_iq.append(synth.modulate([frame] * 2, offs, n, seed=ch))
        expected.append((offs, frame))
    iq = np.stack(channels_iq)
    results = channels.decode_channels(iq, make_mesh(shards, "c", device="cpu"))
    assert results == jchannels.decode_channels(iq, jmesh)
    for ch, (offs, frame) in enumerate(expected):
        assert {(o, frame) for o in offs} <= {(h[1], h[2]) for h in results[ch]}
        single, _ = pipeline.decode_capture_overlap(iq[ch], PipelineConfig(block_len=n), device="cpu")
        assert [(h[1], h[2]) for h in results[ch]] == [(h[1], h[2]) for h in single]


def test_channels_regrow_on_overflow(jmesh):
    n = 8000
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("CHOVFL"))
    offs = [500, 2000, 3500, 5000, 6500]
    iq = np.stack([synth.modulate([frame] * len(offs), offs, n, seed=9)] + [synth.modulate([], [], n, seed=10)] * 7)
    results = channels.decode_channels(iq, make_mesh(8, "c", device="cpu"), capacity=1)
    assert results == jchannels.decode_channels(iq, jmesh, capacity=1)
    assert {h[1] for h in results[0] if h[2] == frame} >= set(offs)


def test_channels_extended_regrow_on_overflow(jmesh):
    n = 8000
    df11 = shortframe.make_df11(0x40621D)
    offs = [500, 2000, 3500, 5000]
    iq = np.stack([synth.modulate([df11] * len(offs), offs, n, seed=11)] + [synth.modulate([], [], n, seed=12)] * 7)
    results = channels.decode_channels_extended(iq, make_mesh(8, "c", device="cpu"), capacity=1, now=100.0)
    assert _packets(results) == _packets(jchannels.decode_channels_extended(iq, jmesh, capacity=1, now=100.0))
    by_off = dict(results[0])
    assert all(isinstance(by_off[o], AllCallReply) for o in offs)


def test_channel_cpr_position_decode(jmesh):
    n = 8000
    f_even = synth.make_df17(0x40621D, bytes.fromhex("58c382d690c8ac"))
    f_odd = synth.make_df17(0x40621D, bytes.fromhex("58c386435cc412"))
    iq = np.stack([synth.modulate([f_odd, f_even], [400, 3000], n, seed=42)] + [synth.modulate([], [], n, seed=43)] * 7)
    results = channels.decode_channels(iq, make_mesh(8, "c", device="cpu"))
    assert results == jchannels.decode_channels(iq, jmesh)
    aircrafts = {}
    for _, _, frame, _ in results[0]:
        handle_aircraft_update(AdsbPacket.from_bytes(frame), aircrafts)
    geo = aircrafts[0x40621D].geo_position
    assert abs(geo.latitude - 52.25720) < 0.0001 and geo.longitude == 3.91937255859375
    assert all(not results[ch] for ch in range(1, 8))


@pytest.mark.parametrize("shards", [8, 4])
def test_extended_channels(jmesh, shards):
    # Each channel its own ICAO cache: a DF11 + DF4 pair decodes, a lone DF4 stays gated.
    df11, df4 = shortframe.make_df11(0x7C6B30, capability=5), shortframe.make_df4(0x7C6B30, altitude_ft=12000)
    iq = np.stack([synth.modulate([df4], [900], 4000, seed=43) if c == 3 else
                   synth.modulate([df11, df4], [300, 1500], 4000, seed=40 + c) for c in range(8)])
    results = channels.decode_channels_extended(iq, make_mesh(shards, "c", device="cpu"), now=100.0)
    assert _packets(results) == _packets(jchannels.decode_channels_extended(iq, jmesh, now=100.0))
    for c, pkts in enumerate(results):
        kinds = {type(p).__name__ for _, p in pkts}
        assert kinds == set() if c == 3 else {"AllCallReply", "SurveillanceReply"} <= kinds


@pytest.mark.parametrize("extended", [False, True])
def test_channel_step_equals_airjax(jmesh, extended):
    """The steps' whole dicts, channel axis first, against airjax's."""
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("CHSTEP"))
    iq = np.stack([synth.modulate([frame], [300 + 100 * c], 3000, seed=c) for c in range(8)])
    jbuild = jchannels.build_channel_decoder_extended if extended else jchannels.build_channel_decoder
    tbuild = channels.build_channel_decoder_extended if extended else channels.build_channel_decoder
    want = jax.device_get(jbuild(jmesh, 8, 3000 - 239, 16)(jnp.asarray(iq)))
    assert_same_dict(want, pipeline.to_host(tbuild(make_mesh(8, "c", device="cpu"), 8, 3000 - 239, 16)(iq)))


def test_channels_raise_and_short_input():
    with pytest.raises(ValueError, match="not divisible"):
        channels.build_channel_decoder(make_mesh(3, "c", device="cpu"), 8, 1000, 16)
    with pytest.raises(KeyError):
        channels.build_channel_decoder(make_mesh(8, device="cpu"), 8, 1000, 16)  # a time axis, not a channel axis
    short = np.zeros((8, 239, 2), np.int16)
    assert channels.decode_channels(short, make_mesh(8, "c", device="cpu")) == [[]] * 8
    assert channels.decode_channels_extended(short, make_mesh(8, "c", device="cpu")) == [[]] * 8
