"""The sky from a seed: the same seed gives the same capture and frames,
another seed another; the frames are what their kinds say."""

from __future__ import annotations

import json

import numpy as np

from adsbench.tests.conftest import REPO
from adsbench.yardstick import traffic as T

SKY = dict(json.loads((REPO / "adsbench" / "traffic" / "busy.live.json").read_text())["sky"],
           aircraft=30, capture_seconds=0.4)


def test_same_seed_same_sky():
    a, b = T.make_sky(SKY, 2**40 + 3, 2e6, "cpu"), T.make_sky(SKY, 2**40 + 3, 2e6, "cpu")
    assert np.array_equal(a.iq, b.iq) and np.array_equal(a.frames, b.frames) and np.array_equal(a.offsets, b.offsets)


def test_other_seed_other_sky():
    a, b = T.make_sky(SKY, 11, 2e6, "cpu"), T.make_sky(SKY, 12, 2e6, "cpu")
    assert not np.array_equal(a.iq, b.iq)
    assert set(a.aircraft) != set(b.aircraft)


def test_frames_in_time_order_and_valid():
    sky = T.make_sky(dict(SKY, one_bit_error_share=0.0, two_bit_error_share=0.0), 5, 2e6, "cpu")
    assert np.all(np.diff(sky.offsets) >= 0) and 0 <= sky.offsets.min() and sky.offsets.max() < len(sky.iq)
    long_rows = np.isin(sky.kinds, [T.KINDS.index(k) for k in T.DF17_KINDS])
    crc = T.crc24_rows(sky.frames[long_rows][:, :11])
    parity = (sky.frames[long_rows][:, 11:].astype(np.int64) * [1 << 16, 1 << 8, 1]).sum(1)
    assert np.array_equal(crc, parity)
    ap = sky.kinds == T.KINDS.index("df4")
    address = T.crc24_rows(sky.frames[ap][:, :4]) ^ (sky.frames[ap][:, 4:7].astype(np.int64) * [1 << 16, 1 << 8, 1]).sum(1)
    assert np.array_equal(address, sky.icao[ap])


def test_rates():
    sky = T.make_sky(dict(SKY, capture_seconds=4.0), 9, 2e6, "cpu")
    per_s = len(sky.frames) / 4.0 / len(sky.aircraft)
    assert abs(per_s - 6.1) < 0.4


def test_errors_in_data_bits():
    sky = T.make_sky(dict(SKY, capture_seconds=3.0, one_bit_error_share=0.05, two_bit_error_share=0.05), 3, 2e6, "cpu")
    assert {1, 2} <= set(sky.flips.tolist())
    flipped = sky.flips > 0
    assert set(np.asarray(T.KINDS)[sky.kinds[flipped]]) <= T.DF17_KINDS
    assert np.all(sky.frames[flipped, 0] >> 3 == 17)


def test_crc_scalar_and_table_agree():
    rows = np.random.default_rng(0).integers(0, 256, (50, 11), dtype=np.uint8)
    assert [T.crc24_scalar(bytes(r)) for r in rows] == T.crc24_rows(rows).tolist()


def test_link_follows_free_space_and_the_horizon():
    """A frame from twice as far arrives 6 dB weaker; an aircraft past the
    radio horizon is not heard; the level sets the pulses' amplitude."""
    rx = SKY["receiver"]
    lat = np.array([rx["latitude_deg"] + 0.5, rx["latitude_deg"] + 1.0, rx["latitude_deg"] + 4.0])
    lon = np.full(3, rx["longitude_deg"])
    height = np.full(3, 3048.0)
    snr, heard = T.link(SKY, lat, lon, height, np.full(3, 24.0), 2e6)
    assert abs((snr[0] - snr[1]) - 20 * np.log10(np.hypot(111_195, 3038) / np.hypot(55_597, 3038))) < 0.01
    assert heard.tolist() == [True, True, False]
    near = dict(SKY, aircraft=1, capture_seconds=2.0, latitude_deg=[52.3, 52.3], longitude_deg=[4.8, 4.8])
    sky = T.make_sky(near, 21, 2e6, "cpu")
    mag = np.hypot(sky.iq[:, 0].astype(float), sky.iq[:, 1].astype(float))
    pulse = mag[sky.offsets[0] + np.array(T.PREAMBLE_PULSES)]
    want = SKY["noise_std"] * np.sqrt(2.0) * 10 ** (sky.snr_db[0] / 20)
    assert np.all(np.abs(pulse - want) < 6 * SKY["noise_std"])
