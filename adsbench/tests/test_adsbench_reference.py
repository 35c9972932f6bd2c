"""The plain reference decodes a small generated capture to the frames
it embeds, and its tracker holds the aircraft the sky flew."""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from adsbench.tests.conftest import REPO
from adsbench.yardstick import reference as ref
from adsbench.yardstick import traffic as T

SKY = dict(json.loads((REPO / "adsbench" / "traffic" / "busy.live.json").read_text())["sky"],
           aircraft=25, capture_seconds=1.0, one_bit_error_share=0.05, two_bit_error_share=0.05)


def alone(sky) -> np.ndarray:
    """(n,) bool: frames whose 240-sample window no other frame's touches."""
    off = sky.offsets
    gap_before = np.diff(off, prepend=off[0] - T.WINDOW)
    gap_after = np.diff(off, append=off[-1] + T.WINDOW)
    return (gap_before >= T.WINDOW) & (gap_after >= T.WINDOW)



def test_df17_truth():
    sky = T.make_sky(SKY, 2**35 + 1, 2e6, "cpu")
    got = ref.decode_df17(torch.as_tensor(sky.iq))
    is17 = np.isin(sky.kinds, [T.KINDS.index(k) for k in T.DF17_KINDS])
    want = is17 & (sky.flips <= 1) & alone(sky)
    assert set(sky.offsets[want].tolist()) <= set(got["offsets"].tolist()) <= set(sky.offsets.tolist())
    keep = np.isin(got["offsets"], sky.offsets[want])
    got = {k: v[keep] for k, v in got.items()}
    # A 1-bit error repaired: every frame decodes to a valid DF17 of its sender.
    res = ref.crc24(torch.as_tensor(got["frames"]), 11) ^ ref.field24(torch.as_tensor(got["frames"]), 11)
    assert not res.any()
    assert np.array_equal((got["frames"][:, 1:4].astype(np.int64) * [1 << 16, 1 << 8, 1]).sum(1), sky.icao[want])
    assert np.array_equal(got["frames"][sky.flips[want] == 0], sky.frames[want & (sky.flips == 0)])
    assert got["repaired"].tolist() == (sky.flips[want] == 1).tolist()


def test_extended_truth():
    sky = T.make_sky(SKY, 2**35 + 2, 2e6, "cpu")
    got = ref.decode_extended(torch.as_tensor(sky.iq))
    at = dict(zip(got["offsets"].tolist(), range(len(got["offsets"]))))
    kind_of = {"position": ref.LONG, "velocity": ref.LONG, "id": ref.LONG, "df11": ref.DF11,
               "df4": ref.SHORT_AP, "df5": ref.SHORT_AP, "df20": ref.LONG_AP}
    for i in np.nonzero((sky.flips <= 1) & alone(sky))[0]:
        j = at[int(sky.offsets[i])]
        kind = T.KINDS[sky.kinds[i]]
        assert got["kinds"][j] == kind_of[kind], kind
        if kind in ("df4", "df5", "df20"):
            assert got["address"][j] == sky.icao[i]
        if sky.flips[i] == 0:
            assert np.array_equal(got["frames"][j], sky.frames[i])
    # 2-bit errors are no long squitters.
    for i in np.nonzero((sky.flips == 2) & alone(sky))[0]:
        assert int(sky.offsets[i]) not in at or got["kinds"][at[int(sky.offsets[i])]] != ref.LONG


def test_over_stream_loops():
    loop = {"offsets": np.array([0, 500, 990]), "frames": np.zeros((3, 14), np.uint8)}
    out = ref.over_stream(loop, 1000, 2500)
    assert out["offsets"].tolist() == [0, 500, 990, 1000, 1500, 1990, 2000]


def test_table_flies_the_truth():
    sky = T.make_sky(dict(SKY, capture_seconds=3.0, one_bit_error_share=0.0, two_bit_error_share=0.0),
                     2**35 + 3, 2e6, "cpu")
    got = ref.decode_df17(torch.as_tensor(sky.iq))
    table = ref.table(got["frames"])
    assert set(table) == set(sky.aircraft)
    named = set(sky.icao[(sky.kinds == T.KINDS.index("id")) & alone(sky)].tolist())
    for icao, row in table.items():
        truth = sky.aircraft[icao]
        cs = truth["callsign"].ljust(8, "_")
        assert row["callsign"] == cs if icao in named else row["callsign"] in (None, cs)
        assert row["altitude"] == truth["altitude_ft"]
        lat, lon = row["position"]
        assert 49.9 < lat < 54.2 and 1.5 < lon < 7.5


def test_cpr_global_decode():
    # An even and an odd encoding of one point: the newest even decodes to
    # it; the newest odd takes the reference decoder's NL(lat - 1 degree)
    # zones for the longitude, as the program's tracker does.
    from airjax_torch.protocol.packet import CprFormat
    from airjax_torch.track.cpr import calculate_geographic_position

    rng = np.random.default_rng(4)
    for lat, lon in zip(rng.uniform(50, 54, 50), rng.uniform(2, 7, 50)):
        e, o = (tuple(int(v[0]) for v in T.encode_airborne_cpr(np.array([lat]), np.array([lon]), np.array([odd])))
                for odd in (False, True))
        la, lo = ref.cpr_global(e, o, False)
        assert math.isclose(la, lat, abs_tol=1e-4) and math.isclose(lo, lon, abs_tol=1e-4)
        for newest_odd, first in ((False, CprFormat.ODD), (True, CprFormat.EVEN)):
            port = calculate_geographic_position(e, o, first)
            assert ref.cpr_global(e, o, newest_odd) == (port.latitude, port.longitude)


def test_extended_table_flies_the_truth():
    """The plain tracker's extended table: each heard aircraft's altitude
    (from positions and DF4/DF20), squawk (DF5) and velocity (TC 19) are
    the sky's."""
    from adsbench.yardstick import check

    sky = T.make_sky(dict(SKY, capture_seconds=4.0, one_bit_error_share=0.0, two_bit_error_share=0.0),
                     2**35 + 4, 2e6, "cpu")
    got = ref.decode_extended(torch.as_tensor(sky.iq))
    take = check.taken(got, 20000)
    table = ref.table(got["frames"][take], got["kinds"][take], got["address"][take])
    assert set(table) == set(sky.aircraft)
    # A DF5 comes every 5 s of air at random: most aircraft have sent one.
    assert sum(row["squawk"] is not None for row in table.values()) > len(table) // 2
    for icao, row in table.items():
        truth = sky.aircraft[icao]
        assert row["altitude"] == truth["altitude_ft"]
        assert row["squawk"] in (None, int(truth["squawk"]))
        assert row["vertical_rate_fpm"] == 0
        assert 200 / 0.514444 - 2 < row["ground_speed_kt"] < 250 / 0.514444 + 2
        assert 0.0 <= row["track_deg"] < 360.0


def test_fields_decode_as_the_program_does():
    """Every 13-bit AC and ID code, and velocities of every sign and
    subtype, decode as the program's host decoders read them."""
    from airjax_torch.extended import _short_fields_host
    from airjax_torch.protocol.packet import AircraftVelocityMsg

    for code in range(1 << 13):
        frame = bytes([4 << 3, 0, (code >> 8) & 0x1F, code & 0xFF, 0, 0, 0])
        host = _short_fields_host(frame)
        assert ref.ac13_altitude(code) == host["altitude_ft"], code
        assert ref.id13_squawk(code) == host["squawk"], code
    rng = np.random.default_rng(5)
    for me in rng.integers(0, 256, (2000, 7), dtype=np.uint8):
        me[0] = (19 << 3) | int(rng.integers(1, 5))
        msg = AircraftVelocityMsg.from_me(bytes(me))
        gs, track, vr = ref.velocity(bytes(me))
        assert (gs, vr) == (msg.ground_speed_kt, msg.vertical_rate_fpm)
        assert track == msg.track_deg
