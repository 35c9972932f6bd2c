"""The port's host packet model and stream sinks against airjax's, byte for
byte: AdsbPacket.from_bytes -> stream_printer / jsonl_writer over every
ME type code class, with extensions on and off, and the extended-mode
packet classes. Same frames and the same fixed time_processed on both
sides; the tolerance is exact equality of the printed text."""

import io

import numpy as np
import pytest

from airjax.io import synth as jsynth
from airjax.protocol import acas as jacas
from airjax.protocol import packet as jpacket
from airjax.ui import stream as jstream
from airjax_torch.protocol import acas as tacas
from airjax_torch.protocol import fields as tfields
from airjax_torch.protocol import packet as tpacket
from airjax_torch.ui import stream as tstream

T = 1_700_000_123.456789
ICAO = 0x4CA2D6


def _me_cases() -> dict[str, list[bytes]]:
    """ME fields per type-code class, made by airjax's synth."""
    rng = np.random.default_rng(7)
    cases = {
        "tc1-4": [jsynth.make_id_me("KLM1023", tc=tc, category=tc % 8) for tc in (1, 2, 3, 4)],
        "tc9-18": [
            jsynth.make_position_me(tc, 1000 + 25 * tc * 37, 93000 + tc, 51372 - tc, bool(tc % 2),
                                    q25=bool(tc % 3), nic=tc % 2)
            for tc in range(9, 19)
        ],
        "tc0": [bytes([0x00, 0x61, 0x20, 0, 0, 0, 0]), bytes(7)],
        "tc5-8": [
            jsynth.make_surface_me(52.3 + tc / 100, 4.76, bool(tc % 2), tc=tc,
                                   speed_kt=None if tc == 5 else 3.0 * tc,
                                   track_deg=None if tc == 6 else 45.0 * tc)
            for tc in range(5, 9)
        ],
        "tc19": [
            jsynth.make_velocity_me(ew_kt=-250, ns_kt=120, vertical_rate_fpm=-1088),
            jsynth.make_velocity_me(ew_kt=31, ns_kt=-455, vertical_rate_fpm=2240, gnss_baro_diff_ft=-75),
            jsynth.make_velocity_me(subtype=3, heading_deg=271.4, vertical_rate_fpm=640),
        ],
        "tc20-22": [jsynth.make_gnss_position_me(tc, 1200 + tc, 70000, 9000, bool(tc % 2)) for tc in (20, 21, 22)],
        "tc28": [jsynth.make_status_me(7700, emergency_state=1), jsynth.make_status_me(1200)],
        "tc29": [
            jsynth.make_target_state_me(selected_altitude_ft=35008, baro_setting_mb=1013.6,
                                        selected_heading_deg=87.2, autopilot=True),
            jsynth.make_target_state_me(),
        ],
        "tc31": [jsynth.make_opstatus_me(), jsynth.make_opstatus_me(version=1, surface=True, lw_code=5)],
        "unknown": [bytes([(tc << 3) | 2]) + bytes(rng.integers(0, 256, 6, dtype=np.uint8)) for tc in (23, 24, 25, 26, 27, 30)],
    }
    # Random ME bytes under each type code: the decoders' edge values.
    cases["random"] = [bytes([tc << 3 | int(rng.integers(0, 8))]) + bytes(rng.integers(0, 256, 6, dtype=np.uint8))
                       for tc in range(32) for _ in range(3)]
    return cases


ME_CASES = _me_cases()


def _frames(group: str) -> list[bytes]:
    frames = [jsynth.make_df17(ICAO + i, me, capability=i % 8) for i, me in enumerate(ME_CASES[group])]
    # DF18 with every CF and DF19 (AF 0 and not): the extension ME gate.
    me = ME_CASES[group][0]
    frames += [jsynth.make_df18(ICAO, me, cf=cf) for cf in range(8)]
    df19 = bytearray(jsynth.make_df17(ICAO, me))
    frames += [bytes([(19 << 3) | af]) + bytes(df19[1:]) for af in (0, 3)]
    return frames


def _printed(stream_mod, packets) -> str:
    out = io.StringIO()
    sink = stream_mod.stream_printer(out)
    for p in packets:
        sink(p)
    return out.getvalue()


def _jsonl(stream_mod, packets, path) -> bytes:
    sink = stream_mod.jsonl_writer(str(path))
    for p in packets:
        sink(p)
    return path.read_bytes()


@pytest.mark.parametrize("extensions", [False, True])
@pytest.mark.parametrize("group", sorted(ME_CASES))
def test_stream_and_jsonl_equal_airjax(group, extensions, tmp_path):
    frames = _frames(group)
    want = [jpacket.AdsbPacket.from_bytes(f, T, extensions=extensions) for f in frames]
    got = [tpacket.AdsbPacket.from_bytes(f, T, extensions=extensions) for f in frames]
    text = _printed(tstream, got)
    assert text == _printed(jstream, want)
    assert text.count("\n== ") == len(frames)
    assert _jsonl(tstream, got, tmp_path / "t.jsonl") == _jsonl(jstream, want, tmp_path / "j.jsonl")
    assert [str(g) for g in got] == [str(w) for w in want]


def _extended_packets(mod, acas_mod):
    ra = acas_mod.decode_mv_ra(acas_mod.make_mv_ra(ara=0b10000000000000, rac=0b0100, rat=1))
    return [
        mod.AllCallReply(icao=ICAO, capability=5, time_processed=T),
        mod.AllCallReply(icao=ICAO, capability=6, time_processed=T, interrogator=17),
        mod.SurveillanceReply(df=4, icao=ICAO, flight_status=1, altitude_ft=36000, squawk=None, time_processed=T),
        mod.SurveillanceReply(df=5, icao=ICAO, flight_status=0, altitude_ft=None, squawk=612, time_processed=T),
        mod.SurveillanceReply(df=20, icao=ICAO, flight_status=2, altitude_ft=None, squawk=None,
                              time_processed=T, bds={"2,0": "KLM1023_", "4,0": {"mcp_alt_ft": 35008}}),
        mod.AcasReply(df=0, icao=ICAO, vertical_status=1, sensitivity_level=5, reply_information=3,
                      altitude_ft=None, time_processed=T),
        mod.AcasReply(df=16, icao=ICAO, vertical_status=0, sensitivity_level=7, reply_information=4,
                      altitude_ft=23000, time_processed=T, ra=ra),
        mod.CommDReply(icao=ICAO, ke=1, nd=3, md=bytes(range(10)), time_processed=T),
    ]


def test_extended_packet_classes_print_equal_airjax(tmp_path):
    want = _extended_packets(jpacket, jacas)
    got = _extended_packets(tpacket, tacas)
    assert _printed(tstream, got) == _printed(jstream, want)
    assert _jsonl(tstream, got, tmp_path / "t.jsonl") == _jsonl(jstream, want, tmp_path / "j.jsonl")


def test_tee_fans_out_in_order():
    seen = []
    sink = tstream.tee(lambda p: seen.append(("a", p)), lambda p: seen.append(("b", p)))
    sink(1)
    sink(2)
    assert seen == [("a", 1), ("b", 1), ("a", 2), ("b", 2)]


def test_squawk_and_char_table_equal_airjax():
    from airjax.protocol import fields as jfields

    assert tfields.CHAR_CONVERT == jfields.CHAR_CONVERT
    np.testing.assert_array_equal(tfields._CHAR_TABLE, jfields._CHAR_TABLE)
    assert (tfields.MSG_UNKNOWN, tfields.MSG_AIRCRAFT_ID, tfields.MSG_AIRCRAFT_POSITION,
            tfields.MSG_AIRCRAFT_VELOCITY) == (jfields.MSG_UNKNOWN, jfields.MSG_AIRCRAFT_ID,
                                               jfields.MSG_AIRCRAFT_POSITION, jfields.MSG_AIRCRAFT_VELOCITY)
    for id13 in range(1 << 13):
        assert tpacket.squawk_from_id13(id13) == jpacket.squawk_from_id13(id13)
    assert tpacket.DF18_ADSB_CF == jpacket.DF18_ADSB_CF and tpacket.DF19_ADSB_AF == jpacket.DF19_ADSB_AF
