"""airjax_torch.runner, io and cli against airjax: the packet stream and
StreamStats of run_stream in overlap and parity modes, byte equality of
the synthetic IQ, and the CLI end to end on the CPU, its printed packets
byte for byte against airjax's stream printer (wall-clock lines masked)."""

import io
import contextlib
import re

import numpy as np
import pytest
import torch

from airjax import cli as jcli
from airjax import runner as jrunner
from airjax.config import DEFAULT_CONFIG as JDEFAULT_CONFIG
from airjax.io import source as jsource
from airjax.io import synth as jsynth
from airjax.io import c16 as jc16
from airjax.ui import stream as jstream
from airjax_torch import analytics, cli, pipeline
from airjax_torch import runner as trunner
from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.io import c16 as tc16
from airjax_torch.io import source as tsource
from airjax_torch.io import synth as tsynth
from airjax_torch.parallel import multihost
from airjax_torch.parallel.mesh import make_mesh
from airjax_torch.protocol import crc as tcrc
from airjax_torch.protocol import shortframe
from airjax_torch.tools import bench_stream

STAT_KEYS = ("blocks", "samples", "detections", "good", "recovered", "overflow_blocks")


def _capture(n: int, offsets, seed: int, flips=()) -> tuple[np.ndarray, list[bytes]]:
    """IQ with DF17 frames at offsets (those indexed by `flips` sent with
    one data bit flipped) -> (iq, the frames as sent before corruption)."""
    frames, sent = [], []
    for i, _ in enumerate(offsets):
        me = tsynth.make_id_me(f"RUN{i:04d}") if i % 2 else tsynth.make_position_me(
            11, 5000 + 25 * i, (i * 31337) % (1 << 17), (i * 7331) % (1 << 17), bool(i % 4 == 1))
        f = tsynth.make_df17(0xA00000 + i, me)
        frames.append(f)
        sent.append(tsynth.flip_bit(f, 30 + i % 50) if i in flips else f)
    return tsynth.modulate(sent, list(offsets), n, seed=seed), frames


def _blocks(iq: np.ndarray, sizes):
    """Split iq into blocks of the given sizes (cycled), last one ragged."""
    i, k = 0, 0
    while i < len(iq):
        size = sizes[k % len(sizes)]
        yield iq[i : i + size]
        i += size
        k += 1


def _run_both(iq, sizes, overlap):
    got = []
    t_stats = trunner.run_stream(_blocks(iq, sizes), got.append, overlap=overlap, device="cpu")
    want = []
    j_stats = jrunner.run_stream(_blocks(iq, sizes), want.append, overlap=overlap)
    return [p.packet for p in got], t_stats.as_dict(), [p.packet for p in want], j_stats.as_dict()


@pytest.mark.parametrize("overlap", [True, False])
def test_run_stream_equals_airjax(overlap):
    chunk = 20000
    n = 7 * chunk + 70000 + 5000
    # Straddlers at every 20k edge, frames inside the large block, one
    # in the ragged tail, a few corrupted (repairable) ones.
    offsets = sorted([chunk * b - 120 for b in range(1, 8)] + [150000, 181000, 209000, 213500, 5000, 65000])
    iq, frames = _capture(n, offsets, 21, flips=(1, 4, 9))
    sizes = [chunk] * 7 + [70000, 5000]  # the 70000-sample block takes the tuned scan
    got, t_stats, want, j_stats = _run_both(iq, sizes, overlap)
    assert got == want
    for key in STAT_KEYS:
        assert t_stats[key] == j_stats[key], key
    assert set(t_stats["stages"]) == {"source", "handoff", "carry", "dispatch", "hold", "fetch", "apply", "sink"}
    if overlap:
        assert got == frames  # every frame once, in order; repairs restore the sent frames
        assert t_stats["recovered"] == 3
    else:
        assert len(got) < len(offsets)  # chunk-edge straddlers are lost


def test_run_stream_short_reads_equal_airjax():
    n = 12000
    iq, _ = _capture(n, [100, 700, 3000, 11700], 4)
    sizes = [100, 900, 37, 5000, 239, 1]  # reads shorter than a window accumulate
    got, t_stats, want, j_stats = _run_both(iq, sizes, True)
    assert got == want and len(want) == 4
    for key in STAT_KEYS:
        assert t_stats[key] == j_stats[key], key


def _posarg_capture() -> np.ndarray:
    """A DF17, a DF11 and the DF17 again in 60,000 samples: the DF11 shows
    whether a stream decoded the extended formats."""
    df17 = tsynth.make_df17(0x7C6B30, tsynth.make_id_me("POSARG"))
    return tsynth.modulate([df17, shortframe.make_df11(0x7C6B30, capability=5), df17], [500, 5000, 30000], 60000,
                           seed=3)


def _described(packets) -> list:
    return [(type(p).__name__, [ln for ln in p.format().splitlines() if not ln.startswith("Processed Time")])
            for p in packets]


@pytest.mark.parametrize("extended_by_position", [False, True])
def test_run_stream_binds_airjax_positional_arguments(extended_by_position):
    """airjax's positional call, passed unchanged to both packages, gives
    the same packets and stats (the port on the CPU by keyword): the 2 is
    prefetch_depth, not extended, and extended is airjax's eighth."""
    iq = _posarg_capture()
    got, want = [], []
    if extended_by_position:
        t_stats = trunner.run_stream(_blocks(iq, [20000]), got.append, DEFAULT_CONFIG, True, 4, None, None, True,
                                     device="cpu")
        j_stats = jrunner.run_stream(_blocks(iq, [20000]), want.append, JDEFAULT_CONFIG, True, 4, None, None, True)
        classes = ["AdsbPacket", "AllCallReply", "AdsbPacket"]
    else:
        t_stats = trunner.run_stream(_blocks(iq, [20000]), got.append, DEFAULT_CONFIG, True, 2, device="cpu")
        j_stats = jrunner.run_stream(_blocks(iq, [20000]), want.append, JDEFAULT_CONFIG, True, 2)
        classes = ["AdsbPacket", "AdsbPacket"]
    assert [type(p).__name__ for p in got] == classes
    assert _described(got) == _described(want)
    assert t_stats.good == j_stats.good == len(classes)
    for key in STAT_KEYS:
        assert t_stats.as_dict()[key] == j_stats.as_dict()[key], key


_NO_DEVICE = {
    "decode_capture_overlap": lambda iq: pipeline.decode_capture_overlap(iq),
    "decode_capture_parity": lambda iq: pipeline.decode_capture_parity(iq, PipelineConfig(block_len=20000)),
    "decode_iq_block_adaptive": lambda iq: pipeline.decode_iq_block_adaptive(iq[:20000], 20000 - 240, 16),
    "run_stream": lambda iq: trunner.run_stream(_blocks(iq, [20000]), lambda p: None),
    "run_stream_sharded": lambda iq: trunner.run_stream_sharded(_blocks(iq, [20000]), lambda p: None),
    "analyze_capture": lambda iq: analytics.analyze_capture(iq),
    "analyze_capture_extended": lambda iq: analytics.analyze_capture_extended(iq),
    "make_mesh": lambda iq: make_mesh(1),
    "multihost.decode_capture": lambda iq: multihost.decode_capture(iq, 64),
    "attach_candidate_fields": lambda iq: multihost.attach_candidate_fields(
        {"frames": np.zeros((1, 14), np.uint8), "frames_raw": np.zeros((1, 14), np.uint8)}),
    "bench_stream.run_once": lambda iq: bench_stream.run_once([iq[:20000]], 1),
    "crc.tables": lambda iq: tcrc.tables(),
}


@pytest.mark.parametrize("name", sorted(_NO_DEVICE))
def test_airjax_calls_without_a_device_need_a_card(name):
    """An entry point called as airjax calls it, with no device, runs on
    the card: without one it raises (torch's AssertionError or
    RuntimeError, or the port's own error), and never falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError, ValueError), match=re.compile("cuda|devices", re.I)):
        _NO_DEVICE[name](_posarg_capture())


def test_synth_is_byte_identical_to_airjax():
    me_t = tsynth.make_position_me(11, 35000, 93000, 51372, True, q25=False, nic=1)
    me_j = jsynth.make_position_me(11, 35000, 93000, 51372, True, q25=False, nic=1)
    assert me_t == me_j
    assert tsynth.make_id_me("KLM1023", category=3) == jsynth.make_id_me("KLM1023", category=3)
    f = tsynth.make_df17(0x484175, me_t, capability=4)
    assert f == jsynth.make_df17(0x484175, me_j, capability=4)
    assert tsynth.flip_bit(f, 87) == jsynth.flip_bit(f, 87)
    np.testing.assert_array_equal(tsynth.frame_to_pulses(f), jsynth.frame_to_pulses(f))
    np.testing.assert_array_equal(tsynth.frame_to_pulses(f[:7]), jsynth.frame_to_pulses(f[:7]))
    a = tsynth.modulate([f, f], [10, 500], 2000, snr_db=12.0, seed=9)
    b = jsynth.modulate([f, f], [10, 500], 2000, snr_db=12.0, seed=9)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tsynth.make_id_me("a~b")


def test_synthetic_blocks_equal_airjax():
    got = list(tsource.synthetic_blocks(n_blocks=3, frames_per_block=4, seed=2))
    want = list(jsource.synthetic_blocks(n_blocks=3, frames_per_block=4, seed=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_c16_and_playback_equal_airjax(tmp_path):
    iq = np.random.default_rng(3).integers(-32768, 32768, (3 * 1000 + 17, 2), dtype=np.int16)
    tc16.save_c16(iq, tmp_path / "t.c16")
    jc16.save_c16(iq, tmp_path / "j.c16")
    assert (tmp_path / "t.c16").read_bytes() == (tmp_path / "j.c16").read_bytes()
    np.testing.assert_array_equal(tc16.load_c16(tmp_path / "j.c16"), iq)
    (tmp_path / "bad.c16").write_bytes(b"\x00" * 6)
    with pytest.raises(ValueError):
        tc16.load_c16(tmp_path / "bad.c16")
    got = list(tsource.playback_blocks(str(tmp_path / "t.c16"), chunk=1000, realtime_factor=None))
    want = list(jsource.playback_blocks(str(tmp_path / "t.c16"), chunk=1000, realtime_factor=None))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prefetcher_keeps_order_and_raises_source_errors():
    def failing():
        yield from (np.full((4, 2), i, np.int16) for i in range(10))
        raise OSError("read failed")

    seen = []
    with pytest.raises(OSError):
        for block in tsource.Prefetcher(failing(), depth=2):
            seen.append(int(block[0, 0]))
    assert seen == list(range(10))


def _cli(argv) -> tuple[int, list[str], str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    text = out.getvalue()
    hexes = [line[3:-3] for line in text.splitlines() if line.startswith("== ")]
    return rc, hexes, text


def test_cli_synthetic_on_cpu():
    rc, hexes, text = _cli(["adsb", "--synthetic", "3", "--torch-device", "cpu"])
    assert rc == 0
    want = []
    jrunner.run_stream(jsource.synthetic_blocks(n_blocks=3), lambda p: want.append(p.packet.hex()))
    assert hexes == want and len(hexes) == 6
    assert "\nstats: {'blocks': 3," in text


def test_cli_prints_the_reference_display():
    """Every packet's full Display, as airjax's stream mode prints it (a
    port that printed only the `== <hex> ==` line fails here)."""
    rc, _, text = _cli(["adsb", "--synthetic", "3", "--torch-device", "cpu"])
    assert rc == 0
    want = io.StringIO()
    jrunner.run_stream(jsource.synthetic_blocks(n_blocks=3), jstream.stream_printer(want))

    def masked(t):
        return [ln for ln in t.splitlines() if not ln.startswith("Processed Time  : ")]

    got = masked(text[: text.rindex("\nstats: ")])
    assert got == masked(want.getvalue())
    assert got.count("Decoded Information:") == 6 and "Callsign            : SYN100__" in got


def test_cli_playback_overlap_and_no_overlap(tmp_path):
    chunk = 20000
    offsets = [300, chunk - 100, 2 * chunk + 4000, 3 * chunk - 50]
    iq, frames = _capture(4 * chunk + 10, offsets, 8)
    path = tmp_path / "capture.c16"
    tc16.save_c16(iq, path)
    rc, hexes, _ = _cli(["adsb", "--playback", str(path), "--fast", "--torch-device", "cpu"])
    assert rc == 0 and hexes == [f.hex() for f in frames]
    rc, hexes, _ = _cli(["adsb", "-p", str(path), "--fast", "--no-overlap", "--torch-device", "cpu"])
    assert rc == 0 and hexes == [frames[0].hex(), frames[2].hex()]
    rc, hexes, _ = _cli(["adsb", "-p", str(path), "--fast", "--max-blocks", "1", "--torch-device", "cpu"])
    assert hexes == [frames[0].hex()]
    assert _cli(["adsb", "-p", str(tmp_path / "missing.c16"), "--fast", "--torch-device", "cpu"])[0] == 1


def test_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        cli.main(["adsb", "--synthetic", "1"])


def _parsed(build_parser, argv):
    """(exit status, the source chosen, the SDR index, the debug aids) of
    one command line: the playback wins over --synthetic, as both
    packages' _cmd_adsb read them."""
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return e.code, None, None, None
    source = "playback" if args.playback else "synthetic" if args.synthetic is not None else "sdr"
    return 0, source, args.device, (args.plot_dir, args.dump_preamble, args.trace, args.devices)


@pytest.mark.parametrize("argv", [
    ["adsb", "--synthetic", "1", "--device", "0"],
    ["adsb", "--synthetic", "1", "-d", "0"],
    ["adsb", "-p", "cap.c16", "--synthetic", "2"],
    ["adsb", "--synthetic", "1", "--plot-dir", "plots", "--dump-preamble", "--trace", "prof"],
    ["adsb", "--synthetic", "1", "--devices", "2", "--dump-preamble"],
    ["adsb", "--synthetic", "1", "--devices", "2", "--plot-dir", "plots"],
])
def test_cli_accepts_airjax_command_lines(argv, capsys):
    """Fault F2: the port's parser takes airjax's `-d/--device N` (the SDR
    index) and a playback beside --synthetic, and picks the same source;
    it takes airjax's debug aids (--plot-dir, --dump-preamble, --trace) and
    refuses the first two with --devices as airjax does: exit 2, the same
    message."""
    want = _parsed(jcli.build_parser, argv)
    assert want[0] == 0
    assert _parsed(cli.build_parser, argv) == want
    assert cli.build_parser().parse_args(argv).torch_device == "cuda"
    assert capsys.readouterr().err == ""
    if "--devices" in argv:
        assert jcli.main(argv) == 2
        refusal = capsys.readouterr().err
        assert cli.main([*argv, "--torch-device", "cpu"]) == 2
        assert capsys.readouterr().err == refusal and "single-device debug aids" in refusal


def test_cli_playback_wins_over_synthetic(tmp_path):
    iq, frames = _capture(2 * 20000 + 10, [300, 20000 + 4000], 5)
    path = tmp_path / "capture.c16"
    tc16.save_c16(iq, path)
    rc, hexes, _ = _cli(["adsb", "-p", str(path), "--synthetic", "2", "--fast", "--torch-device", "cpu", "-d", "0"])
    assert rc == 0 and hexes == [f.hex() for f in frames]
