"""The port's live input against airjax on the CPU: airjax_torch.native (its
own g++ build of native/airjax_native.cpp) against airjax.native export
by export and on the ring's FIFO, full and empty behaviour; and, through
the fake SoapySDR C-ABI double (native/fake_soapysdr.c), airjax_torch.sdr
and the `list`, `receive` and live `adsb` commands against airjax's on the
same fake, `--torch-device cpu`."""

import contextlib
import hashlib
import io
import itertools
import os
import re

import numpy as np
import pytest

from airjax import cli as jcli
from airjax import native as jnative
from airjax import sdr as jsdr
from airjax_torch import cli, native, sdr
from airjax_torch.io import synth
from airjax_torch.io.c16 import load_c16, save_c16
from airjax_torch.protocol import shortframe

CALLSIGN = "FAKESDR_"
TRACKED = native.NATIVE_DIR / "libairjax_native.so"


def test_port_builds_its_own_library_and_leaves_the_tracked_one(tmp_path, monkeypatch):
    """The port compiles native/airjax_native.cpp into its build directory
    and loads that file; airjax's tracked native/libairjax_native.so is
    neither written nor loaded."""
    before = hashlib.sha256(TRACKED.read_bytes()).hexdigest()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    assert native.library_path().parent == tmp_path / "build" and native.library_path().exists()
    assert lib._name == str(native.library_path()) and native.crc24(b"\x8d") == jnative.crc24(b"\x8d")
    assert hashlib.sha256(TRACKED.read_bytes()).hexdigest() == before
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native.library_path().name]


def test_c16_round_trip_both_ways(tmp_path):
    data = np.random.default_rng(0).integers(-32768, 32768, size=(5000, 2), dtype=np.int16)
    native.save_c16(data, tmp_path / "t.c16")
    jnative.save_c16(data, tmp_path / "j.c16")
    assert (tmp_path / "t.c16").read_bytes() == (tmp_path / "j.c16").read_bytes()
    for path in ("t.c16", "j.c16"):
        np.testing.assert_array_equal(native.load_c16(tmp_path / path), jnative.load_c16(tmp_path / path))
    np.testing.assert_array_equal(native.load_c16(tmp_path / "t.c16"), data)
    with pytest.raises(ValueError):
        native.load_c16(tmp_path / "missing.c16")


def test_magnitude_and_crc24_equal_airjax():
    rng = np.random.default_rng(1)
    iq = rng.integers(-32768, 32768, size=(100000, 2), dtype=np.int16)
    np.testing.assert_array_equal(native.magnitude(iq), jnative.magnitude(iq))
    for n in (3, 7, 11, 14):
        msg = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert native.crc24(msg) == jnative.crc24(msg)


def _mixed(seed: int, n: int = 20000) -> np.ndarray:
    """DF17 with and without a 1- or 2-bit flip, and every short format."""
    icao = 0x7C6B30
    frame = synth.make_df17(icao, synth.make_id_me("NATEXT_"))
    frames = [frame, synth.flip_bit(frame, 33), synth.flip_bit(synth.flip_bit(frame, 21), 69),
              shortframe.make_df11(icao), shortframe.make_df11(icao, interrogator=5),
              shortframe.make_df4(icao, altitude_ft=7500, gillham=True), shortframe.make_df5(icao, squawk=7700),
              shortframe.make_df20(icao, altitude_ft=36000), shortframe.make_df21(icao, squawk=1200),
              shortframe.make_df24(icao, nd=3, md=bytes(range(10)), ke=0)]
    rng = np.random.default_rng(seed)
    offs = sorted(rng.choice(np.arange(1, (n - 300) // 600) * 600, size=len(frames), replace=False))
    return synth.modulate(frames, [int(o) for o in offs], n, noise_std=float(rng.choice([0.0, 30.0, 80.0])),
                          seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_chunk_entries_equal_airjax(seed):
    iq = _mixed(seed)
    assert native.decode_chunk(iq) == jnative.decode_chunk(iq)
    for recover2 in (False, True):
        got = native.decode_chunk_extended(iq, recover2=recover2)
        assert got == jnative.decode_chunk_extended(iq, recover2=recover2)
        assert len(got[0]) >= 9 and ("long2" in {h[1] for h in got[0]}) == recover2
    assert native.decode_chunk(iq, max_hits=1) == jnative.decode_chunk(iq, max_hits=1)


def test_ring_fifo_full_and_empty_equal_airjax():
    rings = native.Ring(block_samples=1000, depth=3), jnative.Ring(block_samples=1000, depth=3)
    blocks = [np.full((n, 2), i, dtype=np.int16) for i, n in enumerate((1000, 500, 1, 1000, 1001, 7))]
    ops = ["push", "push", "pop", "push", "push", "push", "len", "pop", "pop", "pop", "pop", "push", "len", "pop"]
    trace = []
    for ring in rings:
        it = iter(blocks)
        seen = []
        for op in ops:
            if op == "push":
                seen.append(ring.push(next(it)))
            elif op == "len":
                seen.append(len(ring))
            else:
                b = ring.pop()
                seen.append(None if b is None else (b.shape, int(b[0, 0])))
        ring.close()
        ring.close()
        trace.append(seen)
    assert trace[0] == trace[1]
    assert trace[0][:6] == [True, True, ((1000, 2), 0), True, True, False]  # depth 3: the 4th push backs off
    assert trace[0][10] is None  # empty


@pytest.fixture(scope="module")
def fake_capture(tmp_path_factory):
    """A 20,000-sample .c16 (one fake MTU block, cycled) holding three DF17
    identification frames, and the fake built from native/fake_soapysdr.c."""
    frame = synth.make_df17(0x7C0DEF, synth.make_id_me(CALLSIGN))
    iq = synth.modulate([frame] * 3, [1000, 7000, 13000], 20000, seed=11)
    path = tmp_path_factory.mktemp("sdr") / "fake.c16"
    save_c16(iq, path)
    return path, native.build_fake_soapysdr()


@pytest.fixture
def fake_env(fake_capture, tmp_path, monkeypatch):
    capture, lib = fake_capture
    log = tmp_path / "soapy.log"
    monkeypatch.setenv("AIRJAX_SOAPY_LIB", str(lib))
    monkeypatch.setenv("AIRJAX_FAKE_SOAPY_C16", str(capture))
    monkeypatch.setenv("AIRJAX_FAKE_SOAPY_LOG", str(log))
    monkeypatch.chdir(tmp_path)
    return log


def _main(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_list_equals_airjax(fake_env):
    assert _main(cli.main, ["list"]) == _main(jcli.main, ["list"]) == (0, "0: device 0\n")
    assert fake_env.read_text().count("kwargslist_clear len=1") == 2


def test_source_streams_the_fake_as_airjax(fake_env, fake_capture):
    """Every ctypes signature runs, the configured values cross the FFI
    intact (the same log as airjax's), and the plain and the ring-buffered
    iterators give airjax's blocks."""
    logs, streams = [], []
    for mod in (sdr, jsdr):
        fake_env.write_text("")
        src = mod.SdrSource(device=0)
        plain = list(itertools.islice(src.blocks(), 3))
        src.close()
        src = mod.SdrSource(device=0)
        ringed = list(itertools.islice(src.blocks_ringbuffered(), 3))
        src.close()
        # The ring's reader reads ahead until it is stopped: how far is a
        # matter of timing, in both packages.
        log = fake_env.read_text()
        assert log.count("closeStream reads=4\n") >= 1  # the plain 3 blocks and the injected error
        logs.append(re.sub(r"closeStream reads=\d+", "closeStream", log))
        streams.append(plain + ringed)
    assert logs[0] == logs[1] and "setGainElement dir=1 chan=0 name=TUNER value=49.50" in logs[0]
    want = load_c16(fake_capture[0])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)


def test_receive_equals_airjax(fake_env):
    """`receive --synthetic` writes airjax's bytes; a live `receive` writes a
    capture that opens with the fake's blocks, under airjax's name."""
    rc, text = _main(cli.main, ["receive", "2000000.0", "2000000.0", "49.5", "1", "--synthetic"])
    name = "data_2000000.0_2000000.0_49.5"
    ours = open(name, "rb").read()
    assert _main(jcli.main, ["receive", "2000000.0", "2000000.0", "49.5", "1", "--synthetic"]) == (rc, text) == (
        0, f"saved 2000000 synthetic samples to {name}\n")
    assert open(name, "rb").read() == ours
    rc, text = _main(cli.main, ["receive", "1090000000.0", "2000000.0", "49.5", "1", "-d", "0"])
    cap = load_c16("data_1090000000.0_2000000.0_49.5")
    assert rc == 0 and text == f"saved {len(cap)} samples to data_1090000000.0_2000000.0_49.5\n"
    assert len(cap) >= 20000 and len(cap) % 20000 == 0
    np.testing.assert_array_equal(cap[:20000], load_c16(os.environ["AIRJAX_FAKE_SOAPY_C16"]))
    assert "makeStrArgs args=\"driver=rtlsdr,rtl=0\"" in fake_env.read_text()


def _masked(text: str) -> list[str]:
    return [ln for ln in text[: text.rindex("\nstats: ")].splitlines() if not ln.startswith("Processed Time")]


@pytest.mark.parametrize("extra", [[], ["--extended"]])
def test_live_adsb_equals_airjax(fake_env, extra):
    """`adsb` with neither --playback nor --synthetic: the fake's frames,
    through the native ring, printed as airjax prints them; the SDR closed."""
    sdr.ring_blocks = 0
    rc, text = _main(cli.main, ["adsb", "--max-blocks", "4", "--torch-device", "cpu", *extra])
    assert rc == 0 and sdr.ring_blocks >= 4
    assert "closeStream" in fake_env.read_text() and "unmake" in fake_env.read_text()
    rc_j, text_j = _main(jcli.main, ["adsb", "--max-blocks", "4", *extra])
    assert rc_j == 0 and _masked(text) == _masked(text_j)
    assert text.count(f"Callsign            : {CALLSIGN}") == 12
    stats = text[text.rindex("stats: ") :]
    assert "'blocks': 4," in stats and "'good': 12," in stats


def test_live_adsb_without_soapysdr_exits_1(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("AIRJAX_SOAPY_LIB", str(tmp_path / "no_such_library.so"))
    assert cli.main(["adsb", "--torch-device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert jcli.main(["adsb"]) == 1
    assert capsys.readouterr().err == err and "hint: use --playback FILE or --synthetic N" in err
    assert cli.main(["list"]) == 1 and "SoapySDR library not found" in capsys.readouterr().err
