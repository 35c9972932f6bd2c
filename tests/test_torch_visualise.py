"""airjax_torch.visualise and the adsb debug aids against airjax's
(tests/test_visualise.py): the text dumps byte for byte on real and
edge-case windows, the SVG plots (where matplotlib is installed), and the
stdout of `adsb --dump-preamble` equal to airjax's with `Processed Time`
masked; --plot-dir writes one SVG a DF17 frame, as airjax; both refused
with --devices."""

import contextlib
import io
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from airjax import cli as jcli
from airjax import golden as jgolden
from airjax import visualise as jvisualise
from airjax_torch import cli, golden, visualise
from airjax_torch.io import synth


def _windows() -> list[np.ndarray]:
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("VIZTEST"))
    iq = synth.modulate([frame], [500], 4000, seed=31)
    rng = np.random.default_rng(2)
    return [golden.magnitude(iq[500 : 500 + 240]), np.zeros(16), np.array([0, 800] + [0] * 14),
            np.array([100, 0, 0, 98, 0, 0, 0, 99, 97, 0, 0, 0, 0, 0, 0, 0]),
            rng.integers(0, 46341, 16), rng.integers(0, 3, 40), np.arange(10)]


def test_text_dumps_equal_airjax():
    for mags in _windows():
        assert visualise.format_preamble(mags) == jvisualise.format_preamble(mags)
        assert visualise.format_preamble_graph(mags) == jvisualise.format_preamble_graph(mags)
        for threshold in (0.5, 5.0, 99.0):
            assert visualise.format_preamble_ascii(mags, threshold) == jvisualise.format_preamble_ascii(mags, threshold)
        for offset in (None, 0, 500):
            assert visualise.dump_preamble(mags, offset) == jvisualise.dump_preamble(mags, offset)
    assert visualise.dump_preamble(_windows()[0][:16], offset=500).splitlines()[0] == "preamble @ 500"


def test_golden_magnitude_feeds_the_dump():
    iq = np.random.default_rng(4).integers(-32768, 32768, (64, 2)).astype(np.int16)
    np.testing.assert_array_equal(golden.magnitude(iq), jgolden.magnitude(iq))


def test_plot_adsb_frame_writes_parseable_svg(tmp_path):
    pytest.importorskip("matplotlib")
    path = visualise.plot_adsb_frame(_windows()[0], out_dir=tmp_path, detection_offset=0, title="frame @ 500")
    assert os.path.exists(path) and path.endswith(".svg")
    assert ET.parse(path).getroot().tag.endswith("svg") and os.path.getsize(path) > 1000
    path = visualise.plot_adsb_frame(np.zeros(16), out_dir=tmp_path, name="zero.svg")
    assert path.endswith("zero.svg")
    ET.parse(path)


def _stdout(main, argv) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    masked = [ln for ln in out.getvalue().splitlines() if not ln.startswith(("Processed Time", "stats:"))]
    return rc, masked


@pytest.mark.parametrize("extra", [[], ["--extended"], ["--no-overlap"]])
def test_cli_dump_preamble_equals_airjax(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    argv = ["adsb", "--synthetic", "2", "-m", "stream", "--dump-preamble", *extra]
    rc, want = _stdout(jcli.main, argv)
    assert rc == 0
    got = _stdout(cli.main, [*argv, "--torch-device", "cpu"])
    assert got == (0, want)
    assert sum(ln.startswith("preamble @ ") for ln in want) == 4 and any("▁" in ln for ln in want)


def test_cli_plot_dir_writes_an_svg_a_frame(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    for name, main, tail in (("port", cli.main, ["--torch-device", "cpu"]), ("airjax", jcli.main, [])):
        os.mkdir(name)
        rc, _ = _stdout(main, ["adsb", "--synthetic", "2", "-m", "stream", "--plot-dir", name, *tail])
        assert rc == 0
    svgs = sorted(f for f in os.listdir("port") if f.endswith(".svg"))
    assert len(svgs) == len(os.listdir("airjax")) == 4
    ET.parse(os.path.join("port", svgs[0]))
