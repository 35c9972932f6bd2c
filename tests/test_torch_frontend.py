"""The web frontend's Python mirrors in the port against airjax: the
projection (airjax_torch/ui/projection.py) and the port's shipped
projection.js, run through tests/js_subset.py, against airjax's mirror over
a grid; the bindings generator (airjax_torch/ui/bindings_gen.py) against
the committed bindings/*.ts and the port's to_json keys. Nothing here
writes to bindings/."""

import math
import pathlib
import subprocess
import sys

import pytest

from airjax.ui import bindings_gen as jbindings_gen
from airjax.ui import projection as jprojection
from airjax_torch.track.aircraft import Aircraft
from airjax_torch.ui import bindings_gen, projection
from tests.js_subset import transpile_js

REPO = pathlib.Path(__file__).resolve().parent.parent
STATIC = REPO / "airjax_torch" / "ui" / "static"

# (lat1, lon1, lat2, lon2): Wellington-area radar range, the equator, the
# antimeridian, a high latitude, long range, a few metres.
GRID = [
    (-41.3272, 174.8053, -41.3272, 174.8053),
    (-41.3272, 174.8053, -41.28965, 174.80927),
    (-41.3272, 174.8053, -37.0082, 174.7850),
    (-41.3272, 174.8053, -43.4876, 172.5374),
    (0.0, 0.0, 0.0, 1.0),
    (0.0, 0.0, 1.0, 0.0),
    (0.0, 179.9, 0.0, -179.9),
    (87.0, 10.0, 86.5, -170.0),
    (52.2572, 3.91937, -41.28965, 174.80927),
    (-41.0, 174.0, -41.0001, 174.0001),
]


@pytest.fixture(scope="module")
def js_funcs():
    namespace = {"math": math}
    exec(transpile_js((STATIC / "projection.js").read_text()), namespace)  # noqa: S102 - the repo's own file
    return namespace


@pytest.mark.parametrize("case", GRID)
def test_projection_equals_airjax_and_the_ports_js(js_funcs, case):
    lat1, lon1, lat2, lon2 = case
    view = (640.0, 360.0, 0.003)
    for name, js, args in (("geo_distance", "geoDistance", case), ("geo_bearing", "geoBearing", case),
                           ("get_xy", "getXY", (lat1, lon1, *view, lat2, lon2)),
                           ("check_visible", "checkVisible", (lat1, lon1, *view, lat2, lon2))):
        ours = getattr(projection, name)(*args)
        assert ours == getattr(jprojection, name)(*args), name  # the same arithmetic, bit for bit
        theirs = js_funcs[js](*args)
        if name == "check_visible":
            assert bool(theirs) == ours
        else:
            assert theirs == pytest.approx(ours, abs=1e-9, rel=1e-12), name
    assert projection.recenter(1281, 721) == jprojection.recenter(1281, 721) == (640, 360)


def test_bindings_are_the_committed_files_and_the_ports_keys():
    files = bindings_gen.generated_files()
    assert files == jbindings_gen.generated_files()
    for name, text in files.items():
        assert (REPO / "bindings" / name).read_text() == text, name
    for extended in (False, True):
        keys = set(Aircraft(0x123456).get_summary().to_json(extended=extended))
        assert bindings_gen.schema_keys(extended) == keys == jbindings_gen.schema_keys(extended)


def test_bindings_check_command():
    before = {p.name: p.read_bytes() for p in (REPO / "bindings").iterdir()}
    proc = subprocess.run([sys.executable, "-m", "airjax_torch.ui.bindings_gen", "--check"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.count("ok: ") == 3, proc.stderr
    assert {p.name: p.read_bytes() for p in (REPO / "bindings").iterdir()} == before
