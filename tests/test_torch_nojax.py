"""airjax_torch never imports jax or any module of the JAX package
airjax, directly or through another module: every module imports, and a
small capture decodes on the CPU, in a process whose import system
refuses both. chip_smoke.py obeys the same rule and refuses to run
without a card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

REFUSED = ("jax", "jaxlib", "airjax")

_REFUSE = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "airjax"):
            raise ImportError(f"refused here: {name}")
        return None

sys.meta_path.insert(0, Refuse())
"""

_CHILD = _REFUSE + r"""
import importlib, pkgutil

import airjax_torch
names = sorted(m.name for m in pkgutil.walk_packages(airjax_torch.__path__, "airjax_torch."))
assert "airjax_torch.kernels.block_decode" in names, names
for name in names:
    importlib.import_module(name)

import numpy as np
import torch
from airjax_torch import pipeline, runner
from airjax_torch.io import synth

frame = synth.make_df17(0x3C6586, synth.make_id_me("NOJAX01"))
iq = synth.modulate([frame, frame], [500, 19950], 40000, seed=1)
hits, stats = pipeline.decode_capture_overlap(iq, device="cpu")
assert [h[2] for h in hits] == [frame, frame], hits
got = []
runner.run_stream(iter([iq[:20000], iq[20000:]]), got.append, device="cpu")
assert [p.packet for p in got] == [frame, frame], got
mixed = synth.make_mixed_frames(1, 2)
iq = synth.modulate(mixed, [300 * (i + 1) for i in range(len(mixed))], 5000, seed=1)
got = []
runner.run_stream(iter([iq]), got.append, extended=True, device="cpu")
assert len(got) == len(mixed), got
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "airjax")]
print("modules", len(names))
"""


def _smoke_imports() -> list[str]:
    """Every module chip_smoke.py imports, at its top or inside a function."""
    names = set()
    for node in ast.walk(ast.parse((REPO / "chip_smoke.py").read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return sorted(names)


_SMOKE_CHILD = _REFUSE + r"""
import importlib
import chip_smoke

for name in NAMES:
    try:
        importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:  # `from package import function` names no module
            raise
frames = chip_smoke.make_frames(4, 0)
assert len(frames) == 4 and all(len(f) == 14 for f in frames)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "airjax")]
print("modules", len(NAMES))
"""


def test_imports_and_decodes_with_jax_refused():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_chip_smoke_loads_no_airjax_module():
    names = _smoke_imports()
    assert "airjax_torch.io.c16" in names and "torch.profiler" in names
    child = f"NAMES = {names!r}\n" + _SMOKE_CHILD
    proc = subprocess.run(
        [sys.executable, "-c", child], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == len(names)


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO).as_posix() for p in (REPO / "airjax_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_has_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in REFUSED, f"{path}: imports {name}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
