"""airjax_torch never imports jax or any module of the JAX package
airjax or of its root tools (tools/), directly or through another module:
every module imports, and a small capture decodes on the CPU, in a process
whose import system refuses them. chip_smoke.py obeys the same rule and refuses to run
without a card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

REFUSED = ("jax", "jaxlib", "airjax", "tools")

_REFUSE = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "airjax", "tools"):
            raise ImportError(f"refused here: {name}")
        return None

sys.meta_path.insert(0, Refuse())
"""

_CHILD = _REFUSE + r"""
import importlib, pkgutil

import airjax_torch
names = sorted(m.name for m in pkgutil.walk_packages(airjax_torch.__path__, "airjax_torch."))
for name in ("airjax_torch.kernels.block_decode", "airjax_torch.kernels.fields", "airjax_torch.track.batch",
             "airjax_torch.track.state", "airjax_torch.ui.tui", "airjax_torch.ui.web",
             "airjax_torch.kernels.shard_gather", "airjax_torch.parallel.mesh", "airjax_torch.parallel.halo",
             "airjax_torch.parallel.channels", "airjax_torch.analytics", "airjax_torch.parallel.multihost",
             "airjax_torch.golden", "airjax_torch.visualise", "airjax_torch.observability",
             "airjax_torch.native", "airjax_torch.sdr", "airjax_torch.ui.projection", "airjax_torch.ui.bindings_gen",
             "airjax_torch.tools.fuzz_parity", "airjax_torch.tools.fuzz_extended", "airjax_torch.tools.soak",
             "airjax_torch.tools.dryrun_multichip", "airjax_torch.tools.snr_sweep", "airjax_torch.tools.bench_stages"):
    assert name in names, names
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
from airjax_torch.track.batch import ExtendedBatchTracker
from airjax_torch.ui import web
tracker = ExtendedBatchTracker()
stats = runner.run_stream(iter([iq]), tracker, extended=True, device="cpu", recover2=True)
assert tracker.n_messages == len(mixed) and len(tracker.aircrafts) == 1, stats.as_dict()
assert (web._STATIC_DIR / "index.html").is_file() and "airjax_torch" in str(web._STATIC_DIR)
from airjax_torch import analytics
from airjax_torch.parallel import halo
from airjax_torch.parallel.mesh import make_mesh
hits, _ = halo.decode_capture_sharded(synth.modulate([frame] * 2, [500, 3900], 8000, seed=1),
                                     make_mesh(2, device="cpu"))
assert [h[1] for h in hits] == [500, 3900], hits
tracks, _ = analytics.analyze_capture_extended(iq, devices=2, device="cpu")
assert len(tracks) == 1, tracks
got = []
runner.run_stream_sharded(iter([iq]), got.append, n_devices=2, extended=True, device="cpu")
assert len(got) == len(mixed), got
from airjax_torch import golden, observability, visualise
from airjax_torch.parallel import multihost
hits, stats = multihost.decode_capture(synth.modulate([frame] * 2, [500, 3900], 8000, seed=1),
                                        mesh=make_mesh(2, device="cpu"))
assert [h[1] for h in hits] == [500, 3900] and stats["processes"] == 1, (hits, stats)
iq = synth.modulate([frame], [300], 9000, seed=2)
from airjax_torch.config import PipelineConfig
parity, _ = pipeline.decode_capture_parity(iq, PipelineConfig(block_len=4000), fused=False, device="cpu")
assert [(c, o, f) for c, o, f, _ in parity] == golden.decode_capture_playback(iq, chunk=4000) == [(0, 300, frame)]
assert "preamble @ 7" in visualise.dump_preamble(golden.magnitude(iq[:16]), offset=7)
from airjax_torch import native
assert native.decode_chunk(iq[:4000])[0] == [(300, frame, False)]
ring = native.Ring(100, 2)
assert ring.push(iq[:100]) and ring.pop().shape == (100, 2) and ring.pop() is None
got = []
runner.run_stream(iter([iq[:4000], iq[4000:]]), got.append, device="cpu", pipeline_depth=2, prefetch_depth=1)
assert [p.packet for p in got] == [frame], got
from airjax_torch.ui import bindings_gen, projection
assert len(bindings_gen.generated_files()) == 3 and projection.recenter(10, 10) == (5, 5)
with observability.trace("/dev/null", enabled=False):
    pass
dev_iq = synth.modulate_device([frame], [300], 4000, device="cpu").numpy()
assert [h[2] for h in pipeline.decode_capture_overlap(dev_iq, device="cpu")[0]] == [frame]
from airjax_torch.tools import snr_sweep
assert snr_sweep.sweep(snrs_db=(20.0,), captures_per_snr=1, device="cpu")["curve"][0]["decode_rate"] == 1.0
from airjax_torch.tools import bench_stages
stage_iq = bench_stages.build_iq(block_len=1 << 15, device="cpu")
assert [int(x) for x in bench_stages.full_body(stage_iq, (1 << 15) - 240, 64)] == [2, 2]
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "airjax", "tools")]
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
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "airjax", "tools")]
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
