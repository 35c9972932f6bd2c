"""The port's names held to airjax's, by AST (neither package is imported).

For every module of airjax/, the port module of the same path under
airjax_torch/ must define each public top-level name; each public class's
fields, class attributes, properties, public methods and `__init__`; and,
for each public function and method, accept every parameter of airjax's
(by name; the port may add its own, such as the keyword-only `device`).
The only exceptions are NOT_PORTED's, each with its reason; a second test
holds every exception to airjax and to the port, so the list cannot go
stale. The JAX system's measuring harness outside the package (bench.py,
__graft_entry__.py and five root tools) is held the same way to its twin
in the port (HARNESS). Every root tool (tools/*.py) has a twin in the port
(ROOT_TWINS): a port file that exists, or the chip_smoke.py phase that
stands in for it.

A call written for airjax must also mean the same on the port: for each
public function and method, airjax's positional parameters (less
NOT_PORTED's) are a prefix of the port's, every parameter only the port
has takes a default, and every default of airjax's is the port's too, as
source text. The only exceptions are SIGNATURES_DIFFER's, whose order and
own parameters may differ (their defaults may not).
"""

import ast
import functools
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
AIRJAX = REPO / "airjax"
PORT = REPO / "airjax_torch"

NOT_PORTED = {
    "airjax/kernels/magdet.py::LANES": "the TPU's lane count; the TPU tile geometry is not ported (ROADMAP B5): "
                                       "the Hopper kernels take any length",
    "airjax/kernels/magdet.py::TILE_ROWS": "the TPU tile's rows (B5); the port's kernels/magdet.py TILE is the "
                                           "front's count tile",
    "airjax/kernels/magdet.py::EXTRA_ROWS": "the TPU's lookahead rows (B5); the Hopper front reads past its tile "
                                            "directly",
    "airjax/kernels/magdet.py::EXTRA": "the TPU's lookahead (B5); see EXTRA_ROWS",
    "airjax/kernels/magdet.py::pad_for_kernel": "pads to the TPU tile geometry (B5); the port's fronts take any "
                                                "length, and pipeline.decode_iq_block_kernel takes its output as is",
    "airjax/kernels/magdet.py::magdet_fused": "ported as the planes mode of kernels/magdet.py::magdet "
                                              "(csrc/planes.cu), its docstring says so",
    "airjax/kernels/magdet.py::magdet_packed": "ported as the packed mode of kernels/magdet.py::magdet and, redesigned, "
                                               "as kernels/magdet.py::magdet_bits (csrc/front.cu)",
    "airjax/kernels/stencil3.py::magdet_tree(interpret)": "Pallas interpret mode has no CUDA meaning; on the CPU "
                                                          "the port runs magdet_tree_plain",
    "airjax/pipeline.py::decode_iq_block_kernel(interpret)": "the same as magdet_tree's: Pallas interpret mode has "
                                                             "no CUDA meaning; on the CPU the kernels' plain versions "
                                                             "run",
    "airjax/parallel/mesh.py::time_sharding": "a jax NamedSharding; the port places shards by hand (halo.shard_iq)",
    "airjax/parallel/mesh.py::replicated": "a jax NamedSharding; the port keeps the gathered buffer on the mesh's "
                                           "first device (kernels/shard_gather.py)",
}

# The functions whose positional parameters may differ from airjax's, each
# with its reason; airjax's defaults still hold.
SIGNATURES_DIFFER = {
    "airjax/kernels/stencil3.py::magdet_tree": "the port takes unpadded IQ and its n_off second (required), where "
                                               "airjax takes IQ padded to the TPU tile geometry (B5)",
}

MODULES = sorted(p.relative_to(AIRJAX).as_posix() for p in AIRJAX.rglob("*.py"))

# The harness files of the repository's root, to their twins under airjax_torch/.
HARNESS = {
    "bench.py": "bench.py",
    "__graft_entry__.py": "graft_entry.py",
    "tools/bench_extended_tpu.py": "tools/bench_extended.py",
    "tools/bench_stream.py": "tools/bench_stream.py",
    "tools/bench_host.py": "tools/bench_host.py",
    "tools/scaling_sweep.py": "tools/scaling_sweep.py",
    "tools/bench_stages.py": "tools/bench_stages.py",
}

# Every root tool (tools/*.py) to its twins: files of the port, or phases of
# chip_smoke.py ("chip_smoke.py phase N"). The XLA-variant A/Bs map to the
# A/B tools of the Hopper kernels that replaced the variants they timed.
ROOT_TWINS = {
    "tools/bench_compact.py": ("airjax_torch/tools/ab_block_decode.py", "chip_smoke.py phase 5"),
    "tools/bench_count.py": ("airjax_torch/tools/ab_block_decode.py", "chip_smoke.py phase 5"),
    "tools/bench_extended_tpu.py": ("airjax_torch/tools/bench_extended.py",),
    "tools/bench_fused.py": ("airjax_torch/tools/ab_planes.py", "chip_smoke.py phase 5"),
    "tools/bench_host.py": ("airjax_torch/tools/bench_host.py",),
    "tools/bench_pack.py": ("airjax_torch/tools/ab_block_decode.py", "chip_smoke.py phase 5"),
    "tools/bench_r2.py": ("airjax_torch/tools/ab_block_decode.py", "chip_smoke.py phase 5"),
    "tools/bench_shard_shapes.py": ("airjax_torch/tools/ab_shard_gather.py",
                                    "airjax_torch/tools/ab_sharded_stream.py"),
    "tools/bench_stages.py": ("airjax_torch/tools/bench_stages.py", "chip_smoke.py phase 19"),
    "tools/bench_stencil3.py": ("airjax_torch/tools/ab_planes.py", "chip_smoke.py phase 5"),
    "tools/bench_stream.py": ("airjax_torch/tools/bench_stream.py",),
    "tools/bench_variants.py": ("airjax_torch/tools/ab_block_decode.py", "chip_smoke.py phase 5"),
    "tools/fuzz_extended.py": ("airjax_torch/tools/fuzz_extended.py",),
    "tools/fuzz_parity.py": ("airjax_torch/tools/fuzz_parity.py",),
    "tools/replay_analytics.py": ("airjax_torch/tools/replay_analytics.py",),
    "tools/scaling_sweep.py": ("airjax_torch/tools/scaling_sweep.py",),
    "tools/snr_sweep.py": ("airjax_torch/tools/snr_sweep.py",),
    "tools/soak.py": ("airjax_torch/tools/soak.py",),
    "tools/tpu_recover2_smoke.py": ("chip_smoke.py phase 3", "chip_smoke.py phase 9"),
    "tools/tpu_shard_smoke.py": ("chip_smoke.py phase 6", "chip_smoke.py phase 11"),
    "tools/tpu_stream_smoke.py": ("chip_smoke.py phase 6", "chip_smoke.py phase 11"),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _is_main_block(node: ast.stmt) -> bool:
    """`if __name__ == "__main__":`, whose names are a script's locals."""
    test = node.test if isinstance(node, ast.If) else None
    return (isinstance(test, ast.Compare) and isinstance(test.left, ast.Name) and test.left.id == "__name__"
            and any(isinstance(c, ast.Constant) and c.value == "__main__" for c in test.comparators))


def _defs(body: list[ast.stmt]) -> dict[str, ast.AST]:
    """The names a module or class body binds, to their nodes (through
    top-level if/try blocks but a script's `__main__` block; imports bind
    names too)."""
    out: dict[str, ast.AST] = {}
    for node in body:
        if _is_main_block(node):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                out.update((n.id, node) for n in ast.walk(target) if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.setdefault((alias.asname or alias.name).split(".")[0], node)
        elif isinstance(node, (ast.If, ast.Try)):
            for block in (node.body, node.orelse, getattr(node, "finalbody", []),
                          *(h.body for h in getattr(node, "handlers", []))):
                for name, sub in _defs(block).items():
                    out.setdefault(name, sub)
    return out


@functools.cache
def _module_defs(root: pathlib.Path, rel: str) -> dict[str, ast.AST]:
    return _defs(ast.parse((root / rel).read_text()).body)


def _port_def(rel: str, name: str, defs: dict[str, ast.AST] | None = None, depth: int = 0) -> ast.AST | None:
    """The port's definition of `name` in module `rel` (whose names are
    `defs`, by default the file's), following a `from airjax_torch.x
    import name` to its module."""
    node = (_module_defs(PORT, rel) if defs is None else defs).get(name)
    if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("airjax_torch.") and depth < 4:
        alias = next(a for a in node.names if (a.asname or a.name) == name)
        target = node.module.removeprefix("airjax_torch.").replace(".", "/")
        for cand in (f"{target}.py", f"{target}/__init__.py"):
            if (PORT / cand).exists():
                return _port_def(cand, alias.name, depth=depth + 1) or node
    return node


def _params(fn: ast.FunctionDef) -> tuple[list[str], bool]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs], a.kwarg is not None


def _missing_params(where: str, ours: ast.AST, port: ast.AST) -> list[str]:
    if not isinstance(ours, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    if not isinstance(port, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return [f"{where} (the port's is not a function)"]
    names, _ = _params(ours)
    port_names, port_kwargs = _params(port)
    return [f"{where}({p})" for p in names if p not in port_names and not port_kwargs]


def _signature(fn: ast.FunctionDef) -> tuple[list[str], list[str], dict[str, str]]:
    """(positional parameters, keyword-only ones, {parameter: its default's source})."""
    a = fn.args
    positional = a.posonlyargs + a.args
    defaults = {p.arg: ast.unparse(d) for p, d in zip(positional[len(positional) - len(a.defaults):], a.defaults)}
    defaults |= {p.arg: ast.unparse(d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None}
    return [p.arg for p in positional], [p.arg for p in a.kwonlyargs], defaults


def _signature_faults(where: str, ours: ast.AST, port: ast.AST) -> list[str]:
    """Where a call valid for airjax's signature would bind otherwise on
    the port's, or raise: airjax's positional parameters (less
    NOT_PORTED's) not a prefix of the port's, a parameter only the port
    has with no default, a default of airjax's the port lacks or changes."""
    if not all(isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) for f in (ours, port)):
        return []  # a gap of _missing_params's
    positional, keyword, defaults = _signature(ours)
    port_positional, port_keyword, port_defaults = _signature(port)
    positional = [p for p in positional if f"{where}({p})" not in NOT_PORTED]
    faults = [] if port_positional[:len(positional)] == positional else [
        f"{where} (positional: airjax's {positional}, the port's {port_positional})"]
    faults += [f"{where}({p}) (only the port's, with no default)" for p in port_positional + port_keyword
               if p not in positional + keyword and p not in port_defaults and f"{where}({p})" not in NOT_PORTED]
    faults += [f"{where}({p}) (airjax's default {d}, the port's {port_defaults.get(p)})" for p, d in defaults.items()
               if p in port_positional + port_keyword and port_defaults.get(p) != d]
    return faults


def _gaps(rel: str, port_defs: dict[str, ast.AST] | None = None, root: pathlib.Path = AIRJAX,
          port_rel: str | None = None, check=_missing_params) -> list[str]:
    """Every name, member and parameter of module `rel` under `root`
    (airjax/ unless given) that the port module `port_rel` (by default of
    the same path under airjax_torch/; or one binding `port_defs`) lacks,
    as NOT_PORTED keys; with check=_signature_faults, also each function's
    signature faults."""
    port_rel = port_rel or rel
    key = f"{(root / rel).relative_to(REPO).as_posix()}::"
    if port_defs is None and not (PORT / port_rel).exists():
        return [f"{key[:-2]} (no port module)"]
    gaps = []
    for name, node in _module_defs(root, rel).items():
        if not _public(name) or isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        port = _port_def(port_rel, name, port_defs)
        if port is None:
            gaps.append(key + name)
        elif isinstance(node, ast.ClassDef):
            if not isinstance(port, ast.ClassDef):
                gaps.append(f"{key}{name} (the port's is not a class)")
                continue
            port_members = _defs(port.body)
            for member, sub in _defs(node.body).items():
                if not (_public(member) or member == "__init__") or isinstance(sub, (ast.Import, ast.ImportFrom)):
                    continue
                if member not in port_members:
                    gaps.append(f"{key}{name}.{member}")
                else:
                    gaps += check(f"{key}{name}.{member}", sub, port_members[member])
        else:
            gaps += check(key + name, node, port)
    return gaps


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_has_airjax_names(rel):
    unexplained = [g for g in _gaps(rel) if g not in NOT_PORTED]
    assert not unexplained, f"airjax names with no counterpart in airjax_torch/{rel}: {unexplained}"


@pytest.mark.parametrize("theirs", sorted(HARNESS))
def test_harness_twin_has_the_names(theirs):
    unexplained = [g for g in _gaps(theirs, root=REPO, port_rel=HARNESS[theirs]) if g not in NOT_PORTED]
    assert not unexplained, f"names of {theirs} with no counterpart in airjax_torch/{HARNESS[theirs]}: {unexplained}"


def _excused_by(fault: str) -> str | None:
    """The SIGNATURES_DIFFER key that excuses a fault of order or of the
    port's own parameters; a changed default is never excused."""
    key = fault.split(" (")[0].split("(")[0]
    return key if "(airjax's default " not in fault else None


def _signature_gaps(rel: str, root: pathlib.Path = AIRJAX, port_rel: str | None = None) -> list[str]:
    """The signature faults of module `rel` but SIGNATURES_DIFFER's (its
    missing names are the name tests')."""
    return [g for g in _gaps(rel, root=root, port_rel=port_rel, check=_signature_faults)
            if g not in NOT_PORTED and _excused_by(g) not in SIGNATURES_DIFFER]


@pytest.mark.parametrize("where", [*MODULES, *(f"harness:{h}" for h in sorted(HARNESS))])
def test_airjax_calls_bind_the_same_on_the_port(where):
    theirs = where.removeprefix("harness:")
    faults = (_signature_gaps(theirs, root=REPO, port_rel=HARNESS[theirs]) if where.startswith("harness:")
              else _signature_gaps(where))
    assert not faults, f"calls written for airjax would bind otherwise on the port: {faults}"


def test_the_signature_walk_sees_a_fault():
    """The walk itself: a port-only parameter before airjax's, one with no
    default, a changed default and a dropped one are each reported; the
    port's own keyword-only parameters with defaults are not."""
    ours = ast.parse("def f(a, b=1, c='t'): pass").body[0]

    def faults(port_src):
        return _signature_faults("m.py::f", ours, ast.parse(port_src).body[0])

    assert faults("def f(a, b=1, c='t', *, device='cuda'): pass") == []
    assert faults("def f(a, device='cuda', b=1, c='t'): pass") == [
        "m.py::f (positional: airjax's ['a', 'b', 'c'], the port's ['a', 'device', 'b', 'c'])"]
    assert faults("def f(a, b=1, c='t', *, device): pass") == ["m.py::f(device) (only the port's, with no default)"]
    assert faults("def f(a, b=1, c='u'): pass") == ["m.py::f(c) (airjax's default 't', the port's 'u')"]
    assert faults("def f(a, b, c='t'): pass") == ["m.py::f(b) (airjax's default 1, the port's None)"]
    # Through the module walk: the port's make_mesh as it was, device before axis.
    mesh = {**_module_defs(PORT, "parallel/mesh.py"), "make_mesh": ast.parse(
        "def make_mesh(n_devices=None, device='cuda', axis=TIME_AXIS): pass").body[0]}
    assert _gaps("parallel/mesh.py", mesh, check=_signature_faults) == [
        "airjax/parallel/mesh.py::make_mesh (positional: airjax's ['n_devices', 'axis'], "
        "the port's ['n_devices', 'device', 'axis'])",
        *(g for g in NOT_PORTED if g.startswith("airjax/parallel/mesh.py::"))]


def test_signature_exceptions_are_current():
    """Each exception still names a function of airjax whose port
    signature differs from it."""
    faults = {_excused_by(g) for rel in MODULES for g in _gaps(rel, check=_signature_faults) if g not in NOT_PORTED}
    assert set(SIGNATURES_DIFFER) == faults - {None}


def _smoke_phases() -> set[int]:
    """The phases chip_smoke.py's docstring lists ("  N. ..." lines)."""
    doc = ast.get_docstring(ast.parse((REPO / "chip_smoke.py").read_text()))
    return {int(n) for n in re.findall(r"^ {0,2}(\d+)\. ", doc, flags=re.M)}


def _untwinned(root_tools: list[str], twins: dict[str, tuple[str, ...]]) -> list[str]:
    """The root tools with no entry in `twins`, and the entries whose twin
    is neither a file of the repository nor a phase chip_smoke.py lists."""
    phases = _smoke_phases()
    gaps = [tool for tool in root_tools if not twins.get(tool)]
    for tool, targets in twins.items():
        for target in targets:
            phase = re.fullmatch(r"chip_smoke\.py phase (\d+)", target)
            if not (int(phase[1]) in phases if phase else (REPO / target).is_file()):
                gaps.append(f"{tool} -> {target}")
    return gaps


ROOT_TOOLS = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "tools").glob("*.py"))


def test_every_root_tool_has_a_twin():
    assert not _untwinned(ROOT_TOOLS, ROOT_TWINS), "root tools with no twin in the port: add them to ROOT_TWINS"
    assert set(ROOT_TWINS) == set(ROOT_TOOLS), "ROOT_TWINS names a root tool that is gone"
    for theirs, port_rel in HARNESS.items():  # the harness's twins are the same files
        assert theirs not in ROOT_TWINS or f"airjax_torch/{port_rel}" in ROOT_TWINS[theirs]


def test_the_root_walk_sees_a_tool_without_a_twin():
    """A made-up root tool with no entry, and entries whose twin is a
    missing file or a phase chip_smoke.py does not list, are reported."""
    made_up = [*ROOT_TOOLS, "tools/bench_made_up.py"]
    assert _untwinned(made_up, ROOT_TWINS) == ["tools/bench_made_up.py"]
    twins = {**ROOT_TWINS, "tools/soak.py": ("airjax_torch/tools/no_such_tool.py",),
             "tools/bench_stages.py": ("chip_smoke.py phase 99",)}
    assert sorted(_untwinned(ROOT_TOOLS, twins)) == ["tools/bench_stages.py -> chip_smoke.py phase 99",
                                                    "tools/soak.py -> airjax_torch/tools/no_such_tool.py"]
    assert {1, 18} <= _smoke_phases()


def test_not_ported_entries_are_current():
    """Each exception still names something of airjax that the port still
    lacks."""
    gaps = {g for rel in MODULES for g in _gaps(rel)}
    gaps |= {g for rel, port_rel in HARNESS.items() for g in _gaps(rel, root=REPO, port_rel=port_rel)}
    for key in NOT_PORTED:
        path, name = key.split("::")
        assert (REPO / path).is_file(), key
        top = name.split("(")[0].split(".")[0]
        assert top in _module_defs(REPO, path), f"{key}: no longer in {path}"
        assert key in gaps, f"{key}: the port has it now; drop the exception"
    assert set(NOT_PORTED) == gaps


def test_the_walk_sees_a_gap():
    """The walk itself: a name, a class field and a parameter that a port
    module lacks are each reported."""
    config = dict(_module_defs(PORT, "config.py"))
    del config["DEFAULT_CONFIG"]
    cls = config["PipelineConfig"]
    config["PipelineConfig"] = ast.ClassDef(
        name=cls.name, bases=cls.bases, keywords=cls.keywords, decorator_list=cls.decorator_list,
        body=[n for n in cls.body if not (isinstance(n, ast.AnnAssign) and n.target.id == "gain_db")])
    assert sorted(_gaps("config.py", config)) == ["airjax/config.py::DEFAULT_CONFIG",
                                                  "airjax/config.py::PipelineConfig.gain_db"]
    demod = {**_module_defs(PORT, "dsp/demod.py"),
             "compact_detections": ast.parse("def compact_detections(det, max_candidates): pass").body[0]}
    assert _gaps("dsp/demod.py", demod) == ["airjax/dsp/demod.py::compact_detections(tile)"]
    assert _gaps("config.py") == []
