"""The port's names held to airjax's, by AST (neither package is imported).

For every module of airjax/, the port module of the same path under
airjax_torch/ must define each public top-level name; each public class's
fields, class attributes, properties, public methods and `__init__`; and,
for each public function and method, accept every parameter of airjax's
(by name; the port may add its own, such as the keyword-only `device`).
The only exceptions are NOT_PORTED's, each with its reason; a second test
holds every exception to airjax and to the port, so the list cannot go
stale.
"""

import ast
import functools
import pathlib

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

MODULES = sorted(p.relative_to(AIRJAX).as_posix() for p in AIRJAX.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _defs(body: list[ast.stmt]) -> dict[str, ast.AST]:
    """The names a module or class body binds, to their nodes (through
    top-level if/try blocks; imports bind names too)."""
    out: dict[str, ast.AST] = {}
    for node in body:
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


def _gaps(rel: str, port_defs: dict[str, ast.AST] | None = None) -> list[str]:
    """Every airjax name, member and parameter of module `rel` that the
    port module of the same path (or one binding `port_defs`) lacks, as
    NOT_PORTED keys."""
    key = f"airjax/{rel}::"
    if port_defs is None and not (PORT / rel).exists():
        return [f"airjax/{rel} (no port module)"]
    gaps = []
    for name, node in _module_defs(AIRJAX, rel).items():
        if not _public(name) or isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        port = _port_def(rel, name, port_defs)
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
                    gaps += _missing_params(f"{key}{name}.{member}", sub, port_members[member])
        else:
            gaps += _missing_params(key + name, node, port)
    return gaps


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_has_airjax_names(rel):
    unexplained = [g for g in _gaps(rel) if g not in NOT_PORTED]
    assert not unexplained, f"airjax names with no counterpart in airjax_torch/{rel}: {unexplained}"


def test_not_ported_entries_are_current():
    """Each exception still names something of airjax that the port still
    lacks."""
    gaps = {g for rel in MODULES for g in _gaps(rel)}
    for key in NOT_PORTED:
        path, name = key.split("::")
        assert (REPO / path).is_file(), key
        top = name.split("(")[0].split(".")[0]
        assert top in _module_defs(AIRJAX, path.removeprefix("airjax/")), f"{key}: no longer in airjax"
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
