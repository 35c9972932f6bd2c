"""No call in the port passes a port-only parameter by position.

The port's reordered entry points (make_mesh, global_mesh, run_stream and
the three multihost.decode_capture* functions) take airjax's positional
parameters first, in airjax's order, and their own (`device`, `local`,
`mesh`) by keyword only. A call written for the old order, such as
`make_mesh(n, "cpu")`, would still bind: "cpu" would land on `axis` and
the mesh would be a CUDA one. So this walks every call to those functions
in airjax_torch/, chip_smoke.py and the port's tests (by AST, nothing is
imported) and fails on one that passes more positional arguments than
airjax's own parameters, or whose positional argument names a device or
a mesh (a device string, `torch.device(...)`, or a name such as `dev`,
`device`, `mesh` or `local`). airjax's own calls in the tests pass:
their positional arguments are airjax's.
"""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# The reordered functions, to the airjax module that defines each.
REORDERED = {
    "make_mesh": "airjax/parallel/mesh.py",
    "global_mesh": "airjax/parallel/multihost.py",
    "run_stream": "airjax/runner.py",
    "decode_capture": "airjax/parallel/multihost.py",
    "decode_capture_extended": "airjax/parallel/multihost.py",
    "decode_capture_extended_batched": "airjax/parallel/multihost.py",
}

# The parameters that only the port has, each keyword-only.
PORT_ONLY = ("device", "local", "mesh")

DEVICE_STRING = re.compile(r"(cpu|cuda|meta|mps)(:\d+)?")
DEVICE_NAME = re.compile(r"(?!n_)(.*_)?(dev|device|mesh|local|pm)")  # n_dev is a count


def _airjax_positional(name: str) -> list[str]:
    """airjax's positional parameters of `name`, in order."""
    tree = ast.parse((REPO / REORDERED[name]).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def _names_a_device(arg: ast.expr) -> bool:
    """Whether a positional argument is a device or a mesh: a device
    string, a torch.device(...) call, or a name or attribute called so."""
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, str) and DEVICE_STRING.fullmatch(arg.value) is not None
    if isinstance(arg, ast.Call):
        return ast.unparse(arg.func) in ("torch.device", "Mesh", "make_mesh", "mesh.make_mesh", "global_mesh")
    if isinstance(arg, ast.Name):
        return DEVICE_NAME.fullmatch(arg.id) is not None
    if isinstance(arg, ast.Attribute):
        return DEVICE_NAME.fullmatch(arg.attr) is not None
    return False


def _called(call: ast.Call) -> str | None:
    func = call.func
    name = func.id if isinstance(func, ast.Name) else func.attr if isinstance(func, ast.Attribute) else None
    return name if name in REORDERED else None


def _code(node: ast.AST) -> ast.Module | None:
    """A string constant that is Python code (a script a test runs in a
    subprocess), parsed."""
    if not (isinstance(node, ast.Constant) and isinstance(node.value, str) and "(" in node.value):
        return None
    try:
        return ast.parse(node.value)
    except SyntaxError:
        return None


def bad_calls(source: str, where: str) -> list[str]:
    """Each call in `source`, or in a string of code in it, to a reordered
    function that passes a port-only parameter by position, as
    "where:line: call"."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if (code := _code(node)) is not None:
            out += bad_calls(ast.unparse(code), f"{where}:{node.lineno} (a string)")
        if not (isinstance(node, ast.Call) and (name := _called(node))):
            continue
        allowed = _airjax_positional(name)
        starred = any(isinstance(a, ast.Starred) for a in node.args)
        slots = zip(allowed, node.args)
        if (starred or len(node.args) > len(allowed)
                or any(_names_a_device(arg) for param, arg in slots if param not in PORT_ONLY)):
            out.append(f"{where}:{node.lineno}: {ast.unparse(node)}")
    return out


FILES = sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / "airjax_torch").rglob("*.py"), REPO / "chip_smoke.py", *(REPO / "tests").glob("test_torch_*.py"),
              REPO / "tests" / "torch_multihost_worker.py"]
    if p.name != "test_torch_callsites.py"  # its own examples of old-order calls
)


@pytest.mark.parametrize("rel", ["airjax_torch", "chip_smoke.py", "tests"])
def test_no_port_only_parameter_by_position(rel):
    bad = [b for f in FILES if f == rel or f.startswith(rel + "/")
           for b in bad_calls((REPO / f).read_text(), f)]
    assert not bad, f"pass device, local and mesh by keyword: {bad}"


def test_the_walk_sees_a_positional_device():
    """The walk itself: each old-order call is reported, and airjax's
    calls and the keyword forms are not."""
    bad = """
make_mesh(1, dev)
make_mesh(n, "cpu")
mesh.make_mesh(2, torch.device("cuda"), axis="c")
global_mesh(mesh, "t")
multihost.decode_capture(local_iq, mesh, 64)
decode_capture_extended_batched(iq, tracker, local)
run_stream(blocks, cb, DEFAULT_CONFIG, True, 4, None, None, False, 1, False, False, dev)
make_mesh(*args)
"""
    good = """
make_mesh(8)
make_mesh(n_dev)
make_mesh(2, "c")
make_mesh(2, "t", device="cpu")
make_mesh(n_devices, axis, device=dev)
global_mesh("t", local=make_mesh(1, device="cpu"))
multihost.decode_capture(iq, 64)
mh.decode_capture(local_iq, 64, "t", mesh=mesh)
decode_capture_extended_batched(iq, tracker, 2048, mesh=local)
run_stream(blocks, cb, DEFAULT_CONFIG, True, 2)
run_stream(blocks, cb, DEFAULT_CONFIG, True, 4, None, None, True, device="cpu")
"""
    assert len(bad_calls(bad, "bad.py")) == len(bad.strip().splitlines())
    assert bad_calls(good, "good.py") == []
    assert bad_calls(f"run({bad!r})", "script.py") == bad_calls(f"run({good!r}, {bad!r})", "script.py") != []
    assert {f.split("/")[0] for f in FILES} == {"airjax_torch", "chip_smoke.py", "tests"}
