#!/usr/bin/env python3
"""Registers, spills and SASS of the planes kernel (csrc/planes.cu) in one
or more trees of the repository, on a machine with the CUDA toolkit (no
card needed):

  python3 airjax_torch/tools/planes_sass.py TREE [TREE ...]

Compiles each tree's airjax_torch/csrc/planes.cu with the build's flags
and `-Xptxas -v`, disassembles it with cuobjdump, and prints for each
instantiation (form, gate): registers, stack and spills, the kernel's
static instructions, those per offset (a thread owns 32 offsets), and its
most frequent opcodes. The kernel is unrolled, so the count is close to
a thread's issue slots, but it also holds the paths a thread of an
aligned block's interior skips: the ragged edge's byte stores, the word
by word loads at the tensor's edges and the misaligned base's half-word
stores.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from block_decode_sass import FLAGS, toolkit  # noqa: E402

FORMS = {"0": "front", "1": "tree32", "2": "tree16", "3": "flat16"}
GATES = {"0": "df17", "1": "preamble"}


def instantiation(mangled: str) -> str:
    m = re.search(r"FormE(\d)ELNS_\d+GateE(\d)E", mangled)
    return f"{FORMS[m.group(1)]}/{GATES[m.group(2)]}"


def compile_planes(tree: str, out: str) -> dict[str, str]:
    """Instantiation -> ptxas' registers, stack and spills line."""
    csrc = os.path.join(tree, "airjax_torch", "csrc")
    proc = subprocess.run([toolkit("nvcc"), *FLAGS, "-Xptxas", "-v", f"-I{csrc}", "-c", "-o", out,
                           os.path.join(csrc, "planes.cu")], capture_output=True, text=True, check=True)
    info, name = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S*planes_kernel\S*)'", line)
        if m:
            name = instantiation(m.group(1))
            info[name] = ""
        elif name and ("spill" in line or "registers" in line):
            info[name] += " " + re.sub(r"ptxas info\s*:\s*", "", line.strip())
    return info


def opcodes(obj: str) -> dict[str, list[str]]:
    """Instantiation -> its SASS opcodes, in order (any address width)."""
    sass = subprocess.run([toolkit("cuobjdump"), "-sass", obj], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = instantiation(m.group(1)) if "planes_kernel" in m.group(1) else None
            if name:
                out[name] = []
        elif name:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
            if m:
                out[name].append(m.group(1))
    return out


def main(trees: list[str]) -> int:
    for tree in trees:
        with tempfile.TemporaryDirectory() as tmp:
            obj = os.path.join(tmp, "planes.o")
            info = compile_planes(tree, obj)
            ops = opcodes(obj)
        print(f"== {tree}")
        for name in sorted(info):
            n = len(ops[name])
            top = collections.Counter(op.split(".")[0] for op in ops[name]).most_common(10)
            print(f"{name}:{info[name]}; {n} instructions, {n / 32:.1f} an offset; "
                  + ", ".join(f"{op} {c}" for op, c in top))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
