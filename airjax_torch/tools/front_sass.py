#!/usr/bin/env python3
"""Registers, spills and SASS of the front kernel in two trees of the
repository, on a machine with the CUDA toolkit (no card needed):

  python3 airjax_torch/tools/front_sass.py OLD_TREE NEW_TREE

Compiles each tree's airjax_torch/csrc/front.cu with the build's flags and
`-Xptxas -v`, prints each instantiation's registers, stack and spills, then
disassembles both with cuobjdump and compares each gate of OLD's
`magdet_bits_kernel` with the same gate of NEW's with every bool flag NEW
adds false (the count mode, kCount): the instruction count, and whether
the instructions are the same once addresses and constants are masked, as
tools/block_decode_sass.py does for the block-decode kernel. Exits 1 when
an instantiation differs.
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from block_decode_sass import FLAGS, functions, toolkit  # noqa: E402


def compile_front(tree: str, out: str) -> list[str]:
    csrc = os.path.join(tree, "airjax_torch", "csrc")
    proc = subprocess.run([toolkit("nvcc"), *FLAGS, "-Xptxas", "-v", f"-I{csrc}", "-c", "-o", out,
                           os.path.join(csrc, "front.cu")], capture_output=True, text=True, check=True)
    return [re.sub(r"'_ZN\S*magdet_bits_kernel", "'magdet_bits_kernel", ln.strip()) for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def kernels(obj: str) -> dict[tuple[str, tuple[str, ...]], list[str]]:
    """(gate, bool flags) -> the instructions of each magdet_bits_kernel."""
    out = {}
    for name, ins in functions(obj).items():
        if "magdet_bits_kernel" in name:
            gate = re.search(r"GateE(\d)", name).group(1)
            out[(gate, tuple(re.findall(r"Lb([01])E", name)))] = ins
    return out


def main(old: str, new: str) -> int:
    found = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate((old, new)):
            obj = os.path.join(tmp, f"{i}.o")
            print(f"== {tree}\n" + "\n".join(compile_front(tree, obj)))
            found.append(kernels(obj))
    same = True
    extra = max(len(f) for _, f in found[1]) - max(len(f) for _, f in found[0])
    for (gate, flags), ins in sorted(found[0].items()):
        mine = found[1][(gate, flags + ("0",) * extra)]
        print(f"gate {gate}{' flags ' + ','.join(flags) if flags else ''}: {old} {len(ins)} instructions, "
              f"{new} {len(mine)}; the same: {ins == mine}")
        if ins != mine:  # the first differences, to see what moved
            diff = [ln for ln in difflib.unified_diff(ins, mine, old, new, n=0, lineterm="") if ln[:1] in "+-"]
            print("\n".join(f"  {ln}" for ln in diff[2:22]))
        same &= ins == mine
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
