#!/usr/bin/env python3
"""Registers, spills and SASS of the block-decode kernel in two trees of
the repository, on a machine with the CUDA toolkit:

  python3 airjax_torch/tools/block_decode_sass.py OLD_TREE NEW_TREE

Compiles each tree's airjax_torch/csrc/block_decode.cu with the build's
flags (airjax_torch._build.NVCC_FLAGS) and `-Xptxas -v`, prints each
instantiation's registers, stack and spills, then disassembles both with
cuobjdump and compares each mode of OLD with the same mode of NEW without
recover2 and without fields (R2 = false and F = false, where a tree has
the flags): the instruction count, and whether the instructions are the
same once addresses and constants are masked.
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def toolkit(name: str) -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", name)):
            return os.path.join(root, "bin", name)
    return name


def compile_tree(tree: str, out: str) -> str:
    csrc = os.path.join(tree, "airjax_torch", "csrc")
    proc = subprocess.run([toolkit("nvcc"), *FLAGS, "-Xptxas", "-v", f"-I{csrc}", "-c", "-o", out,
                           os.path.join(csrc, "block_decode.cu")], capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return "\n".join(re.sub(r"'_ZN\S*block_decode_kernel", "'block_decode_kernel", ln) for ln in lines)


def functions(obj: str) -> dict[str, list[str]]:
    sass = subprocess.run([toolkit("cuobjdump"), "-sass", obj], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip()
            out[name].append(re.sub(r"0x[0-9a-f]+", "X", ins))
    return out


def main(old: str, new: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        objs = [os.path.join(tmp, "old.o"), os.path.join(tmp, "new.o")]
        for tree, obj in zip((old, new), objs):
            print(f"== {tree}\n{compile_tree(tree, obj)}")
        a, b = functions(objs[0]), functions(objs[1])
    for mode in (0, 1):
        fa, fb = mode_without_flags(a, mode), mode_without_flags(b, mode)
        print(f"mode {mode}: {old} {len(fa)} instructions, {new} {len(fb)}; the same: {fa == fb}")
        if fa != fb:  # the first differences, to see what moved
            diff = [ln for ln in difflib.unified_diff(fa, fb, old, new, n=0, lineterm="") if ln[:1] in "+-"]
            print("\n".join(f"  {ln}" for ln in diff[2:22]))
    return 0


def mode_without_flags(funcs: dict[str, list[str]], mode: int) -> list[str]:
    """The instantiation of `mode` (Mode::kDf17 = 0, kExtended = 1) with
    every bool flag the kernel has (R2, then F; mangled `Lb0` each) false."""
    names = [k for k in funcs if "block_decode_kernel" in k and f"ModeE{mode}E" in k]
    flags = max(len(re.findall(r"Lb[01]", k)) for k in names)
    (name,) = [k for k in names if f"ModeE{mode}E" + "Lb0E" * flags in k]
    return funcs[name]


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
