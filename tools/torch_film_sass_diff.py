#!/usr/bin/env python3
"""Compare the SASS of csrc/film_mlp.cu's kernels between this tree and
another checkout (for example the parent commit's, from `git archive`).

Builds both trees' csrc/film_mlp.cu with this tree's nvcc flags (two nvcc,
started together, into a temporary directory), disassembles each library
with cuobjdump and compares every kernel of the other tree with the kernels
of this tree that have the same name, instruction by instruction (addresses
and encodings dropped).  A kernel of the other tree passes when one of this
tree's kernels of its name has the same instructions: a kernel that became a
template passes when one instantiation compiles to the code it had.  Needs
nvcc and cuobjdump, not a GPU.

Usage: python3 tools/torch_film_sass_diff.py <other_checkout>
Prints one line per kernel of the other tree and a JSON summary as the last
line; exits 1 when a kernel has no match.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join("msra_practice_project_tpu_torch", "ops", "kernels",
                    "csrc")


def base_name(mangled: str) -> str:
    """The unqualified name of a mangled function: the last <length><id> of
    its nested name (`_ZN12_GLOBAL__N_118film_fwd_tc_kernelILb0EE...` ->
    film_fwd_tc_kernel), or the name itself when it is not mangled."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, base = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        base, i = mangled[j:j + n], j + n
    return base


def functions(sass: str) -> dict:
    """{mangled name: [instruction text]} of a cuobjdump -sass listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return out


def build_sass(trees, tmp) -> list:
    """cuobjdump -sass of each tree's film_mlp.cu, built with this tree's
    flags."""
    import chip_smoke as cs
    from msra_practice_project_tpu_torch.ops.kernels import build

    jobs = []
    for k, tree in enumerate(trees):
        lib = os.path.join(tmp, f"libfilm_mlp_{k}.so")
        jobs.append((lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(tree, CSRC, "film_mlp.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cuobjdump = cs.cuda_tool("cuobjdump")
    if not cuobjdump:
        raise SystemExit("cuobjdump not found")
    out = []
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed:\n{log}")
        out.append(subprocess.run([cuobjdump, "-sass", lib], check=True,
                                  capture_output=True, text=True,
                                  timeout=300).stdout)
    return out


def compare(other: dict, this: dict) -> dict:
    """{other tree's kernel: the name of this tree's kernel with the same
    base name and instructions, or None}."""
    return {name: next((n for n, code in this.items()
                        if base_name(n) == base_name(name) and code == ins),
                       None)
            for name, ins in other.items()}


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__.split("Usage: ")[1].split("\n")[0], file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="film_sass_") as tmp:
        other_sass, this_sass = build_sass([argv[0], ROOT], tmp)
    other, this = functions(other_sass), functions(this_sass)
    match = compare(other, this)
    for name, got in match.items():
        print(f"  {base_name(name)} ({len(other[name])} instructions): "
              f"{'same as ' + got if got else 'NO MATCH'}", flush=True)
    print(json.dumps({"kernels": len(match),
                      "matched": sum(v is not None for v in match.values()),
                      "this_tree_kernels": len(this),
                      "unmatched": [k for k, v in match.items()
                                    if v is None]}))
    return 0 if all(match.values()) and match else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
