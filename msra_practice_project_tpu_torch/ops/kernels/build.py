"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for Hopper (``sm_90a``) into a shared library that ``ctypes`` loads, at first
use, into ``build/`` beside this file.  The library's file name carries a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  ``load_all``
starts one ``nvcc`` per missing library, all at once, and keeps each
compiler's output (ptxas' resource usage per kernel, ``-Xptxas -v``) beside
the library; ``ptxas_usage`` reads it.

Not built with ``--use_fast_math``: the NeRF positional encoding feeds sines
with arguments up to ~2^9 |x| (thousands of radians), where the fast
intrinsics are badly off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_LIBS: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def load_all(names) -> list:
    """The loaded libraries for ``csrc/<name>.cu``, one per name; the missing
    ones are built first, one ``nvcc`` each, all started together."""
    todo = [n for n in names
            if n not in _LIBS and not os.path.exists(_lib_path(n))]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = []
        for n in todo:
            tmp = f"{_lib_path(n)}.{os.getpid()}.tmp"
            jobs.append((n, tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, n + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for n, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu:\n{out}")
            else:
                with open(_lib_path(n) + ".log", "w") as f:
                    f.write(out)
                os.replace(tmp, _lib_path(n))
        if failed:
            raise RuntimeError("\n".join(failed))
    for n in names:
        if n not in _LIBS:
            _LIBS[n] = ctypes.CDLL(_lib_path(n))
    return [_LIBS[n] for n in names]


def ptxas_usage(name: str) -> dict:
    """{mangled kernel name: {registers, stack_frame, spill_stores,
    spill_loads}} from the compiler output of ``csrc/<name>.cu``'s library
    (``-Xptxas -v``), built first if needed."""
    load(name)
    with open(_lib_path(name) + ".log") as f:
        log = f.read()
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    return load_all([name])[0]
