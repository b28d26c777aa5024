"""Nothing the benchmark runs loads JAX or the JAX package, the reference
takes nothing of the program, and the JAX package's benchmark files are
read by nothing here."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys
import textwrap

from benchmark.harness.compare import FORBIDDEN, forbidden_modules
from benchmark.harness.registry import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_top_level_names():
    assert "msra_practice_project_tpu" in FORBIDDEN
    sys.modules.setdefault("msra_practice_project_tpu_torch_probe", sys)
    try:
        assert "msra_practice_project_tpu" not in forbidden_modules()
    finally:
        del sys.modules["msra_practice_project_tpu_torch_probe"]


def test_importing_everything_loads_no_jax():
    """In a fresh process: the harness, every driver and metric, the
    reference and the program's modules the drivers use."""
    code = textwrap.dedent(f"""
        import glob, os, sys
        sys.path.insert(0, {ROOT!r})
        from benchmark.harness import cell, compare, registry, trace
        from benchmark.reference import nerf, pigan, precision
        import benchmark.calibrate, benchmark.run
        reg = registry.Registry()
        for m in reg.bench["end_to_end"] + reg.bench["per_layer"]:
            reg.reader(m["name"])
        for p in glob.glob(os.path.join({BENCH_DIR!r}, "drivers", "*.py")):
            reg.driver(os.path.basename(p)[:-3])
        import msra_practice_project_tpu_torch.train.train_nerf
        import msra_practice_project_tpu_torch.train.train_pigan
        import msra_practice_project_tpu_torch.ops.render
        print(",".join(compare.forbidden_modules()))
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN + (
                "msra_practice_project_tpu_torch", "benchmark"), (path, name)


def test_no_file_reads_the_jax_benchmark():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"),
                          recursive=True):
        text = open(path).read()
        for name in ("bench.py", "bench_baseline", "BENCH_r"):
            assert name not in text or path.endswith(
                "test_bench_nojax.py"), (path, name)
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
