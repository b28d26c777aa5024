#!/usr/bin/env python3
"""One run of one benchmark cell of ``msra_practice_project_tpu_torch`` on
NVIDIA cards:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (weights and inputs from the seed,
the kernels built or loaded, the cell's first steps and warm-up), then a
window of ``--seconds``, then the comparison that decides ``correct``.  The
last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``, each compared number with its limit, last); the same numbers
are the last lines of standard error.  Exits non-zero, printing no result,
without enough CUDA cards, without the program, or with JAX or the JAX
package loaded.
"""

from __future__ import annotations

import os
import sys
import time

_IMPORTED_AT = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def process_start() -> float:
    """This process's start on ``time.time()``'s clock (Linux), else the
    moment this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    start = process_start()

    # every cache inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    from benchmark.harness.compare import forbidden_modules
    from benchmark.harness.registry import Registry

    reg = Registry(ROOT)
    chips = int(reg.workload(args.workload)["chips"])
    cfg = reg.config(reg.workload(args.workload)["config"])
    os.environ.update(cfg.get("env", {}))
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"this cell needs {chips} CUDA card(s); {cards} found",
              file=sys.stderr)
        return 3
    try:
        import msra_practice_project_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 3

    from benchmark.harness.cell import run_cell

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), start, registry=reg)
    found = forbidden_modules()
    if found:
        print("loaded in this process, which the port must not load: "
              + ", ".join(found), file=sys.stderr)
        return 4
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
