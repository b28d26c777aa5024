#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --suts program,control,fault_half [--out FILE]

For each system under test and each seed, in one process: the cell's
set-up (its first steps included), the views a run compares (render cells),
and the comparison with the plain reference; one JSON line each, to
standard output and to ``--out``.  ``control`` is the reference in the
program's place one precision step lower; ``fault_*`` break the program
underneath (the driver's ``SUTS``).  No window is measured.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--suts", default="program")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness.registry import Registry

    reg = Registry(ROOT)
    wl = reg.workload(args.workload)
    cfg = reg.config(wl["config"])
    traffic = reg.traffic(wl["traffic"])
    os.environ.update(cfg.get("env", {}))
    import torch

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    driver = reg.driver(traffic["driver"])
    views = int(traffic.get("sample_views", 0))
    out = open(args.out, "a") if args.out else None
    for sut in args.suts.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            drv = driver.Driver(dict(cfg), dict(traffic), seed, device, sut)
            drv.setup()
            for i in range(views):
                drv.step(i, None)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            drv.release()
            gc.collect()
            readings = drv.readings()
            line = json.dumps({"workload": args.workload, "sut": sut,
                               "seed": seed, "readings": readings,
                               "setup_s": t1 - t0,
                               "check_s": time.perf_counter() - t1})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del drv
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
