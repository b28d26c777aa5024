#!/usr/bin/env python3
"""The split-K dW pass (csrc/tile_mm.cuh) on one GPU, by what it reads.

Times the pass alone (``dw_splitk``: the kernel and its fixed-order sum;
CUDA events, median of 25 launches after two warm-ups) at N points of bf16
operands made from a seed, on K2's task table and on variants that drop part
of its reads:
  full      K2's 26 tasks (the 12 bias tasks folded into weight jobs);
  one_half  each weight task cut to its first 128 rows, so that no delta
            column is loaded by two CTAs (a 256-row task has two);
  weights   the 14 weight tasks alone.
For each it prints the bytes per point its CTAs load (TMA boxes of 64
columns, as ``make_jobs`` cuts the tasks), the bytes per point it needs
(each used column once), the time, and both over the time.  If the second
delta read came from L2, ``full`` would show a higher load rate than
``one_half``.

Usage: python3 tools/torch_dw_probe.py [N]   (default 196,608, K2's fine
pass)
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def loaded_bytes_per_point(tasks) -> int:
    """Bytes per point the pass's CTAs load: per job (up to 128 X columns x
    256 Y columns; X the delta columns when N is not a multiple of 64 and M
    > N) the 64-column X boxes and the 128- or 256-column Y tile."""
    cols = 0
    for a0, m, _, n, _ in tasks:
        if a0 < 0:
            continue
        xn, yn = (n, m) if (n % 64 and m > n) else (m, n)
        for x in range(0, xn, 128):
            for y in range(0, yn, 256):
                cols += -(-min(128, xn - x) // 64) * 64
                cols += 128 if min(256, yn - y) <= 128 else 256
    return 2 * cols


def needed_bytes_per_point(tasks) -> int:
    acols = {c for a0, m, _, _, _ in tasks if a0 >= 0
             for c in range(a0, a0 + m)}
    dcols = {c for _, _, d0, n, _ in tasks for c in range(d0, d0 + n)}
    return 2 * (len(acols) + len(dcols))


def variants(tasks) -> dict:
    """The task tables: full, one X half per weight, weights alone (offsets
    repacked so each table's gradient is dense)."""
    def repack(rows):
        out, off = [], 0
        for a0, m, d0, n, _ in rows:
            out.append((a0, m, d0, n, off))
            off += m * n
        return out

    half = [(a0, min(m, 128) if a0 >= 0 else m, d0, n, 0)
            for a0, m, d0, n, _ in tasks]
    return {"full": tasks, "one_half": repack(half),
            "weights": repack([t for t in tasks if t[0] >= 0])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dw_probe: CUDA is not available", file=sys.stderr)
        return 2
    from msra_practice_project_tpu_torch import set_plain_precision
    from msra_practice_project_tpu_torch.ops.kernels import dw_splitk as DW
    from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K

    set_plain_precision()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 196_608
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    acts = torch.randn(n, K.ACT_PAD, device="cuda", generator=g).bfloat16()
    deltas = torch.randn(n, K.DELTA_W, device="cuda", generator=g).bfloat16()
    splits = K.bwd_splits(n)
    res = {"device": smi, "points": n, "splits": splits}
    for name, tasks in variants(K.grad_tasks()).items():
        for _ in range(2):
            DW.dw_splitk(acts, deltas, tasks, splits)
        ts = []
        for _ in range(25):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            DW.dw_splitk(acts, deltas, tasks, splits)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        ms = statistics.median(ts)
        loaded, needed = loaded_bytes_per_point(tasks), needed_bytes_per_point(
            tasks)
        res[name] = {"ms": ms, "loaded_B_per_pt": loaded,
                     "needed_B_per_pt": needed,
                     "loaded_TB_per_s": loaded * n / ms / 1e9,
                     "needed_TB_per_s": needed * n / ms / 1e9}
        print(f"{name:9s} {ms:8.4f} ms  loads {loaded:6d} B/pt "
              f"({res[name]['loaded_TB_per_s']:.3f} TB/s), needs {needed:6d} "
              f"B/pt ({res[name]['needed_TB_per_s']:.3f} TB/s)", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
