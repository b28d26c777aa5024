#!/usr/bin/env python3
"""The bf16 kernels of the NeRF MLP (csrc/nerf_mlp.cu: the forward
nerf_fwd_tc_kernel of K1/K3/K6, K2's delta chain nerf_bwd_delta_tc_kernel
and K4's dx_tc_kernel) on one GPU, by what their time goes to.

Builds csrc/nerf_mlp.cu as it is and variants of it, each a copy with text
edits (the variants' results are not meant to be right), one nvcc each, all
started together, and times K1 (forward with the spill), K3 (forward alone),
the delta chain alone and K4 (on K5's copy of the deltas, and "K4_k2" on
K2's delta workspace) (bf16; CUDA events, median of 10 launches after two
warm-ups, each launch alone and 10 back to back, so that the host's work
per launch overlaps the device's; each kernel alone from a torch.profiler
trace of 10 launches), and the weight stacks alone, at N points (default
65,536, the coarse pass) on chip_smoke.py's inputs, each variant in its own
process:
  as_is            the source as it is;
  no_epilogue      the epilogues' walks over the accumulators removed: what
                   is left is the TMA weight stream, the wgmma products, the
                   PE, the heads and the TMA traffic of A;
  no_pe            the PE's sinf/cosf replaced by their argument;
  no_spill         K1's TMA stores of A to the spill removed;
  no_mask_loads    the delta chain's TMA loads of h6..h0 removed (its
                   epilogues read h7's mask throughout);
  no_delta_stores  the delta chain's TMA stores of A to the workspaces
                   removed;
  jb2, jb4, jb16   the epilogues' blocks of TC_JB = 2, 4 or 16 steps of j,
                   not 8 (16: h9's 128 columns in one block);
  k4_no_chain      K4's chain rule (the sincosf loop) removed: the weights'
                   load, the delta stream, the products, the staging and
                   the dx stores are left;
  k4_stream        K4's products removed as well: the weights' load and
                   the delta stream through the ring, each stage released
                   as soon as it lands, and the dx stores;
  k4_stages3       K4's ring of 3 stages, not 6.

Usage: python3 tools/torch_nerf_probe.py [N] [--only name,name,...]
  (--only: the variants to build and time; default all)
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_FWD_WALK = "  for (int jb = 0; jb < NCOL / 8; jb += TC_JB) {"
_BWD_WALK = "  for (int jb = 0; jb < HID / 8; jb += TC_JB) {"
_JB = "constexpr int TC_JB = 8;"
_K4_CHAIN = """      for (int f = 0; f < n_freq; ++f) {
        const float sc = (float)(1 << f);
        float sn, cs;"""
_K4_PRODUCT = """      dx_box_product(ap, ad, ring + s * DX_BOX_BYTES + wg * TC_A_BLOCK, q,
                     wts);"""
_MASK_LOAD = """      mbar_expect_tx(mbar, 8 * DW_BOX_BYTES);
      tc_load_tile(mask, &amap, A_H0 + (l - 1) * HID, c.row0, 4, mbar);"""

EDITS = {
    "as_is": [],
    "no_epilogue": [(_FWD_WALK, _FWD_WALK.replace("NCOL / 8", "0")),
                    (_BWD_WALK, _BWD_WALK.replace("HID / 8", "0"))],
    "no_pe": [("__float2bfloat16(sinf(a)), cv = __float2bfloat16(cosf(a));",
               "__float2bfloat16(a), cv = __float2bfloat16(a);")],
    "no_spill": [("  if constexpr (SPILL) tc_store_a(c, amap, col0, "
                  "NCOL / DW_BOX);", "")],
    "no_mask_loads": [(_MASK_LOAD, "      mbar_arrive(mbar);")],
    "no_delta_stores": [("tc_store_a(c, &dmap, ",
                         "if (0) tc_store_a(c, &dmap, ")],
    "jb2": [(_JB, "constexpr int TC_JB = 2;")],
    "jb4": [(_JB, "constexpr int TC_JB = 4;")],
    "jb16": [(_JB, "constexpr int TC_JB = 16;")],
    "k4_no_chain": [(_K4_CHAIN, _K4_CHAIN.replace("f < n_freq", "f < 0"))],
    "k4_stream": [(_K4_CHAIN, _K4_CHAIN.replace("f < n_freq", "f < 0")),
                  (_K4_PRODUCT, "")],
    "k4_stages3": [("constexpr int DX_STAGES = 6;",
                    "constexpr int DX_STAGES = 3;")],
}


def variants(src: str) -> dict:
    """{name: source} for EDITS applied to nerf_mlp.cu's text; raises if an
    edit's text is not in the source (each is replaced wherever it is)."""
    out = {}
    for name, edits in EDITS.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise ValueError(f"{name}: {old!r} is not in the source")
            s = s.replace(old, new)
        out[name] = s
    return out


def time_variant(lib_path: str, n: int) -> dict:
    """K1, K3, the delta chain and K4 with the NeRF library at lib_path
    (this process only)."""
    import torch

    import chip_smoke as cs
    from msra_practice_project_tpu_torch import set_plain_precision
    from msra_practice_project_tpu_torch.ops.kernels import build
    from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K

    set_plain_precision()
    build._LIBS["nerf_mlp"] = ctypes.CDLL(lib_path)
    x, w, dy = cs.seeded_inputs(torch, K, n, seed=1)
    x, dy = x.cuda(), dy.cuda()
    wk = [t.cuda() for t in K.kernel_weights(w, True)]
    _, acts = K.nerf_mlp_fwd_save(x, wk, True)
    dh2 = K.nerf_mlp_bwd_saved(wk, dy, acts, True)[1]
    dh5 = K.nerf_mlp_bwd(x, wk, dy, True, True)[1]
    runs = {"K1": lambda: K.nerf_mlp_fwd_save(x, wk, True),
            "K3": lambda: K.nerf_mlp_fwd(x, wk, True),
            "deltas": lambda: K.nerf_mlp_deltas(wk, dy, acts, True),
            "K4": lambda: K.nerf_mlp_dx(x, wk, dh5, True),
            "K4_k2": lambda: K.nerf_mlp_dx(x, wk, dh2, True)}
    out = {f"{k}_ms": cs.time_ms(torch, f, 10) for k, f in runs.items()}
    # the same launches back to back, 10 between two events: the host's
    # per-launch work (weight stacks, allocations) overlaps the device's
    for k, f in runs.items():
        out[f"{k}_b2b_ms"] = cs.time_ms(
            torch, lambda: [f() for _ in range(10)], 5) / 10
    out["stacks_ms"] = cs.time_ms(torch, lambda: K.weight_stacks(wk), 10)
    # the per-tile kernels' device time alone, from a profile of 10 launches
    from torch.profiler import ProfilerActivity, profile
    for k, name in (("K1", "nerf_fwd_tc_kernel<true>"),
                    ("K3", "nerf_fwd_tc_kernel<false>"),
                    ("deltas", "nerf_bwd_delta_tc_kernel"),
                    ("K4", "dx_tc_kernel"), ("K4_k2", "dx_tc_kernel")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                runs[k]()
            torch.cuda.synchronize()
        out[f"{k}_kernel_ms"] = sum(
            d for n_, _, d in cs.device_kernels(prof) if name in n_) / 1e4
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--lib":
        print(json.dumps(time_variant(sys.argv[2], int(sys.argv[3]))))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_nerf_probe: CUDA is not available", file=sys.stderr)
        return 2
    from msra_practice_project_tpu_torch.ops.kernels import build

    args = sys.argv[1:]
    only = None
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1].split(",")
        del args[i:i + 2]
    n = int(args[0]) if args else 65536
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(build.CSRC, "nerf_mlp.cu")) as f:
        srcs = {k: v for k, v in variants(f.read()).items()
                if only is None or k in only}
    res = {"device": smi, "points": n}
    with tempfile.TemporaryDirectory(prefix="nerf_probe_") as tmp:
        for h in os.listdir(build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(build.CSRC, h), tmp)
        jobs = {}
        for name, s in srcs.items():
            cu = os.path.join(tmp, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(s)
            jobs[name] = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 os.path.join(tmp, f"{name}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
                return 1
        for name in srcs:
            run = subprocess.run(
                [sys.executable, __file__, "--lib",
                 os.path.join(tmp, f"{name}.so"), str(n)],
                capture_output=True, text=True, timeout=600)
            if run.returncode:
                print(f"{name}: {run.stderr[-2000:]}", file=sys.stderr)
                return 1
            res[name] = t = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"{name:16s} " + "  ".join(
                f"{k[:-3]} {v:7.4f}" for k, v in t.items()) + " (ms)",
                flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
