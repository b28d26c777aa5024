#!/usr/bin/env python3
"""The bf16 per-tile pass of K7 and K8 and the fp32 K8 (csrc/film_mlp.cu)
on one GPU, by what their time goes to.

Builds csrc/film_mlp.cu as it is and variants of it, each a copy with one
text edit (the variants' results are not meant to be right), one nvcc each,
all started together, and times K8 and K7 (bf16, need_dx=False as the
generator calls K7) and K8 in fp32 (film_fwd_tf32_kernel; CUDA events, median
of 5 launches after two warm-ups) at B 64 x P 8,192 on chip_smoke.py's
inputs, each variant in its own process:
  as_is        the source as it is;
  no_epilogue  the epilogues' walks over the accumulators removed: what is
               left is the TMA weight stream, the wgmma products, the heads'
               and x's handling and, in K7, its other passes;
  no_sine      the sine and its derivative replaced by their argument;
  branchy      the sine's reflection as a branch (as the fp32 kernels had
               it before the bf16 pass needed a select);
  jb2, jb8     the epilogues' blocks of TC_JB = 2 or 8 steps of j, not 4;
  unrolled     TC_JB = 32: one fully unrolled walk over the accumulators;
  tf32_no_epilogue  the fp32 K8's epilogue walk removed: its weight
               stream, its 3xTF32 products, barriers and the heads' tail;
  tf32_stream_only  that, and each product replaced by waiting for its
               ring stages and releasing them: the weight stream alone;
  tf32_jb4, tf32_jb16  its epilogue's blocks of TF_JB = 4 or 16 steps of
               j, not 8;
  tf32_no_setmaxnreg  no setmaxnreg: its consumers keep the 168 registers a
               384-thread CTA starts with, not 232.

Usage: python3 tools/torch_film_probe.py
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

_SELECT = """  const float r = __fsub_rn(v, __fmul_rn(q, TWO_PI));
  const float hi = __fsub_rn(PI_F, r), lo = __fsub_rn(-PI_F, r);
  flip = r > HALF_PI || r < -HALF_PI;
  return r > HALF_PI ? hi : (r < -HALF_PI ? lo : r);"""
_BRANCH = """  float r = __fsub_rn(v, __fmul_rn(q, TWO_PI));
  flip = r > HALF_PI || r < -HALF_PI;
  if (r > HALF_PI) r = __fsub_rn(PI_F, r);
  else if (r < -HALF_PI) r = __fsub_rn(-PI_F, r);
  return r;"""
_WALK = "  for (int jb = 0; jb < HID / 8; jb += TC_JB) {"
_JB = "constexpr int TC_JB = 4;"
_TF_WALK = "  for (int jb = 0; jb < TF_NACC / 4; jb += TF_JB) {"
_TF_PRODUCT = "tf_product(c, acc);"
_TF_DRAIN = ("for (int s = 0; s < 2 * TF_SLICES; ++s, ++c.it) {"
             " mbar_wait(c.bars + 8 * (c.it % TF_STAGES),"
             " (c.it / TF_STAGES) & 1);"
             " mbar_arrive(c.bars + 8 * (TF_STAGES + c.it % TF_STAGES)); }")
_TF_NO_WALK = (_TF_WALK, "  for (int jb = 0; jb < 0; jb += TF_JB) {")
_TF_JB = "constexpr int TF_JB = 8;"
_TF_REGS = [("  if (threadIdx.x >= TF_CONSUMERS) {\n    tc_regs_producer();\n",
             "  if (threadIdx.x >= TF_CONSUMERS) {\n"),
            ("  tc_regs_consumer();\n  auto W = [&](int i) { return "
             "reinterpret_cast<const float*>(P.p[i]); };\n",
             "  auto W = [&](int i) { return "
             "reinterpret_cast<const float*>(P.p[i]); };\n")]

EDITS = {
    "as_is": [],
    "no_epilogue": [(_WALK, "  for (int jb = 0; jb < 0; jb += TC_JB) {")],
    "no_sine": [("hv[cc] = trunk_sin<EXACT>(__fmul_rn(",
                 "hv[cc] = (__fmul_rn("),
                ("trunk_sin_vjp<EXACT>(__fmul_rn(W0F, v))",
                 "(__fmul_rn(W0F, v))")],
    "branchy": [(_SELECT, _BRANCH)],
    "jb2": [(_JB, "constexpr int TC_JB = 2;")],
    "jb8": [(_JB, "constexpr int TC_JB = 8;")],
    "unrolled": [(_JB, "constexpr int TC_JB = 32;")],
    "tf32_no_epilogue": [_TF_NO_WALK],
    "tf32_stream_only": [_TF_NO_WALK, (_TF_PRODUCT, _TF_DRAIN)],
    "tf32_jb4": [(_TF_JB, "constexpr int TF_JB = 4;")],
    "tf32_jb16": [(_TF_JB, "constexpr int TF_JB = 16;")],
    "tf32_no_setmaxnreg": _TF_REGS,
}


def variants(src: str) -> dict:
    """{name: source} for EDITS applied to film_mlp.cu's text; raises if an
    edit's text is not in the source (each is replaced wherever it is: the
    epilogue walk is in both epilogues, the sine's derivative in both
    backward kernels)."""
    out = {}
    for name, edits in EDITS.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise ValueError(f"{name}: {old!r} is not in the source")
            s = s.replace(old, new)
        out[name] = s
    return out


def time_variant(lib_path: str) -> dict:
    """K8, K7 and K8 in fp32 with the FiLM library at lib_path (this
    process only)."""
    import torch

    import chip_smoke as cs
    from msra_practice_project_tpu_torch import set_plain_precision
    from msra_practice_project_tpu_torch.ops.kernels import build
    from msra_practice_project_tpu_torch.ops.kernels import film_mlp as FK

    set_plain_precision()
    build._LIBS["film_mlp"] = ctypes.CDLL(lib_path)
    x, film, w, dy = cs.film_inputs(torch, FK, cs.FILM_B, cs.FILM_COARSE_P,
                                    seed=1)
    x, film, dy = x.cuda(), film.cuda(), dy.cuda()
    wk = [t.cuda() for t in FK.kernel_weights(w, True)]
    wf = [t.cuda() for t in FK.kernel_weights(w, False)]
    return {"K8_ms": cs.time_ms(torch, lambda: FK.film_mlp_fwd(
                x, film, wk, True), 5),
            "K7_ms": cs.time_ms(torch, lambda: FK.film_mlp_bwd(
                x, film, dy, wk, True, False), 5),
            "K8_f32_ms": cs.time_ms(torch, lambda: FK.film_mlp_fwd(
                x, film, wf, False), 5)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--lib":
        print(json.dumps(time_variant(sys.argv[2])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_film_probe: CUDA is not available", file=sys.stderr)
        return 2
    from msra_practice_project_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(build.CSRC, "film_mlp.cu")) as f:
        srcs = variants(f.read())
    res = {"device": smi, "shape": "B 64 x P 8192"}
    with tempfile.TemporaryDirectory(prefix="film_probe_") as tmp:
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
                 os.path.join(tmp, f"{name}.so")],
                capture_output=True, text=True, timeout=600)
            if run.returncode:
                print(f"{name}: {run.stderr[-2000:]}", file=sys.stderr)
                return 1
            res[name] = t = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"{name:16s} K8 {t['K8_ms']:8.4f} ms  K7 {t['K7_ms']:8.4f} "
                  f"ms  K8 fp32 {t['K8_f32_ms']:8.4f} ms", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
