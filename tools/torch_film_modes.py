#!/usr/bin/env python3
"""A/B the FiLM trunk's modes inside the generator's hot paths, for the
PyTorch/CUDA port (the counterpart of tools/film_modes.py).

Times G fwd and G fwd+bwd (a sum loss) at a stage geometry in each
``MSRA_TPU_FUSED_FILM`` mode, set in this process (the generator reads it at
every call): 0 = the plain trunk (no kernel of the port), 1 = K8 forward in
fp32 (3xTF32) with K7 backward, 2 = K8 forward and K7 backward in bf16.
Each mode's K8 and K7 launches per call and peak memory are recorded; a
row that does not fit in the card's memory reads "out of memory".  Mode
0's fwd+bwd fits at test.json's stages: its FiLM sine saves only its
pre-FiLM input for the backward (``core.nn.FilmSine``) and the coarse pass
records no graph.  The JAX tool's tile
environment variables do not port: the kernels' tile and CTA geometry at
this shape is printed in their place.  The last line is a JSON object of
the readings.

Run: python3 tools/torch_film_modes.py [batch] [resolution] [modes]
         [--device cpu]
(default 16 64 0,1,2: stage 1 of configs/pi_gan/test.json).  On the CPU
every mode runs the plain versions and the times are the host clock's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from msra_practice_project_tpu_torch import (  # noqa: E402
    resolve_device, set_plain_precision)
from msra_practice_project_tpu_torch.ops.kernels import (  # noqa: E402
    film_mlp as FK)
from tools.torch_profile_pigan import (  # noqa: E402
    build, launches_per_call, timeit)


def geometry(batch, res, nc, nf, sms=None) -> dict:
    """The FiLM kernels' tiles and CTAs per trunk call (coarse pass: res^2
    x nc points per image; fine: res^2 x (nc + nf)); the fp32 K8's CTAs are
    persistent, min(tiles, ``sms``) (None without a card)."""
    out = {}
    for name, per_px in (("coarse", nc), ("fine", nc + nf)):
        p = res * res * per_px
        tiles = batch * -(-p // FK.PT_MULT) * FK.PT_MULT // FK.TC_TILE
        out[name] = {"points_per_image": p, "tiles": tiles,
                     "k8_f32_ctas": min(tiles, sms) if sms else None,
                     "bf16_ctas": len(FK.cta_tiles(tiles)),
                     "k7_images_per_chunk": FK.chunk_images(batch, p, True),
                     "k7_dw_splits": FK.bwd_splits(
                         FK.chunk_images(batch, p, True) * p)}
    return out


def main(batch=16, res=64, modes=("0", "1", "2"), device=None, n=20,
         warmup=3, gen_overrides=None) -> dict:
    """Each mode's G fwd and G fwd+bwd ms and launches per call; the
    environment's mode is restored after.  ``gen_overrides`` replaces
    fields of the GeneratorConfig (smaller runs)."""
    device = resolve_device(device)
    set_plain_precision()
    gen, _, z, _, rgen, _, _ = build(batch, res, device, gen_overrides)
    params = list(gen.parameters())
    nc, nf = gen.cfg.coarse_samples, gen.cfg.fine_samples
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else None)
    geo = geometry(batch, res, nc, nf, sms)
    print(f"batch {batch} @ {res}^2, {nc}+{nf} samples; {device.type}, "
          + ("CUDA events" if device.type == "cuda" else "host clock"))
    print(f"  tiles: {FK.TC_TILE}-point tiles; fp32 K8 one tile at a time "
          f"per persistent CTA (3xTF32 on wgmma, {sms} SMs), bf16 K8/K7 two "
          f"per CTA (one per consumer warpgroup), a {FK.TC_STAGES}-stage "
          f"TMA ring of {FK.TC_STAGE_BYTES // 1024} KB weight slices")
    for name, g in geo.items():
        print(f"  {name} pass: {g['points_per_image']:,} points an image, "
              f"{g['tiles']:,} tiles, {g['k8_f32_ctas']} fp32 CTAs, "
              f"{g['bf16_ctas']:,} bf16 CTAs; K7 {g['k7_images_per_chunk']} "
              f"images a chunk, {g['k7_dw_splits']} dW splits")

    def fwd():
        with torch.no_grad():
            return gen(z, res, generator=rgen).sum()

    def fwdbwd():
        g = torch.autograd.grad(gen(z, res, generator=rgen).sum(), params,
                                allow_unused=True)
        return sum(t.sum() for t in g if t is not None)

    def run(fn):
        """(ms, launches per call, peak GiB) of ``fn``; ms and launches are
        None when it does not fit in the device's memory."""
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        try:
            ms, launches = timeit(fn, device, n, warmup), launches_per_call(fn)
        except torch.cuda.OutOfMemoryError:
            ms = launches = None
        if ms is None:
            # outside the handler: the traceback's frames held the graph
            gc.collect()
            torch.cuda.empty_cache()
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None)
        return ms, launches, peak

    def fmt(ms, launches, peak):
        if ms is None:
            return ("out of memory" if peak is None
                    else f"out of memory (peak {peak:.1f} GiB)")
        return (f"{ms:7.2f} ms (K8 {launches['k8']}, {launches['k8_f32']} "
                f"fp32; K7 {launches['k7']})")

    old = os.environ.get("MSRA_TPU_FUSED_FILM")
    out = {"batch": batch, "resolution": res, "device": device.type,
           "geometry": geo, "modes": {}}
    try:
        for mode in modes:
            os.environ["MSRA_TPU_FUSED_FILM"] = str(mode)
            f, fb = run(fwd), run(fwdbwd)
            out["modes"][str(mode)] = {
                "fwd_ms": f[0], "fwdbwd_ms": fb[0], "fwd_launches": f[1],
                "fwdbwd_launches": fb[1], "fwd_peak_gib": f[2],
                "fwdbwd_peak_gib": fb[2]}
            rate = (f"   ({batch / fb[0] * 1e3:6.1f} imgs/s f+b)"
                    if fb[0] else "")
            print(f"  mode {mode}:  G fwd {fmt(*f)}   G fwd+bwd "
                  f"{fmt(*fb)}{rate}")
    finally:
        if old is None:
            os.environ.pop("MSRA_TPU_FUSED_FILM", None)
        else:
            os.environ["MSRA_TPU_FUSED_FILM"] = old
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("resolution", nargs="?", type=int, default=64)
    p.add_argument("modes", nargs="?", default="0,1,2")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    print(json.dumps(main(a.batch, a.resolution, a.modes.split(","),
                          a.device)))
