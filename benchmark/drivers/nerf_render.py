"""NeRF's view render, as ``eval/nerf_common.render_view`` runs it: the
plain float32 models through ``ops/render.render_image`` in tiles of
``chunk`` rays, each view read back to the host.

The benchmark makes each view's pose and stratified jitter from the seed and
the view's index, so the reference renders the same view; after the window
it renders a sample of the finished views, drawn from the seed, and compares
rgb, depth and acc.
"""

from __future__ import annotations

import torch

from ..harness import compare, inputs
from ..reference import nerf as ref
from ..reference.precision import lower, plain_float32, tensor_cores
from .nerf_train import field_weights, image_geometry, orbit_poses


class Program:
    """The port's render of one view with the plain models.  The ``altered``
    fault (tests and calibration only) brightens the first tile of rays of
    every answer by 0.25."""

    def __init__(self, cfg, weights, device, chunk, fault=None):
        from msra_practice_project_tpu_torch import set_plain_precision
        from msra_practice_project_tpu_torch.models.nerf import nerf_model
        from msra_practice_project_tpu_torch.ops.render import render_image

        set_plain_precision()
        self.render_image = render_image
        names = ("coarse", "fine") if cfg["use_fine_model"] else ("coarse",)
        self.models = {}
        for n in names:
            m = nerf_model(False, device=device)
            m.load_state_dict({k[len(n) + 1:]: v.clone()
                               for k, v in weights.items()
                               if k.startswith(n + ".")})
            self.models[n] = m.eval()
        self.cfg, self.device, self.chunk = cfg, device, chunk
        self.fault = fault

    def render(self, c2w, jitter):
        cfg = self.cfg
        width, height, focal = image_geometry(cfg)
        coarse = self.models["coarse"]
        rgb, depth, acc = self.render_image(
            width, height, focal, c2w, cfg["render_near"], cfg["render_far"],
            coarse, self.models.get("fine", coarse),
            cfg["render_coarse_sample_num"], cfg["render_fine_sample_num"],
            chunk=self.chunk, jitter=jitter, device=self.device)
        out = (rgb.cpu().numpy(), depth.cpu().numpy(), acc.cpu().numpy())
        if self.fault == "altered":
            out[0].reshape(-1, 3)[:self.chunk] += 0.25
        return out


class Control:
    """The reference in the program's place, its fp32 products in TF32."""

    def __init__(self, cfg, weights, device, chunk, fault=None):
        self.cfg, self.weights, self.chunk = cfg, weights, chunk

    def render(self, c2w, jitter):
        prec = lower(self.cfg["precision"]["mlp_render"])
        with tensor_cores(prec):
            rgb, depth, acc = render_reference(
                self.cfg, self.weights, c2w, jitter, self.chunk,
                {"mlp_fwd": prec, "mlp_bwd": prec})
        width, height, _ = image_geometry(self.cfg)
        return (rgb.reshape(height, width, 3).cpu().numpy(),
                depth.reshape(height, width, 1).cpu().numpy(),
                acc.reshape(height, width, 1).cpu().numpy())


def render_reference(cfg, weights, c2w, jitter, chunk, prec=ref.FP32):
    width, height, focal = image_geometry(cfg)
    rays_o, rays_d = inputs.pixel_rays(c2w[None].to(jitter.device), width,
                                       height, focal)
    return ref.render_view(weights, cfg, rays_o[0], rays_d[0], jitter, chunk,
                           prec)


SUTS = {"program": (Program, None), "control": (Control, None),
        "fault_altered": (Program, "altered")}
KEEP = 0.99   # the share of a view's values whose gaps are averaged


class Driver:
    unit = "view"

    def __init__(self, cfg, traffic, seed, device, sut="program"):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.sut_kind = SUTS[sut]
        width, height, _ = image_geometry(cfg)
        self.items_per_step = width * height
        self.chunk = int(traffic["chunk"])
        self.outputs = []

    def view(self, v: int):
        """(pose ``[4, 4]``, jitter ``[H*W, nc]``) of view ``v``."""
        pose = orbit_poses(self.cfg, 1, inputs.host_rng(
            self.seed, 1000 + v))[0]
        gen = inputs.generator(self.device, self.seed, 1000 + v)
        jitter = torch.rand((self.items_per_step,
                             self.cfg["render_coarse_sample_num"]),
                            generator=gen, device=self.device)
        return pose, jitter

    def setup(self):
        self.weights = field_weights(self.cfg, self.traffic, self.seed,
                                     self.device)
        cls, fault = self.sut_kind
        self.sut = cls(self.cfg, self.weights, self.device, self.chunk, fault)
        self.warmup = int(self.traffic["warmup_views"])
        for v in range(self.warmup):
            self.sut.render(*self.view(v))

    def step(self, i, mark):
        self.outputs.append(self.sut.render(*self.view(self.warmup + i)))

    def outcome(self) -> tuple:
        bad = sum(not all(torch.isfinite(torch.from_numpy(a)).all()
                          for a in out) for out in self.outputs)
        return len(self.outputs), bad

    def release(self):
        del self.sut

    def readings(self) -> dict:
        """Over a sample of the window's views, drawn from the seed, the
        largest gap of a view's rgb, depth and acc against the reference:
        the mean of the smallest 99% of its values' gaps (``*_gap``), the
        mean of all (``*_mean_gap``) and the widest (``*_max_gap``).  A
        value's gap swings by the algorithm's nature: ``sample_pdf`` places
        a fine sample by a bin's width when a bin's CDF step crosses its
        1e-5 guard, which an ulp of the ray can do; the top 1% holds those
        pixels, and no more than that is left out."""
        n = len(self.outputs)
        rng = inputs.host_rng(self.seed, inputs.SAMPLE)
        k = min(int(self.traffic["sample_views"]), n)
        gaps = {}
        for i in sorted(rng.choice(n, size=k, replace=False).tolist()):
            pose, jitter = self.view(self.warmup + i)
            with plain_float32():
                want = render_reference(self.cfg, self.weights, pose, jitter,
                                        self.chunk)
            for name, got, ref_out in zip(("rgb", "depth", "acc"),
                                          self.outputs[i], want):
                got = torch.from_numpy(got).reshape(-1)
                for key, value in (
                        (f"{name}_gap", compare.mean_abs_gap(
                            got, ref_out, KEEP)),
                        (f"{name}_mean_gap", compare.mean_abs_gap(got,
                                                                  ref_out)),
                        (f"{name}_max_gap", compare.max_abs_gap(got,
                                                                ref_out))):
                    gaps[key] = max(gaps.get(key, 0.0), value)
        return gaps
