"""pi-GAN's training iteration, ``train/train_pigan.make_gan_steps`` of the
port: a D step (the generator's fakes without a graph, R1's double backward
on the reals) then a G step, each with the port's Adam; the trunk in the
mode the configuration's ``env`` sets.

Set-up makes the weights and a buffer of real images on the device, builds
both steps with their models and optimizers, and drives them through their
first iterations (``first_steps``, which the reference follows) and a
warm-up; the window then runs the same steps on fresh latents, poses and
jitter, and the next reals.
"""

from __future__ import annotations

import torch

from ..harness import compare, inputs
from ..reference import pigan as ref
from ..reference.precision import lower, plain_float32, tensor_cores


def stage_of(cfg: dict, traffic: dict) -> dict:
    i = int(traffic["stage"])
    return {"batch": int(cfg["batch_size"][i]),
            "resolution": int(cfg["resolution"][i]),
            "fade_alpha": float(traffic["fade_alpha"])}


class Program:
    """The port's D and G steps built as ``train_pigan.train`` builds them.
    A fault (tests and calibration only): ``frozen`` skips every Adam
    update, ``half`` feeds half of each batch."""

    def __init__(self, cfg, stage, weights, device, fault=None):
        from msra_practice_project_tpu_torch import set_plain_precision
        from msra_practice_project_tpu_torch.models import pigan
        from msra_practice_project_tpu_torch.train import common
        from msra_practice_project_tpu_torch.train.train_pigan import \
            make_gan_steps

        set_plain_precision()
        g = cfg["generator"]
        gen_cfg = pigan.GeneratorConfig(
            z_dim=cfg["z_dim"], resolution=stage["resolution"],
            near=cfg["render_near"], far=cfg["render_far"], fov=g["fov"],
            coarse_samples=cfg["render_coarse_sample_num"],
            fine_samples=cfg["render_fine_sample_num"],
            horizontal_std=g["horizontal_std"],
            vertical_std=g["vertical_std"], use_dir=cfg["use_dir"])
        self.models = {"g": pigan.Generator(gen_cfg, device=device),
                       "d": pigan.Discriminator(device=device)}
        for n, m in self.models.items():
            m.load_state_dict({k[2:]: v.clone() for k, v in weights.items()
                               if k.startswith(n + ".")})
        betas = tuple(cfg["adam_betas"])
        self.opts = {
            "g": common.adam(self.models["g"].parameters(), common.interp_lr(
                cfg["generator_lr"], cfg["generator_lr_end"],
                cfg["lr_decay"]), betas=betas),
            "d": common.adam(self.models["d"].parameters(), common.interp_lr(
                cfg["discriminator_lr"], cfg["discriminator_lr_end"],
                cfg["lr_decay"]), betas=betas)}
        if fault == "frozen":
            for opt in self.opts.values():
                opt.step = lambda: None
        self.d_step, self.g_step = make_gan_steps(
            self.models["g"], self.models["d"], self.opts["g"],
            self.opts["d"], stage["resolution"], r1_lambda=cfg["r1_lambda"])
        self.alpha, self.fault = stage["fade_alpha"], fault

    def iteration(self, it, mark=None):
        if self.fault == "half":
            half = it["real"].shape[0] // 2
            it = {k: v[:half] for k, v in it.items()}
        if mark:
            mark("d_step")
        with torch.profiler.record_function("bench.d_step"):
            d = self.d_step(it["real"], it["d_z"], self.alpha, 0.0,
                            poses=(it["d_theta"], it["d_phi"]),
                            jitter=it["d_jitter"])["d_loss"]
        if mark:
            mark("g_step")
        with torch.profiler.record_function("bench.g_step"):
            g = self.g_step(it["g_z"], self.alpha, 0.0,
                            poses=(it["g_theta"], it["g_phi"]),
                            jitter=it["g_jitter"])["g_loss"]
        return d, g

    def _leaves(self):
        return {f"{n}.{k}": p for n, m in self.models.items()
                for k, p in m.named_parameters()}

    def first_grads(self) -> dict:
        """The first gradients, as each Adam's first moment after one
        update holds them: exp_avg / (1 - beta1)."""
        out = {}
        for n, m in self.models.items():
            opt = self.opts[n].opt
            b1 = opt.param_groups[0]["betas"][0]
            for k, p in m.named_parameters():
                st = opt.state.get(p, {})
                out[f"{n}.{k}"] = (st["exp_avg"] / (1.0 - b1)
                                   if "exp_avg" in st
                                   else torch.zeros_like(p)).detach().clone()
        return out

    def leaves(self) -> dict:
        return {k: p.detach().clone() for k, p in self._leaves().items()}


class Control:
    """The reference in the program's place, one precision step below the
    configuration's in every part: TF32 for the fp32 parts (the trunk's
    forward, the mapping network, the discriminator), fp8 for the trunk's
    bf16 backward."""

    def __init__(self, cfg, stage, weights, device, fault=None):
        prec = {part: lower(p) for part, p in cfg["precision"].items()}
        self.trainer = ref.Trainer(weights, cfg, stage, prec)

    def iteration(self, it, mark=None):
        with tensor_cores("tf32"):
            return self.trainer.iteration(it)

    def first_grads(self):
        return self.trainer.first

    def leaves(self):
        return self.trainer.leaves()


SUTS = {"program": (Program, None), "control": (Control, None),
        "fault_frozen": (Program, "frozen"), "fault_half": (Program, "half")}


class Driver:
    unit = "iteration"

    def __init__(self, cfg, traffic, seed, device, sut="program"):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.sut_kind = SUTS[sut]
        self.stage = stage_of(cfg, traffic)
        self.items_per_step = self.stage["batch"]
        self.first = int(traffic["first_steps"])
        self.losses = []

    def _feed(self, k: int) -> dict:
        n, res = self.stage["batch"], self.stage["resolution"]
        g, gen, dev = self.cfg["generator"], self.feed_gen, self.device
        lo = (k % (self.real.shape[0] // n)) * n
        it = {"real": self.real[lo:lo + n]}
        for side in ("d_", "g_"):
            it[side + "z"] = torch.randn((n, self.cfg["z_dim"]), generator=gen,
                                         device=dev)
            it[side + "theta"] = g["horizontal_std"] * torch.randn(
                n, generator=gen, device=dev)
            it[side + "phi"] = g["vertical_std"] * torch.randn(
                n, generator=gen, device=dev)
            it[side + "jitter"] = torch.rand(
                (n, res * res, self.cfg["render_coarse_sample_num"]),
                generator=gen, device=dev)
        return it

    def setup(self):
        res = self.stage["resolution"]
        self.weights = inputs.make_weights(
            ref.param_specs(self.cfg),
            inputs.generator(self.device, self.seed, inputs.WEIGHTS),
            self.device)
        self.real = torch.rand(
            (int(self.traffic["real_images"]), 3, res, res),
            generator=inputs.generator(self.device, self.seed, inputs.SCENE),
            device=self.device)
        self.feed_gen = inputs.generator(self.device, self.seed, inputs.FEED)
        cls, fault = self.sut_kind
        self.sut = cls(self.cfg, self.stage, self.weights, self.device, fault)
        self.first_inputs, self.first_losses = [], []
        for k in range(self.first + int(self.traffic["warmup_steps"])):
            it = self._feed(k)
            losses = self.sut.iteration(it)
            if k < self.first:
                self.first_inputs.append({n: v.clone() for n, v in it.items()})
                self.first_losses.append(losses)
            if k == 0:
                self.first_grad = self.sut.first_grads()
            if k == self.first - 1:
                self.after = self.sut.leaves()
        self.next = self.first + int(self.traffic["warmup_steps"])

    def step(self, i, mark):
        self.losses.append(self.sut.iteration(self._feed(self.next + i),
                                              mark))

    def outcome(self) -> tuple:
        losses = torch.stack([torch.stack(pair) for pair in self.losses])
        return len(self.losses), int((~torch.isfinite(losses)).any(1).sum())

    def release(self):
        self.first_losses = [(float(d), float(g))
                             for d, g in self.first_losses]
        del self.sut, self.real, self.losses

    def readings(self) -> dict:
        """The first iterations' D and G losses, the first D and G
        gradients and the change of their leaves over those iterations,
        against the reference's from the same weights and inputs."""
        with plain_float32():
            trainer = ref.Trainer(self.weights, self.cfg, self.stage)
            ref_losses = [tuple(float(v) for v in trainer.iteration(it))
                          for it in self.first_inputs]
        ref_after = trainer.leaves()
        got = compare.change(self.after, self.weights)
        want = compare.change(ref_after, self.weights)
        out = {"first_loss_gap": compare.rel_gap(self.first_losses[0],
                                                 ref_losses[0]),
               "loss_gap": compare.rel_gap(
            [v for pair in self.first_losses for v in pair],
            [v for pair in ref_losses for v in pair])}
        for net in ("g", "d"):
            names = [k for k in self.weights if k.startswith(net + ".")]
            out[f"grad_gap_{net}"] = compare.leaf_gap(
                self.first_grad, trainer.first, names)
            out[f"change_gap_{net}"] = compare.leaf_gap(
                got, want, compare.moving_leaves(
                    {k: trainer.first[k] for k in names}))
        return out
