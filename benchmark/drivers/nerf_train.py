"""NeRF's train step, ``train/train_nerf.make_train_step`` of the port: both
MLPs through the fused kernels on the card, the render library, the loss,
the backward and the port's Adam.

Set-up makes the weights and a shuffled ray buffer on the device, builds the
step with its models and optimizer, and drives it through its first steps
(``first_steps``, which the reference follows) and a warm-up; the window
then calls the same step on the next batches.  Every batch is a fresh slice
of the buffer with fresh stratified jitter.
"""

from __future__ import annotations

import math

import torch

from ..harness import compare, inputs
from ..reference import nerf as ref
from ..reference.precision import lower, plain_float32, tensor_cores


def image_geometry(cfg: dict) -> tuple:
    """(width, height, focal) of the configuration's views."""
    s = cfg["scene"]
    width = int(round(s["full_width"] * cfg["data_resize"]))
    height = int(round(s["full_height"] * cfg["data_resize"]))
    return width, height, 0.5 * width / math.tan(0.5 * s["camera_angle_x"])


def orbit_poses(cfg: dict, n: int, rng) -> torch.Tensor:
    """``[n, 4, 4]`` poses on the scene's orbit: yaw uniform, pitch uniform
    over the configuration's range."""
    s = cfg["scene"]
    theta = torch.tensor(rng.uniform(-math.pi, math.pi, n),
                         dtype=torch.float32)
    phi = torch.tensor(rng.uniform(*(math.radians(a) for a in s["phi_deg"]),
                                   n), dtype=torch.float32)
    return inputs.camera_to_world(theta, phi, s["radius"])


def field_weights(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Both MLPs' leaves from the seed, as the source inits them, but for
    the density heads' biases, drawn from the traffic's ``sigma_bias``
    range: with the source's zero bias a seed's random field can be empty,
    and an empty field renders white whatever precision computes it."""
    gen = inputs.generator(device, seed, inputs.WEIGHTS)
    weights = inputs.make_weights(ref.param_specs(cfg), gen, device)
    low, high = traffic["sigma_bias"]
    for k, v in weights.items():
        if k.endswith("sigma.bias"):
            v.uniform_(low, high, generator=gen)
    return weights


def model_leaves(models: dict) -> dict:
    return {f"{m}.{n}": p for m, mod in models.items()
            for n, p in mod.named_parameters()}


class Program:
    """The port's train step built as ``train_nerf.train`` builds it.  A
    fault (tests and calibration only) breaks it underneath: ``frozen``
    skips every Adam update, ``half`` feeds half of each batch."""

    def __init__(self, cfg, weights, device, fault=None):
        from msra_practice_project_tpu_torch import set_plain_precision
        from msra_practice_project_tpu_torch.models.nerf import nerf_model
        from msra_practice_project_tpu_torch.train import common
        from msra_practice_project_tpu_torch.train.train_nerf import \
            make_train_step

        set_plain_precision()
        names = ("coarse", "fine") if cfg["use_fine_model"] else ("coarse",)
        self.models = {n: nerf_model(False, device=device) for n in names}
        for n, m in self.models.items():
            m.load_state_dict({k[len(n) + 1:]: v.clone()
                               for k, v in weights.items()
                               if k.startswith(n + ".")})
        self.opt = common.adam(
            [p for m in self.models.values() for p in m.parameters()],
            common.exponential_lr(cfg["learning_rate"],
                                  cfg["learning_rate_decay"]))
        if fault == "frozen":
            self.opt.step = lambda: None
        coarse = self.models["coarse"]
        self.step_fn = make_train_step(
            coarse, self.models.get("fine", coarse), self.opt,
            {k: cfg[k] for k in ("use_fine_model", "use_alpha", "render_near",
                                 "render_far", "render_coarse_sample_num",
                                 "render_fine_sample_num")}, device)
        self.fault = fault

    def step(self, batch, jitter):
        if self.fault == "half":
            half = batch.shape[0] // 2
            batch, jitter = batch[:half], jitter[:half]
        return self.step_fn(batch, jitter=jitter)["loss"]

    def first_grads(self) -> dict:
        """The first gradient, as Adam's first moment after one update
        holds it: exp_avg / (1 - beta1)."""
        b1 = self.opt.opt.param_groups[0]["betas"][0]
        state = self.opt.opt.state
        return {k: (state[p]["exp_avg"] / (1.0 - b1) if p in state
                    else torch.zeros_like(p)).detach().clone()
                for k, p in model_leaves(self.models).items()}

    def leaves(self) -> dict:
        return {k: p.detach().clone()
                for k, p in model_leaves(self.models).items()}


class Control:
    """The reference in the program's place, one precision step below the
    configuration's in every part: fp8 MLP products for bf16, TF32 for
    fp32."""

    def __init__(self, cfg, weights, device, fault=None):
        prec = lower(cfg["precision"]["mlp_train"])
        self.trainer = ref.Trainer(weights, cfg, {"mlp_fwd": prec,
                                                  "mlp_bwd": prec})

    def step(self, batch, jitter):
        with tensor_cores(lower(self.trainer.cfg["precision"]["render"])):
            return self.trainer.step(batch, jitter)

    def first_grads(self):
        return self.trainer.first

    def leaves(self):
        return self.trainer.leaves()


SUTS = {"program": (Program, None), "control": (Control, None),
        "fault_frozen": (Program, "frozen"), "fault_half": (Program, "half")}


class Driver:
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, sut="program"):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.sut_kind = SUTS[sut]
        self.batch = int(traffic["batch_rays"])
        self.items_per_step = self.batch
        self.first = int(traffic["first_steps"])
        self.losses = []

    def _rays(self) -> torch.Tensor:
        """``[views * H * W, 10]`` rows (origin, direction, rgba), shuffled."""
        width, height, focal = image_geometry(self.cfg)
        poses = orbit_poses(self.cfg, int(self.traffic["views"]),
                            inputs.host_rng(self.seed, inputs.SCENE))
        rays_o, rays_d = inputs.pixel_rays(poses.to(self.device), width,
                                           height, focal)
        gen = inputs.generator(self.device, self.seed, inputs.SCENE)
        n = rays_o.shape[0] * rays_o.shape[1]
        rgba = torch.rand((n, 4), generator=gen, device=self.device)
        rows = torch.cat([rays_o.reshape(n, 3), rays_d.reshape(n, 3), rgba],
                         dim=1)
        del rays_o, rays_d, rgba
        return rows[torch.randperm(n, generator=gen, device=self.device)]

    def _feed(self, k: int):
        lo = (k % (self.rays.shape[0] // self.batch)) * self.batch
        jitter = torch.rand((self.batch, self.cfg["render_coarse_sample_num"]),
                            generator=self.feed_gen, device=self.device)
        return self.rays[lo:lo + self.batch], jitter

    def setup(self):
        self.weights = field_weights(self.cfg, self.traffic, self.seed,
                                     self.device)
        self.rays = self._rays()
        self.feed_gen = inputs.generator(self.device, self.seed, inputs.FEED)
        cls, fault = self.sut_kind
        self.sut = cls(self.cfg, self.weights, self.device, fault)
        self.first_inputs, self.first_losses = [], []
        for k in range(self.first + int(self.traffic["warmup_steps"])):
            batch, jitter = self._feed(k)
            loss = self.sut.step(batch, jitter)
            if k < self.first:
                self.first_inputs.append((batch.clone(), jitter.clone()))
                self.first_losses.append(loss)
            if k == 0:
                self.first_grad = self.sut.first_grads()
            if k == self.first - 1:
                self.after = self.sut.leaves()
        self.next = self.first + int(self.traffic["warmup_steps"])

    def step(self, i, mark):
        batch, jitter = self._feed(self.next + i)
        self.losses.append(self.sut.step(batch, jitter))

    def outcome(self) -> tuple:
        losses = torch.stack(self.losses)
        return len(self.losses), int((~torch.isfinite(losses)).sum())

    def release(self):
        self.first_losses = [float(v) for v in self.first_losses]
        del self.sut, self.rays, self.losses

    def readings(self) -> dict:
        """The first steps' losses, the first gradient and the change of
        the leaves over those steps, against the reference's from the same
        weights and inputs.

        ``grad_error_ratio`` is the median leaf's error of the first
        gradient in units of the error that the reference itself makes on
        this seed at the configuration's stated MLP precision: how large
        a stated-precision error is swings several-fold from seed to seed
        (with how far the random weights saturate the sigmoids and relus),
        and the ratio takes that out."""
        stated = self.cfg["precision"]["mlp_train"]
        with plain_float32():
            trainer = ref.Trainer(self.weights, self.cfg)
            ref_losses = [float(trainer.step(b, j))
                          for b, j in self.first_inputs]
            yardstick = ref.Trainer(self.weights, self.cfg,
                                    {"mlp_fwd": stated, "mlp_bwd": stated})
            yardstick.step(*self.first_inputs[0])
        ref_after = trainer.leaves()
        moving = compare.moving_leaves(trainer.first)
        error = compare.median_leaf_error(self.first_grad, trainer.first,
                                          moving)
        return {
            "first_loss_gap": compare.rel_gap(self.first_losses[:1],
                                              ref_losses[:1]),
            "loss_gap": compare.rel_gap(self.first_losses, ref_losses),
            "grad_gap": compare.leaf_gap(self.first_grad, trainer.first),
            "grad_error": error,
            "grad_error_ratio": error / max(compare.median_leaf_error(
                yardstick.first, trainer.first, moving), 1e-30),
            "change_gap": compare.leaf_gap(
                compare.change(self.after, self.weights),
                compare.change(ref_after, self.weights), moving),
        }
