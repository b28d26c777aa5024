"""Adam written out (Kingma and Ba, arXiv:1412.6980, Algorithm 1), over a
dict of float32 leaves, with the per-step learning-rate schedules of the two
configurations."""

from __future__ import annotations

import torch


def exponential_lr(base: float, decay_thousands: float, rate: float = 0.1):
    """NeRF's: base * rate^(count / (decay_thousands * 1000))."""
    return lambda count: base * rate ** (count / (decay_thousands * 1000.0))


def interp_lr(lr0: float, lr_end: float, decay_thousands: float,
              rate: float = 0.1):
    """pi-GAN's: lr_end + (lr0 - lr_end) * rate^(count / (decay * 1000))."""
    return lambda count: lr_end + (lr0 - lr_end) * rate ** (
        count / (decay_thousands * 1000.0))


class Adam:
    """m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2;
    p <- p - lr(count) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps),
    with ``count`` the updates applied before this one."""

    def __init__(self, params: dict, schedule, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.schedule = params, schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict):
        lr = self.schedule(self.count)
        self.count += 1
        t = self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            m_hat = self.m[k] / (1.0 - self.b1 ** t)
            v_hat = self.v[k] / (1.0 - self.b2 ** t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + self.eps))
