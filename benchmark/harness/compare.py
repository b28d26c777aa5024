"""The numbers that decide ``correct``, each the widest gap between what the
system under test produced and what the plain reference works out.

Training (per leaf, worst leaf): the gap between the two norms, not the norm
of their difference, over the reference's norm of that leaf or of the median
leaf, whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone and are
left out of the change.
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "msra_practice_project_tpu")
NEGLIGIBLE_GRAD = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in leaves.items()}


def leaf_gap(sut: dict, ref: dict, names=None) -> float:
    """max over leaves of | |sut| - |ref| | / max(|ref|, median |ref|)."""
    names = list(ref) if names is None else list(names)
    if not names:
        return 0.0
    r, s = _norms({k: ref[k] for k in names}), _norms({k: sut[k]
                                                        for k in names})
    med = statistics.median(r.values())
    return max(abs(s[k] - r[k]) / max(r[k], med, 1e-30) for k in names)


def median_leaf_error(sut: dict, ref: dict, names) -> float:
    """The median over leaves of |sut - ref| / |ref|: a number steady from
    seed to seed, where the worst leaf swings with the few rays whose
    importance samples an ulp moves."""
    errors = [float(torch.linalg.vector_norm((sut[k] - ref[k]).double())
                    / torch.linalg.vector_norm(ref[k].double()))
              for k in names]
    return statistics.median(errors) if errors else 0.0


def moving_leaves(first_grad: dict) -> list:
    """The leaves whose reference gradient is above a thousandth of the
    median leaf's."""
    norms = _norms(first_grad)
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v > NEGLIGIBLE_GRAD * med]


def change(after: dict, before: dict) -> dict:
    return {k: after[k].double() - before[k].double() for k in after}


def rel_gap(values, refs) -> float:
    """max | v - r | / | r | over paired scalars."""
    return max(abs(float(v) - float(r)) / max(abs(float(r)), 1e-30)
               for v, r in zip(values, refs))


def _abs_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor | None:
    a, b = torch.as_tensor(a).double().reshape(-1), torch.as_tensor(b)
    if not bool(torch.isfinite(a).all()):
        return None
    return (a - b.double().reshape(-1).to(a.device)).abs()


def max_abs_gap(a, b) -> float:
    gaps = _abs_gaps(a, b)
    return math.inf if gaps is None else float(gaps.max())


def mean_abs_gap(a, b, keep: float = 1.0) -> float:
    """The mean of the smallest ``keep`` share of the gaps."""
    gaps = _abs_gaps(a, b)
    if gaps is None:
        return math.inf
    n = max(1, int(keep * gaps.numel()))
    return float(gaps.sort().values[:n].mean())


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every reading finite and within
    its limit, and every limit read."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, each compared whole (the port's name starts with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
