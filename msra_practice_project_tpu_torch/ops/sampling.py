"""Depth sampling along rays: stratified coarse pass and inverse-CDF fine pass
(port of ``msra_practice_project_tpu/ops/sampling.py``).

The CDF inversion uses ``searchsorted`` + ``gather``; the JAX package's
one-hot contraction is a TPU device and has no place here.
"""

from __future__ import annotations

import torch


def stratified_samples(near, far, n_samples: int, batch_shape,
                       perturb: bool = True, *,
                       generator: torch.Generator | None = None,
                       jitter: torch.Tensor | None = None,
                       device=None, dtype=torch.float32):
    """Linspace z in [near, far] with per-interval uniform jitter
    (ref: nerf/render.py:123,127-132).

    Returns (z_vals ``[*batch_shape, n]``, mids ``[*batch_shape, n-1]``);
    ``mids`` are midpoints of the unjittered grid, the bins ``sample_pdf``
    takes.  The jitter is ``jitter`` when given (``[*batch_shape, n]`` in
    [0, 1)), else drawn from ``generator``.
    """
    z = torch.linspace(near, far, n_samples, dtype=dtype, device=device)
    z = z.expand(*batch_shape, n_samples)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    if not perturb:
        return z, mids
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    if jitter is None:
        jitter = torch.rand(z.shape, generator=generator, dtype=dtype,
                            device=z.device)
    return lower + (upper - lower) * jitter, mids


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int):
    """Inverse-CDF importance sampling (ref: nerf/render.py:27-56).

    bins:    ``[..., B]`` bin edges (the B = n_coarse - 1 midpoints).
    weights: ``[..., B-1]`` unnormalised pdf over the B-1 intervals.

    ``u`` is a uniform linspace, as in the reference: deterministic
    quadrature of the CDF.  Inputs are detached (the reference detaches the
    result).
    """
    if weights.shape[-1] != bins.shape[-1] - 1:
        raise ValueError(
            f"sample_pdf expects len(weights) == len(bins)-1, got "
            f"{weights.shape[-1]} vs {bins.shape[-1]}")
    bins = bins.detach()
    weights = weights.detach() + 1e-5

    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    # explicit leading zero: also right when weights is empty (nc=2)
    cdf = torch.cat([cdf.new_zeros(*cdf.shape[:-1], 1), cdf], dim=-1)
    L = cdf.shape[-1]

    u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                       device=cdf.device)
    u = u.expand(*cdf.shape[:-1], n_samples).contiguous()

    # #{cdf <= u}, as the JAX comparison count
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(0, L - 1)
    above = inds.clamp(0, L - 1)

    bins = bins.expand(*cdf.shape[:-1], L)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
