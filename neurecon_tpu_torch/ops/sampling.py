"""Inverse-CDF sampling along rays (port of `neurecon_tpu/ops/sampling.py`).

The uniforms are always supplied by the caller: the det linspace or sorted
draws from a `torch.Generator` are made where the sampler is called, so the
same u can be handed to the JAX package and to the port.

`alpha_to_w` (opacities to visibility weights) lives here because both the
renderer and the upsampler's plain version weight their samples with it.
"""
from __future__ import annotations

import torch


def searchsorted(a, v, side: str = "left"):
    """Batched insertion indices: a [..., M] (sorted), v [..., N] -> [..., N].

    A comparison count, as the JAX package computes it: side="left" counts
    the a < v, side="right" the a <= v.
    """
    if side == "left":
        cmp = a[..., None, :] < v[..., :, None]
    elif side == "right":
        cmp = a[..., None, :] <= v[..., :, None]
    else:
        raise ValueError(side)
    return cmp.sum(dim=-1)


def _invert_cdf(bins, cdf, u, eps: float):
    """Inverse-CDF lerp. bins [..., M], cdf [..., M] (leading 0 prepended),
    u [..., N]."""
    inds = searchsorted(cdf, u, side="left")
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def sample_pdf(bins, weights, u, eps: float = 1e-5):
    """NeRF hierarchical sampling: depths at the quantiles u of the per-bin
    weights. bins [..., M] sorted; weights [..., M-1]; u [..., N] in [0, 1]."""
    weights = weights + 1e-5  # prevent nans
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return _invert_cdf(bins, cdf, u, eps)


def alpha_to_w(alpha):
    """alpha [..., P] -> visibility weights: alpha * exclusive cumprod of
    max(1 - alpha, 0) + 1e-10."""
    shifted_transparency = torch.cat(
        [torch.ones_like(alpha[..., :1]),
         torch.clamp(1.0 - alpha, min=0.0) + 1e-10], dim=-1)
    return alpha * torch.cumprod(shifted_transparency, dim=-1)[..., :-1]
