"""Inverse-CDF sampling along rays, and opacities to visibility weights."""
from __future__ import annotations

import numpy as np
import torch


def linspace01(n: int, device=None) -> torch.Tensor:
    """n points from 0 to 1: i * float32(1 / (n - 1)), the last exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    return torch.cat([t, torch.ones(1, device=device)])


def _invert_cdf(bins, cdf, u, eps: float):
    """Depths at the quantiles u [..., N] of cdf [..., M] (leading 0) over
    bins [..., M]: the count of cdf entries below each u, then a lerp."""
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=False)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def sample_pdf(bins, weights, u, eps: float = 1e-5):
    """Depths at the quantiles u of the per-bin weights [..., M-1]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return _invert_cdf(bins, cdf, u, eps)


def sample_cdf(bins, cdf, u, eps: float = 1e-5):
    """Depths at u from a monotone CDF over the first M-1 bins (unsorted u)."""
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return _invert_cdf(bins, cdf, u, eps)


def alpha_to_w(alpha):
    """Opacities [..., P] -> alpha times the exclusive product of
    max(1 - alpha, 0) + 1e-10."""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         torch.clamp(1.0 - alpha, min=0.0) + 1e-10], dim=-1)
    return alpha * torch.cumprod(shifted, dim=-1)[..., :-1]
