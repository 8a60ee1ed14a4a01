"""Inverse-CDF sampling along rays (port of `neurecon_tpu/ops/sampling.py`).

The uniforms are always supplied by the caller: the det linspace or sorted
draws from a `torch.Generator` are made where the sampler is called, so the
same u can be handed to the JAX package and to the port.

`alpha_to_w` (opacities to visibility weights) lives here because both the
renderer and the upsampler's plain version weight their samples with it.
"""
from __future__ import annotations

import numpy as np
import torch

# Above this many compares per row the [..., N, M] comparison matrix is too
# large (the VolSDF fine sampler's would be ~1.9 GB per round at its flagship
# widths): rows go through torch.searchsorted instead. The JAX package's
# threshold (neurecon_tpu/ops/sampling.py, _COUNT_SEARCH_LIMIT).
COUNT_SEARCH_LIMIT = 1 << 18


def linspace01(n: int, device=None) -> torch.Tensor:
    """jnp.linspace(0, 1, n) to the bit: i * float32(1 / (n - 1)), the last
    entry exactly 1 (torch.linspace rounds some entries the other way)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    t[-1] = 1.0
    return t


def stratified_jitter(vals, u):
    """One value in each stratum around the sorted vals [..., K] (the
    midpoints as bounds, the ends as the outer bounds), at the uniforms u
    [..., K]: the NeRF++ outside samples' jitter."""
    mids = 0.5 * (vals[..., 1:] + vals[..., :-1])
    upper = torch.cat([mids, vals[..., -1:]], dim=-1)
    lower = torch.cat([vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def searchsorted(a, v, side: str = "left"):
    """Batched insertion indices: a [..., M] (sorted), v [..., N] -> [..., N].

    As the JAX package computes it: side="left" counts the a < v,
    side="right" the a <= v. A comparison count up to COUNT_SEARCH_LIMIT
    compares per row, torch.searchsorted (the same counts on sorted rows)
    above it.
    """
    if side not in ("left", "right"):
        raise ValueError(side)
    M, N = a.shape[-1], v.shape[-1]
    if M * N > COUNT_SEARCH_LIMIT:
        batch = torch.broadcast_shapes(a.shape[:-1], v.shape[:-1])
        return torch.searchsorted(a.expand(batch + (M,)).contiguous(),
                                  v.expand(batch + (N,)).contiguous(),
                                  right=side == "right")
    if side == "left":
        cmp = a[..., None, :] < v[..., :, None]
    else:
        cmp = a[..., None, :] <= v[..., :, None]
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


def sample_cdf(bins, cdf, u, eps: float = 1e-5):
    """Like sample_pdf, from an (unnormalized, monotone) CDF over the first
    M-1 bins: cdf [..., M-1], a leading 0 prepended here. The uniforms are
    taken as given (VolSDF's opacity draws pass them unsorted)."""
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return _invert_cdf(bins, cdf, u, eps)


def alpha_to_w(alpha):
    """alpha [..., P] -> visibility weights: alpha * exclusive cumprod of
    max(1 - alpha, 0) + 1e-10."""
    shifted_transparency = torch.cat(
        [torch.ones_like(alpha[..., :1]),
         torch.clamp(1.0 - alpha, min=0.0) + 1e-10], dim=-1)
    return alpha * torch.cumprod(shifted_transparency, dim=-1)[..., :-1]
