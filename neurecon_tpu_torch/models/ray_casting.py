"""Ray casting (port of `neurecon_tpu/models/ray_casting.py`): root finding
(a coarse march, the first sign change by the cost-matrix argmin, fixed
secant steps), sphere tracing, and the fast surface renderer.

Every fixed-trip iteration runs on all rays with masked updates, as in the
JAX package. The sdf queries go through `forward_surface_fast` (the sdf-only
CUDA kernel on a card); the hit-point query is the model's `forward`
(forward+nablas kernel and the radiance net). Everything runs without a graph.
The root find's march and secant steps open the spans `cast.march` and
`cast.secant` (`utils/trace.py`), so a trace separates the root find's host
time from the rest of a framework's sampler.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from neurecon_tpu_torch.ops.sampling import linspace01
from neurecon_tpu_torch.utils.trace import span


def run_secant(f_low, f_high, d_low, d_high, rays_o, rays_d,
               query_fn: Callable, n_steps: int, logit_tau: float):
    """Fixed n_steps secant iterations, vectorized over all rays.

    f_low < 0 < f_high by construction on valid rays; the division is guarded
    so invalid lanes produce finite values that callers mask away."""
    def secant_step(f_low, f_high, d_low, d_high):
        denom = f_high - f_low
        denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        return -f_low * (d_high - d_low) / denom + d_low

    d_pred = secant_step(f_low, f_high, d_low, d_high)
    for _ in range(n_steps):
        p_mid = rays_o + d_pred[..., None] * rays_d
        f_mid = query_fn(p_mid) - logit_tau
        ind_low = f_mid < 0
        d_low = torch.where(ind_low, d_pred, d_low)
        f_low = torch.where(ind_low, f_mid, f_low)
        d_high = torch.where(ind_low, d_high, d_pred)
        f_high = torch.where(ind_low, f_high, f_mid)
        d_pred = secant_step(f_low, f_high, d_low, d_high)
    return d_pred


@torch.no_grad()
def root_finding_surface_points(
        surface_query_fn: Callable,
        rays_o: torch.Tensor, rays_d: torch.Tensor,
        near: Union[float, torch.Tensor] = 0.0,
        far: Union[float, torch.Tensor] = 6.0,
        N_steps: int = 256,
        logit_tau: float = 0.0,
        method: str = "secant",
        N_secant_steps: int = 8,
        fill_inf: bool = True):
    """The first + -> - crossing of (surface_query - logit_tau) per ray.

    rays_o/rays_d: [..., 3] (rays_d normalized); near/far scalar or [...].
    Returns (d_pred_out [...], pt_pred [..., 3], mask [...],
    mask_sign_change [...]). Misses get +inf (or far without fill_inf); rays
    whose first sample is inside get 0; pt_pred is (1, 1, 1) on misses."""
    prefix = rays_o.shape[:-1]
    dev = rays_o.device
    near = torch.broadcast_to(torch.as_tensor(near, dtype=torch.float32, device=dev), prefix)
    far = torch.broadcast_to(torch.as_tensor(far, dtype=torch.float32, device=dev), prefix)

    def take(a, idx):
        return torch.gather(a, -1, idx[..., None])[..., 0]

    with span("cast.march"):
        t = linspace01(N_steps, dev)
        d_proposal = near[..., None] * (1 - t) + far[..., None] * t  # [..., S]
        p_proposal = rays_o[..., None, :] + d_proposal[..., :, None] * rays_d[..., None, :]

        val = surface_query_fn(p_proposal) - logit_tau  # [..., S]
        mask_0_not_occupied = val[..., 0] > 0

        # cost-matrix argmin: the first sign change wins (earlier indices get a
        # larger magnitude); torch.argmin, like jnp.argmin, takes the first of
        # equal minima, which decides ties between zero products
        sign_matrix = torch.cat([torch.sign(val[..., :-1] * val[..., 1:]),
                                 torch.ones(prefix + (1,), device=dev)], -1)
        cost_matrix = sign_matrix * torch.arange(N_steps, 0, -1, dtype=torch.float32, device=dev)
        values = cost_matrix.min(-1).values
        indices = torch.argmin(cost_matrix, -1)

        mask_sign_change = values < 0
        mask_pos_to_neg = take(val, indices) > 0
        mask = mask_sign_change & mask_pos_to_neg & mask_0_not_occupied

        d_high, f_high = take(d_proposal, indices), take(val, indices)
        ind1 = torch.clamp(indices + 1, max=N_steps - 1)
        d_low, f_low = take(d_proposal, ind1), take(val, ind1)

    if method == "secant":
        with span("cast.secant"):
            d_pred = run_secant(f_low, f_high, d_low, d_high, rays_o, rays_d,
                                surface_query_fn, N_secant_steps, logit_tau)
    else:
        d_pred = torch.ones(prefix, device=dev)

    pt_pred = torch.where(mask[..., None], rays_o + d_pred[..., None] * rays_d,
                          torch.ones(prefix + (3,), device=dev))
    miss_val = torch.full(prefix, float("inf"), device=dev) if fill_inf else far
    d_pred_out = torch.where(mask, d_pred, miss_val)
    d_pred_out = torch.where(mask_0_not_occupied, d_pred_out, torch.zeros_like(d_pred_out))
    return d_pred_out, pt_pred, mask, mask_sign_change


@torch.no_grad()
def sphere_tracing_surface_points(
        surface_query_fn: Callable,
        rays_o: torch.Tensor, rays_d: torch.Tensor,
        near: float = 0.0, far: float = 6.0,
        N_iters: int = 20):
    """Fixed-iteration sphere tracing: d += sdf(o + d dir) where the mask
    holds, then the mask narrows to 0 <= d <= far (in that order).

    Returns (d_preds [...], pts [..., 3], mask [...])."""
    prefix = rays_o.shape[:-1]
    d_preds = torch.full(prefix, float(near), device=rays_o.device)
    mask = torch.ones(prefix, dtype=torch.bool, device=rays_o.device)
    for _ in range(N_iters):
        pts = rays_o + rays_d * d_preds[..., None]
        surface_val = surface_query_fn(pts)
        d_preds = torch.where(mask, d_preds + surface_val, d_preds)
        mask = mask & (d_preds <= far) & (d_preds >= 0)
    pts = rays_o + rays_d * d_preds[..., None]
    return d_preds, pts, mask


def make_surface_render_fn(model, ray_casting_algo: str = "sphere_tracing",
                           ray_casting_cfgs: dict = None,
                           use_view_dirs: bool = True,
                           calc_normal: bool = True):
    """Eval-time renderer: cast to the surface, query the radiance once at
    the hit point. (rays_o, rays_d, generator=None) -> (rgb, depth, extras),
    the volume renderers' signature; it is deterministic and ignores the
    generator."""
    cfgs = dict(ray_casting_cfgs or {})
    if ray_casting_algo not in ("root_finding", "sphere_tracing"):
        raise NotImplementedError(ray_casting_algo)

    @torch.no_grad()
    def render(rays_o, rays_d, generator=None):
        prefix = rays_o.shape[:-1]
        rays_o = rays_o.reshape(-1, 3).float()
        rays_d = rays_d.reshape(-1, 3).float()
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        view_dirs = rays_d if use_view_dirs else None
        query = model.forward_surface_fast

        if ray_casting_algo == "root_finding":
            d_pred, pt_pred, mask, _ = root_finding_surface_points(
                query, rays_o, rays_d, **cfgs)
        else:
            d_pred, pt_pred, mask = sphere_tracing_surface_points(
                query, rays_o, rays_d, **cfgs)

        color, _, nablas = model(pt_pred, view_dirs)
        color = torch.where(mask[..., None], color, torch.zeros_like(color))  # black background

        extras = {"implicit_nablas": nablas, "mask_surface": mask}
        if calc_normal:
            normals = nablas / (torch.linalg.norm(nablas, dim=-1, keepdim=True) + 1e-10)
            extras["normals_surface"] = torch.where(mask[..., None], normals,
                                                    torch.zeros_like(normals))
        color = color.reshape(prefix + (3,))
        d_pred = d_pred.reshape(prefix)
        extras = {k: v.reshape(prefix + v.shape[1:]) for k, v in extras.items()}
        return color, d_pred, extras

    return render
