"""Training-step machinery (port of `neurecon_tpu/training.py`).

One eager step: zero the grads, loss, backward, Adam step, scheduler step.
Metrics stay on the device (the loop fetches them every `i_log` steps), so no
step waits on the host. `render_full_image` is the chunked render of the
validation images and `tools/render_view.py`. `microchunk` and the
multi-device render are not ported (ROADMAP Queue A, items 6 and 7).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def sample_ray_batch(generator, batch, H: int, W: int, N_rays: int):
    """N_rays random pixels of an image batch, drawn on its device.

    batch: {'c2w' [B,4,4], 'intrinsics' [B,4,4], 'rgb' [B,H*W,3], optional
    'object_mask' / 'mask_ignore' [B,H*W]}. Returns a ray batch whose arrays
    all have the ray axis at dim 1."""
    from neurecon_tpu_torch.ops import get_rays

    rays_o, rays_d, select_inds = get_rays(batch["c2w"], batch["intrinsics"], H, W,
                                           N_rays=N_rays, generator=generator)
    rb = {"rays_o": rays_o, "rays_d": rays_d,
          "target_rgb": torch.gather(
              batch["rgb"], -2, select_inds[..., None].expand(*select_inds.shape, 3))}
    for k, out in (("object_mask", "target_mask"), ("mask_ignore", "mask_ignore")):
        if k in batch:
            rb[out] = torch.gather(batch[k], -1, select_inds)
    return rb


def grad_norms_by_module(model) -> Dict[str, torch.Tensor]:
    """Global grad norm per top-level entry of the JAX pytree (`ln_s` or
    `ln_beta`, `implicit_surface`, `radiance_net`), as a device tensor each."""
    sq = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            top = name.split(".")[0]
            sq[top] = sq.get(top, 0.0) + torch.sum(p.grad.float() ** 2)
    return {k: torch.sqrt(v) for k, v in sq.items()}


# intermediates whose mean/min/max/norm are logged (as the JAX package does)
_EXTRAS_STAT_KEYS = ("radiance", "alpha", "implicit_surface",
                     "implicit_nablas_norm", "sigma_out", "radiance_out")


def extras_stats(extras) -> Dict[str, torch.Tensor]:
    """mean/min/max/norm of the render intermediates, on the device."""
    out = {}
    if not isinstance(extras, dict):
        return out
    for n in _EXTRAS_STAT_KEYS:
        v = extras.get(n)
        if v is None:
            continue
        v = v.detach().float()
        out[f"{n}.mean"] = v.mean()
        out[f"{n}.min"] = v.min()
        out[f"{n}.max"] = v.max()
        out[f"{n}.norm"] = torch.sqrt(torch.sum(v * v))
    return out


def make_train_step(loss_fn: Callable, model, optimizer, scheduler) -> Callable:
    """loss_fn(batch, generator, it) -> (total, (losses, extras)).

    Returns step(batch, generator, it) -> metrics: the step's losses,
    per-module grad norms, extras['scalars'] and the intermediates' stats,
    all as device tensors (nothing is fetched here)."""

    def step(batch, generator, it):
        optimizer.zero_grad(set_to_none=True)
        total, (losses, extras) = loss_fn(batch, generator, it)
        total.backward()
        metrics = {"losses": {k: v.detach() for k, v in losses.items()},
                   "grad_norms": grad_norms_by_module(model),
                   "extras_stats": extras_stats(extras)}
        optimizer.step()
        scheduler.step()
        if isinstance(extras, dict) and "scalars" in extras:
            metrics["scalars"] = extras["scalars"]
        return metrics

    return step


def fast_forward_schedule(optimizer, scheduler, step: int) -> None:
    """Resume the lr schedule at `step` for a checkpoint that brings
    parameters but no optimizer state, as the JAX package sets every optax
    `count` to `step`: the scheduler's count and each group's lr, and Adam's
    per-parameter step (its bias correction) with fresh zero moments."""
    scheduler.last_epoch = step
    for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(step)
    scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


def render_full_image(render_fn, rays_o, rays_d, *, rayschunk: int = 4096,
                      generator: Optional[torch.Generator] = None,
                      cull_sphere_r: Optional[float] = None,
                      miss_rgb: float = 0.0):
    """Render all rays of an image in chunks of `rayschunk` rays.

    render_fn: (rays_o [n,3], rays_d [n,3], generator) -> (rgb, depth,
    extras). Returns a dict of host numpy arrays, one row per ray.

    `cull_sphere_r`: only rays that pass within that radius of the origin go
    through the network; the others get `miss_rgb` and zeros (their depth
    and extras are visualization-only).
    """
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    N = rays_o.shape[0]

    if cull_sphere_r:
        o_np = rays_o.detach().cpu().numpy().astype(np.float64)
        d_np = rays_d.detach().cpu().numpy().astype(np.float64)
        dn = d_np / np.linalg.norm(d_np, axis=-1, keepdims=True)
        t_mid = -np.sum(o_np * dn, axis=-1)
        closest = o_np + t_mid[:, None] * dn
        hit = ((np.linalg.norm(closest, axis=-1) <= cull_sphere_r)
               & (t_mid + cull_sphere_r > 0))
        if not hit.all():
            hit_idx = np.nonzero(hit)[0]
            # zero hits: run one ray through to learn the output structure
            probe_idx = hit_idx if hit_idx.size else np.asarray([0])
            idx_t = torch.as_tensor(probe_idx, device=rays_o.device)
            sub = render_full_image(render_fn, rays_o[idx_t], rays_d[idx_t],
                                    rayschunk=rayschunk, generator=generator)
            out = {}
            for k, v in sub.items():
                full = np.zeros((N,) + v.shape[1:], v.dtype)
                if k == "rgb":
                    full[...] = miss_rgb
                if hit_idx.size:
                    full[hit_idx] = v
                out[k] = full
            return out

    outs = []
    with torch.no_grad():
        for i in range(0, N, rayschunk):
            rgb, depth, extras = render_fn(rays_o[i:i + rayschunk],
                                           rays_d[i:i + rayschunk], generator)
            chunk = {"rgb": rgb, "depth_volume": depth}
            chunk.update({k: v for k, v in extras.items()
                          if k not in ("rgb", "depth_volume")})
            outs.append({k: v.cpu().numpy() for k, v in chunk.items()})
    return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
