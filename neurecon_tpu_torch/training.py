"""Render-side training machinery (port of `neurecon_tpu/training.py`).

This slice carries `render_full_image`, which the validation render and
`tools/render_view.py` use. The train step, `microchunk` and the multi-device
render wait for the training slice (ROADMAP Queue A, item 5).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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
