"""Ray generation and ray/sphere geometry (port of `neurecon_tpu/ops/ray.py`).

Full-image rays (the render), random pixel batches drawn from a
`torch.Generator` (training), rays at given pixels, the conservative
bounding-sphere near/far, and the exact ray-sphere geometry of the NeRF++
background (`get_sphere_intersection`, `get_dvals_from_radius`).
"""
from __future__ import annotations

from typing import Optional

import torch


def lift(x, y, z, intrinsics):
    """Lift pixel coords (+depth z) to homogeneous camera coords, with skew.
    x, y, z: [..., N]; intrinsics [..., 4, 4]. Returns [..., N, 4]."""
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    sk = intrinsics[..., 0, 1][..., None]

    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def _rays_from_pixels(i, j, c2w, intrinsics):
    """i, j: [..., N] pixel x (width) / y (height) coords; c2w and
    intrinsics [..., 4, 4]. Returns (rays_o, rays_d) [..., N, 3]."""
    pts_cam = lift(i, j, torch.ones_like(i), intrinsics)      # [..., N, 4]
    # world = c2w @ pts, summed in column order like the reference einsum
    col = lambda k: c2w[..., None, :3, k]
    world = (col(0) * pts_cam[..., 0:1] + col(1) * pts_cam[..., 1:2]
             + col(2) * pts_cam[..., 2:3] + col(3) * pts_cam[..., 3:4])
    cam_loc = c2w[..., None, :3, 3]
    rays_d = world - cam_loc
    return cam_loc.expand_as(rays_d), rays_d


def get_rays(c2w, intrinsics, H: int, W: int, N_rays: int = -1,
             generator: Optional[torch.Generator] = None):
    """Rays of one camera (or a batch of cameras).

    c2w, intrinsics: [..., 4, 4] float32 tensors on the render device.
    N_rays > 0: random pixels, the H and W indices drawn independently, with
    replacement, from `generator` (on the tensors' device), shared across the
    batch dims. N_rays <= 0: all H*W pixels in row-major order.
    Returns (rays_o [..., N, 3], rays_d [..., N, 3], select_inds [..., N]);
    rays_d is NOT normalized — the renderer normalizes it.
    """
    dev = c2w.device
    prefix = c2w.shape[:-2]
    if N_rays > 0:
        N_rays = min(N_rays, H * W)
        select_hs = torch.randint(0, H, (N_rays,), generator=generator, device=dev)
        select_ws = torch.randint(0, W, (N_rays,), generator=generator, device=dev)
        select_inds = select_hs * W + select_ws
        i, j = select_ws.float(), select_hs.float()
    else:
        j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                              torch.arange(W, dtype=torch.float32, device=dev),
                              indexing="ij")
        i, j = i.reshape(-1), j.reshape(-1)
        select_inds = torch.arange(H * W, device=dev)
    n = i.shape[0]
    i, j = i.expand(*prefix, n), j.expand(*prefix, n)
    rays_o, rays_d = _rays_from_pixels(i, j, c2w, intrinsics)
    return rays_o, rays_d, select_inds.expand(*prefix, n)


def get_rays_at(select_inds, c2w, intrinsics, H: int, W: int):
    """Rays at explicit flat pixel indices [..., N] (row-major)."""
    i = (select_inds % W).float()
    j = torch.div(select_inds, W, rounding_mode="floor").float()
    return _rays_from_pixels(i, j, c2w, intrinsics)


def near_far_from_sphere(rays_o, rays_d, r: float = 1.0, keepdim: bool = True):
    """Conservative near/far from a bounding sphere of radius r.
    rays_d must already be normalized. near >= 0, far >= r."""
    mid = -torch.sum(rays_o * rays_d, dim=-1, keepdim=keepdim)
    near = torch.clamp(mid - r, min=0.0)
    far = torch.clamp(mid + r, min=r)
    return near, far


def get_sphere_intersection(rays_o, rays_d, r: float = 1.0):
    """Exact ray-sphere intersections. rays_d normalized. Returns (near,
    far, mask_intersect) [..., 1]; near and far are zero where the ray
    misses the sphere, and clamped at 0."""
    rayso_norm_sq = torch.sum(rays_o ** 2, dim=-1, keepdim=True)
    ray_cam_dot = torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot ** 2 + r ** 2 - rayso_norm_sq
    mask_intersect = under_sqrt > 0
    sqrt = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    zero = torch.zeros_like(sqrt)
    near = torch.where(mask_intersect, -sqrt - ray_cam_dot, zero)
    far = torch.where(mask_intersect, sqrt - ray_cam_dot, zero)
    return torch.clamp(near, min=0.0), torch.clamp(far, min=0.0), mask_intersect


def get_dvals_from_radius(rays_o, rays_d, rs, far_end: bool = True):
    """Depth along the ray at which |o + d t| == rs (the NeRF++ outside
    points): rays [..., 3] (d normalized), rs [..., N] -> [..., N]; the far
    root, or the near one clamped at 0."""
    rayso_norm_sq = torch.sum(rays_o ** 2, dim=-1, keepdim=True)
    ray_cam_dot = torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    under_sqrt = rs ** 2 - (rayso_norm_sq - ray_cam_dot ** 2)
    sqrt = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    if far_end:
        return -ray_cam_dot + sqrt
    return torch.clamp(-ray_cam_dot - sqrt, min=0.0)


def lin2img(tensor, H: int, W: int):
    """[..., H*W, C] -> [..., H, W, C] (HWC, as the JAX package keeps it)."""
    *prefix, n, c = tensor.shape
    if n != H * W:
        raise ValueError(f"{n} pixels, want {H} x {W}")
    return tensor.reshape(*prefix, H, W, c)
