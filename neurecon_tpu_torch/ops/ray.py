"""Ray generation and ray/sphere geometry (port of `neurecon_tpu/ops/ray.py`).

This slice carries full-image rays (`N_rays=-1`, the render path) and the
conservative bounding-sphere near/far. Random pixel batches belong to the
training slice.
"""
from __future__ import annotations

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


def get_rays(c2w, intrinsics, H: int, W: int, N_rays: int = -1):
    """All H*W rays of one camera in row-major pixel order.

    c2w, intrinsics: [4, 4] float32 tensors on the render device. Returns
    (rays_o [H*W, 3], rays_d [H*W, 3], select_inds [H*W]); rays_d is NOT
    normalized — the renderer normalizes it.
    """
    if N_rays > 0:
        raise NotImplementedError(
            "random ray batches belong to the training slice (ROADMAP Queue "
            "A, item 5); the render path uses N_rays=-1")
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    pts_cam = lift(i, j, torch.ones_like(i), intrinsics)      # [N, 4]
    # world = c2w @ pts, summed in column order like the reference einsum
    world = (c2w[:3, 0] * pts_cam[:, 0:1] + c2w[:3, 1] * pts_cam[:, 1:2]
             + c2w[:3, 2] * pts_cam[:, 2:3] + c2w[:3, 3] * pts_cam[:, 3:4])
    cam_loc = c2w[:3, 3]
    rays_d = world - cam_loc
    rays_o = cam_loc.expand_as(rays_d)
    select_inds = torch.arange(H * W, device=dev)
    return rays_o, rays_d, select_inds


def near_far_from_sphere(rays_o, rays_d, r: float = 1.0, keepdim: bool = True):
    """Conservative near/far from a bounding sphere of radius r.
    rays_d must already be normalized. near >= 0, far >= r."""
    mid = -torch.sum(rays_o * rays_d, dim=-1, keepdim=keepdim)
    near = torch.clamp(mid - r, min=0.0)
    far = torch.clamp(mid + r, min=r)
    return near, far
