"""The scene and the cameras of the benchmark, made on the device.

A lambertian sphere of `radius` at the origin, photographed by `n_images`
cameras on a ring of `cam_radius` around it (elevation 0.35 sin(3 theta)),
each looking at the origin through a pinhole of focal length
`focal_factor` * max(H, W) at the image centre; object masks are the rays
that hit. This is the analytic sphere writer of the program's synthetic
dataset (`dataio/synthetic.py`) rewritten to run on the card, so that no
file is read and set-up stays short. The novel views of the render traffic
lie on a circle of the same radius, at an azimuth and elevation drawn from
the seed.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.step import pixel_rays

LIGHT = (0.5, -0.7, -0.5)
ALBEDO = (0.8, 0.3, 0.25)


def look_at(loc: torch.Tensor) -> torch.Tensor:
    """c2w [4, 4] of a camera at `loc` looking at the origin, z forward, y
    down."""
    z = -loc / torch.linalg.norm(loc)
    up = torch.tensor([0.0, -1.0, 0.0], device=loc.device)
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    c2w = torch.eye(4, device=loc.device)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, loc
    return c2w


def intrinsics(H: int, W: int, focal_factor: float, device) -> torch.Tensor:
    k = torch.eye(4, device=device)
    k[0, 0] = k[1, 1] = focal_factor * max(H, W)
    k[0, 2], k[1, 2] = W / 2.0, H / 2.0
    return k


def ring_camera(theta: float, phi: float, radius: float, device) -> torch.Tensor:
    loc = radius * torch.tensor([math.cos(theta) * math.cos(phi), math.sin(phi),
                                 math.sin(theta) * math.cos(phi)], device=device)
    return look_at(loc)


def image_rays(c2w, intr, H: int, W: int):
    """All H*W rays of one camera in row-major order: (origins, unnormalized
    directions) [H*W, 3]."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    return pixel_rays(i.reshape(-1), j.reshape(-1), c2w, intr)


@torch.no_grad()
def make_scene(sc: dict, device) -> dict:
    """{"c2w", "intrinsics" [n, 4, 4], "rgb" [n, H*W, 3], "object_mask"
    [n, H*W] bool, "H", "W"} on the device."""
    n, H, W = int(sc["n_images"]), int(sc["H"]), int(sc["W"])
    radius = float(sc["radius"])
    intr = intrinsics(H, W, float(sc["focal_factor"]), device)
    light = torch.tensor(LIGHT, device=device)
    light = light / torch.linalg.norm(light)
    albedo = torch.tensor(ALBEDO, device=device)
    c2ws, rgbs, masks = [], [], []
    for k in range(n):
        theta = 2 * math.pi * k / n
        c2w = ring_camera(theta, 0.35 * math.sin(3 * theta), float(sc["cam_radius"]), device)
        o, d = image_rays(c2w, intr, H, W)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        b = torch.sum(o * d, dim=-1)
        disc = b * b - (torch.sum(o * o, dim=-1) - radius ** 2)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 0)
        normal = o + t[:, None] * d
        normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-10)
        lambert = torch.clamp(normal @ (-light), 0.0, 1.0)
        shade = (0.25 + 0.75 * lambert)[:, None] * albedo
        rgbs.append(torch.where(hit[:, None], shade, torch.zeros_like(shade)))
        masks.append(hit)
        c2ws.append(c2w)
    return {"c2w": torch.stack(c2ws), "intrinsics": intr.expand(n, 4, 4).contiguous(),
            "rgb": torch.stack(rgbs), "object_mask": torch.stack(masks), "H": H, "W": W}


def camera_path(sc: dict, n_frames: int, downscale: int, seed: int, device):
    """(c2w [n_frames, 4, 4], intrinsics [4, 4], H, W) of the novel views:
    a circle at the cameras' radius, starting at an azimuth and elevation
    drawn from the seed, at the images' resolution over `downscale`."""
    gen = torch.Generator().manual_seed(seed)
    theta0 = float(torch.rand(1, generator=gen)) * 2 * math.pi
    phi = (float(torch.rand(1, generator=gen)) * 2 - 1) * 0.3
    c2w = torch.stack([ring_camera(theta0 + 2 * math.pi * k / n_frames, phi,
                                   float(sc["cam_radius"]), device) for k in range(n_frames)])
    H, W = int(sc["H"]) // downscale, int(sc["W"]) // downscale
    return c2w, intrinsics(H, W, float(sc["focal_factor"]), device), H, W
