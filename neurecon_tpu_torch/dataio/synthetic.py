"""Analytic scenes — file-free datasets for tests and benchmarks.

Cameras on a ring looking at the origin; images rendered on the host from an
analytic lambertian SDF, so ground-truth depth / normals / masks are exact.
Two shapes: `sphere` (closed-form ray intersection) and `torus` (genus-1,
non-convex — a much stronger reconstruction oracle; rendered by vectorized
numpy sphere tracing + bisection refinement against the exact SDF).
Shares the SceneDataset interface of the real loaders (dataio/DTU.py:9-160):
preloaded host arrays, `__getitem__` -> (idx, model_input, ground_truth).
"""
from __future__ import annotations

import numpy as np

from neurecon_tpu_torch.utils.camera import look_at


def _ray_sphere(rays_o, rays_d, radius):
    """Analytic first-hit of |x| = radius. Returns (hit_mask, depth, normal)."""
    b = np.sum(rays_o * rays_d, axis=-1)
    c = np.sum(rays_o ** 2, axis=-1) - radius ** 2
    disc = b ** 2 - c
    hit = disc > 0
    sqrt_disc = np.sqrt(np.maximum(disc, 0.0))
    t = -b - sqrt_disc
    hit = hit & (t > 0)
    pts = rays_o + t[..., None] * rays_d
    normal = pts / (np.linalg.norm(pts, axis=-1, keepdims=True) + 1e-10)
    return hit, t, normal


def torus_radii(radius: float):
    """(major, minor) radii of the scene torus for a given bounding `radius`.

    Single source of truth — the GT mesher (tools/make_gt_mesh.py) and the
    scene renderer must agree or Chamfer numbers silently go wrong."""
    return 0.64 * radius, 0.32 * radius


def torus_sdf(p, R=0.32, r=0.16):
    """Exact torus SDF (axis = y): sqrt((|xz| - R)^2 + y^2) - r. Numpy, [..., 3]."""
    q = np.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - R
    return np.sqrt(q ** 2 + p[..., 1] ** 2) - r


def torus_normal(p, R=0.32, r=0.16):
    """Analytic gradient of torus_sdf, normalized."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rho = np.sqrt(x ** 2 + z ** 2) + 1e-12
    q = rho - R
    m = np.sqrt(q ** 2 + y ** 2) + 1e-12
    n = np.stack([q / m * x / rho, y / m, q / m * z / rho], axis=-1)
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def composite_params(radius: float):
    """Primitive layout of the `composite` scene, in units of the scene
    bounding `radius` (everything stays inside |x| <= 0.95*radius so the
    sphere-scene configs transfer unchanged).

    Single source of truth shared by the host renderer (this module) and the
    GT mesher (tools/make_gt_mesh.py): a y-axis torus, a large ball capping
    the torus hole from above (deep concave crevice ring where they meet),
    a small ball and a rounded box both intersecting the tube (sharp union
    creases), giving concavities, self-occlusion and multiple genus features
    in one scene — far closer to a real scan than the sphere/torus oracles.
    """
    return {
        "torus": {"R": 0.55 * radius, "r": 0.22 * radius},
        "ball_a": {"c": (0.0, 0.32 * radius, 0.0), "r": 0.45 * radius},
        "ball_b": {"c": (-0.55 * radius, -0.30 * radius, 0.30 * radius),
                   "r": 0.25 * radius},
        "box": {"c": (0.30 * radius, -0.30 * radius, -0.30 * radius),
                "half": 0.22 * radius, "round": 0.04 * radius},
    }


def composite_sdf(p, radius=0.5, xp=np):
    """Exact hard-min union SDF of the composite scene. `xp` is any array
    module with numpy's API."""
    prm = composite_params(radius)
    q = xp.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - prm["torus"]["R"]
    d = xp.sqrt(q ** 2 + p[..., 1] ** 2) - prm["torus"]["r"]
    for name in ("ball_a", "ball_b"):
        c = xp.asarray(prm[name]["c"])
        d = xp.minimum(
            d, xp.linalg.norm(p - c, axis=-1) - prm[name]["r"])
    b = prm["box"]
    qb = xp.abs(p - xp.asarray(b["c"])) - b["half"]
    outside = xp.linalg.norm(xp.maximum(qb, 0.0), axis=-1)
    inside = xp.minimum(
        xp.maximum(qb[..., 0], xp.maximum(qb[..., 1], qb[..., 2])), 0.0)
    return xp.minimum(d, outside + inside - b["round"])


def composite_normal(p, radius=0.5, h=1e-5):
    """Central-difference gradient of composite_sdf, normalized (shading only;
    Chamfer GT comes from meshing the SDF itself, never from these normals)."""
    grads = []
    for ax in range(3):
        e = np.zeros(3)
        e[ax] = h
        grads.append((composite_sdf(p + e, radius)
                      - composite_sdf(p - e, radius)) / (2 * h))
    n = np.stack(grads, axis=-1)
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def _ray_march(rays_o, rays_d, sdf_fn, t_max, n_steps=256, eps=1e-5):
    """Vectorized numpy sphere tracing + 16-step bisection refine.

    rays_d must be unit-norm (so SDF values are valid step sizes). Returns
    (hit_mask, depth): exact first-hit of the level set to ~1e-6.
    """
    t = np.zeros(rays_o.shape[:-1])
    done = np.zeros_like(t, dtype=bool)
    for _ in range(n_steps):
        p = rays_o + t[..., None] * rays_d
        d = sdf_fn(p)
        done = done | (d < eps)
        t = np.where(done, t, t + np.maximum(d, eps))
        if np.all(done | (t > t_max)):
            break
    hit = done & (t <= t_max)
    # bisection refine between the last outside point and the overshoot point
    lo = np.maximum(t - 2 * eps, 0.0)
    hi = t + 2 * eps
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        inside = sdf_fn(rays_o + mid[..., None] * rays_d) < 0
        hi = np.where(inside, mid, hi)
        lo = np.where(inside, lo, mid)
    return hit, np.where(hit, 0.5 * (lo + hi), 0.0)


def render_sphere_views(c2w_all, intrinsics, H, W, radius=0.5,
                        light_dir=(0.5, -0.7, -0.5), albedo=(0.8, 0.3, 0.25),
                        bg_fn=None):
    """Render [n, H*W, 3] lambertian images + [n, H*W] masks + [n, H*W] depth.
    bg_fn(dirs)->rgb colors rays that miss the object (default black)."""
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)
    albedo = np.asarray(albedo, np.float64)

    jj, ii = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x_cam = (ii - cx) / fx
    y_cam = (jj - cy) / fy
    dirs_cam = np.stack([x_cam, y_cam, np.ones_like(x_cam)], axis=-1).reshape(-1, 3)

    rgbs, masks, depths = [], [], []
    for c2w in c2w_all:
        R, o = c2w[:3, :3], c2w[:3, 3]
        dirs = dirs_cam @ R.T
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(o, dirs.shape)
        hit, t, normal = _ray_sphere(rays_o, dirs, radius)
        lambert = np.clip(np.sum(normal * (-light), axis=-1), 0.0, 1.0)
        shade = (0.25 + 0.75 * lambert)[..., None] * albedo
        bg = bg_fn(dirs) if bg_fn is not None else 0.0
        rgb = np.where(hit[..., None], shade, bg)
        rgbs.append(rgb.astype(np.float32))
        masks.append(hit)
        depths.append(np.where(hit, t, 0.0).astype(np.float32))
    return np.stack(rgbs), np.stack(masks), np.stack(depths)


def envmap_color(dirs):
    """Smooth direction-dependent background color (a procedural env map at
    infinity). Low-frequency on purpose: exactly the function class the
    NeRF++ inverted-sphere background is meant to absorb, so nomask/NeRF++
    recipes (ref neus_nomask.yaml, volsdf_nerfpp.yaml) can be quality-tested
    without real scans."""
    d = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12)
    r = 0.45 + 0.25 * np.sin(2.0 * d[..., 0] + 0.5) + 0.15 * d[..., 1]
    g = 0.40 + 0.25 * np.sin(1.5 * d[..., 1]) - 0.10 * d[..., 2]
    b = 0.55 + 0.25 * np.sin(2.5 * d[..., 2] + 1.0) + 0.10 * d[..., 0]
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def render_sdf_views(c2w_all, intrinsics, H, W, sdf_fn, normal_fn, t_max=6.0,
                     light_dir=(0.5, -0.7, -0.5), albedo=(0.8, 0.3, 0.25),
                     bg_fn=None):
    """Render [n, H*W, 3] lambertian images for an arbitrary analytic SDF.
    bg_fn(dirs)->rgb colors rays that miss the object (default black)."""
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)
    albedo = np.asarray(albedo, np.float64)

    jj, ii = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    dirs_cam = np.stack([(ii - cx) / fx, (jj - cy) / fy,
                         np.ones_like(ii)], axis=-1).reshape(-1, 3)

    rgbs, masks, depths = [], [], []
    for c2w in c2w_all:
        R, o = c2w[:3, :3], c2w[:3, 3]
        dirs = dirs_cam @ R.T
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(o, dirs.shape)
        hit, t = _ray_march(rays_o, dirs, sdf_fn, t_max)
        pts = rays_o + t[..., None] * dirs
        normal = normal_fn(pts)
        lambert = np.clip(np.sum(normal * (-light), axis=-1), 0.0, 1.0)
        shade = (0.25 + 0.75 * lambert)[..., None] * albedo
        bg = bg_fn(dirs) if bg_fn is not None else 0.0
        rgbs.append(np.where(hit[..., None], shade, bg).astype(np.float32))
        masks.append(hit)
        depths.append(np.where(hit, t, 0.0).astype(np.float32))
    return np.stack(rgbs), np.stack(masks), np.stack(depths)


def make_synthetic_scene(n_images=16, H=120, W=160, radius=0.5, cam_radius=3.0,
                         focal_factor=1.2, shape="sphere", background="black"):
    """Returns a dict of host numpy arrays describing the full scene.

    shape='sphere': lambertian sphere of `radius` (closed-form intersection).
    shape='torus':  y-axis torus with major/minor radii (0.64, 0.32)*radius —
                    bounding radius ~= `radius`, so configs transfer unchanged.
    shape='composite': torus + two balls + rounded box, hard-min union
                    (composite_params) — concavities, union creases and
                    self-occlusion inside the same bounding radius.
    background='black' | 'envmap' (smooth direction-dependent color at
    infinity — the workload for nomask / NeRF++-background recipes).
    """
    bg_fn = envmap_color if background == "envmap" else None
    c2w_all = []
    for k in range(n_images):
        theta = 2 * np.pi * k / n_images
        phi = 0.35 * np.sin(3 * theta)  # slight elevation variation
        loc = cam_radius * np.array([
            np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)])
        c2w_all.append(look_at(loc, np.zeros(3)).astype(np.float32))
    c2w_all = np.stack(c2w_all)

    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = focal_factor * max(H, W)
    intr[0, 2], intr[1, 2] = W / 2.0, H / 2.0

    if shape == "sphere":
        rgb, mask, depth = render_sphere_views(c2w_all, intr, H, W,
                                               radius=radius, bg_fn=bg_fn)
    elif shape == "torus":
        R_maj, r_min = torus_radii(radius)
        rgb, mask, depth = render_sdf_views(
            c2w_all, intr, H, W,
            sdf_fn=lambda p: torus_sdf(p, R_maj, r_min),
            normal_fn=lambda p: torus_normal(p, R_maj, r_min),
            t_max=cam_radius + 2.0 * radius, bg_fn=bg_fn)
    elif shape == "composite":
        rgb, mask, depth = render_sdf_views(
            c2w_all, intr, H, W,
            sdf_fn=lambda p: composite_sdf(p, radius),
            normal_fn=lambda p: composite_normal(p, radius),
            t_max=cam_radius + 2.0 * radius, bg_fn=bg_fn)
    else:
        raise NotImplementedError(f"unknown synthetic shape: {shape}")
    return {
        "c2w": c2w_all,                                   # [n, 4, 4]
        "intrinsics": np.repeat(intr[None], n_images, 0),  # [n, 4, 4]
        "rgb": rgb,                                        # [n, H*W, 3]
        "object_mask": mask,                               # [n, H*W] bool
        "depth": depth,                                    # [n, H*W]
        "H": H, "W": W, "radius": radius,
    }


class SceneDataset:
    """Dataset-protocol wrapper over the analytic scene."""

    def __init__(self, data_dir=None, downscale=1.0, scale_radius=-1,
                 n_images=16, H=120, W=160, radius=0.5, cam_radius=3.0,
                 shape="sphere", background="black"):
        H, W = int(H // downscale), int(W // downscale)
        # scale_radius semantics match the real loaders (max camera norm ends
        # up at scale_radius/1.1) — but the scene is analytic, so cameras are
        # PLACED at the scaled radius before rendering (scaling poses after
        # rendering would desynchronize images from geometry).
        if scale_radius > 0:
            cam_radius = scale_radius / 1.1
        scene = make_synthetic_scene(n_images=n_images, H=H, W=W, radius=radius,
                                     cam_radius=cam_radius, shape=shape,
                                     background=background)
        self.shape, self.radius = shape, radius
        self.H, self.W = H, W
        self.n_images = n_images
        self.c2w_all = scene["c2w"]
        self.intrinsics_all = scene["intrinsics"]
        self.rgb_images = scene["rgb"]
        self.object_masks = scene["object_mask"]
        self.depths = scene["depth"]

    def __len__(self):
        return self.n_images

    def __getitem__(self, idx):
        sample = {
            "object_mask": self.object_masks[idx],
            "intrinsics": self.intrinsics_all[idx],
            "c2w": self.c2w_all[idx],
        }
        ground_truth = {"rgb": self.rgb_images[idx]}
        return idx, sample, ground_truth
