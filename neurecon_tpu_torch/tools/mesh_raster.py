"""Software mesh rasterizer, a numpy z-buffer (the port's copy of
`neurecon_tpu/tools/mesh_raster.py`).

Projects a mesh with the pinhole intrinsics of the neural renders, rasterizes
flat-shaded lambertian triangles into a z-buffer, and composites them into
the free-viewpoint videos (`render_view --render_mesh`). Vectorized over
triangles: faces are bucketed by screen-space bounding-box size, and each
bucket rasterizes all its triangles against a fixed BxB pixel window at once
(edge-function coverage, screen-linear 1/z interpolation).
"""
from __future__ import annotations

import numpy as np

# bucket sizes for triangle bounding boxes (pixels); faces wider than the
# last bucket are 4-way midpoint-subdivided until they fit (marching-tet
# tris are 1-3 px, so subdivision only triggers for low-res meshes)
_BUCKETS = (2, 4, 8, 16, 32, 64)


def _camera_space(verts: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    R, t = c2w[:3, :3], c2w[:3, 3]
    return (verts - t) @ R  # R.T @ (v - t), batched


def _project(v_cam: np.ndarray, intrinsics: np.ndarray):
    z = v_cam[:, 2]
    u = intrinsics[0, 0] * v_cam[:, 0] / z + intrinsics[0, 2]
    v = intrinsics[1, 1] * v_cam[:, 1] / z + intrinsics[1, 2]
    return np.stack([u, v], -1), z


def rasterize_mesh(verts: np.ndarray, faces: np.ndarray, c2w: np.ndarray,
                   intrinsics: np.ndarray, H: int, W: int,
                   base_color=(0.7, 0.7, 0.7), background=(1.0, 1.0, 1.0)):
    """Render one view. Returns (rgb [H, W, 3] float in [0,1], depth [H, W]
    with +inf at misses, mask [H, W] bool).

    Flat lambertian shading with a headlight (light from the camera), double
    sided; OpenCV camera convention (+z forward), matching ops/ray.get_rays.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    v_cam = _camera_space(verts, np.asarray(c2w, np.float64))
    uv, z = _project(v_cam, np.asarray(intrinsics, np.float64))

    tri_uv = uv[faces]            # [F, 3, 2]
    tri_z = z[faces]              # [F, 3]

    # flat shading: face normal vs view direction to the face center
    e1 = v_cam[faces[:, 1]] - v_cam[faces[:, 0]]
    e2 = v_cam[faces[:, 2]] - v_cam[faces[:, 0]]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    center = v_cam[faces].mean(1)
    view = center / (np.linalg.norm(center, axis=-1, keepdims=True) + 1e-12)
    lambert = np.abs((n * view).sum(-1))  # double-sided headlight
    shade = (0.25 + 0.75 * lambert)[:, None] * np.asarray(base_color)[None]

    # cull faces entirely behind the camera or off screen
    bb_min = np.floor(tri_uv.min(1)).astype(np.int64)
    bb_max = np.ceil(tri_uv.max(1)).astype(np.int64)
    keep = ((tri_z > 1e-6).all(-1)
            & (bb_max[:, 0] >= 0) & (bb_min[:, 0] < W)
            & (bb_max[:, 1] >= 0) & (bb_min[:, 1] < H))
    tri_uv, tri_z, shade = tri_uv[keep], tri_z[keep], shade[keep]
    bb_size = (bb_max[keep] - bb_min[keep] + 1).max(-1)

    # screen-space midpoint subdivision of oversized faces (flat shade and
    # 1/z both interpolate linearly, so splitting is exact)
    for _ in range(8):
        big = bb_size > _BUCKETS[-1]
        if not np.any(big):
            break
        p, zt, sh = tri_uv[big], tri_z[big], shade[big]
        m01, m12, m20 = (p[:, 0] + p[:, 1]) / 2, (p[:, 1] + p[:, 2]) / 2, \
            (p[:, 2] + p[:, 0]) / 2
        iz = 1.0 / zt
        z01, z12, z20 = (2.0 / (iz[:, 0] + iz[:, 1]),
                         2.0 / (iz[:, 1] + iz[:, 2]),
                         2.0 / (iz[:, 2] + iz[:, 0]))
        sub_uv = np.concatenate([
            np.stack([p[:, 0], m01, m20], 1), np.stack([m01, p[:, 1], m12], 1),
            np.stack([m20, m12, p[:, 2]], 1), np.stack([m01, m12, m20], 1)])
        sub_z = np.concatenate([
            np.stack([zt[:, 0], z01, z20], 1), np.stack([z01, zt[:, 1], z12], 1),
            np.stack([z20, z12, zt[:, 2]], 1), np.stack([z01, z12, z20], 1)])
        sub_sh = np.concatenate([sh] * 4)
        tri_uv = np.concatenate([tri_uv[~big], sub_uv])
        tri_z = np.concatenate([tri_z[~big], sub_z])
        shade = np.concatenate([shade[~big], sub_sh])
        bb_size = (np.ceil(tri_uv.max(1)) - np.floor(tri_uv.min(1)) + 1
                   ).max(-1).astype(np.int64)

    zbuf = np.full(H * W, np.inf)
    samples = []  # (pix_idx, depth, face_idx) per bucket, resolved at the end
    face_ids = np.arange(len(tri_uv))

    for bi, B in enumerate(_BUCKETS):
        lo = 0 if bi == 0 else _BUCKETS[bi - 1]
        # the last bucket has no upper bound: faces still oversized after the
        # subdivision cap (initial bbox > ~16k px) rasterize their first BxB
        # window rather than silently disappearing
        last = bi == len(_BUCKETS) - 1
        sel = (bb_size > lo) if last else ((bb_size > lo) & (bb_size <= B))
        if last and np.any(bb_size[sel] > B):
            import warnings
            warnings.warn(
                f"mesh_raster: {int((bb_size[sel] > B).sum())} faces exceed "
                f"the {B}px bucket after subdivision; truncating to {B}x{B}")
        if not np.any(sel):
            continue
        p = tri_uv[sel]                       # [T, 3, 2]
        zt = tri_z[sel]                       # [T, 3]
        fid = face_ids[sel]
        # sample at INTEGER pixel coordinates: get_rays lifts pixel (i, j)
        # through image-plane point (i, j), not (i+0.5, j+0.5)
        origin = np.floor(p.min(1))

        gy, gx = np.mgrid[0:B, 0:B]
        offs = np.stack([gx.ravel(), gy.ravel()], -1)        # [B², 2]
        pix = origin[:, None, :] + offs[None]                # [T, B², 2]

        # edge functions (screen space, CCW or CW both handled via area sign)
        d0 = p[:, 1] - p[:, 0]
        d1 = p[:, 2] - p[:, 1]
        d2 = p[:, 0] - p[:, 2]
        q0 = pix - p[:, None, 0]
        q1 = pix - p[:, None, 1]
        q2 = pix - p[:, None, 2]
        w2 = d0[:, None, 0] * q0[..., 1] - d0[:, None, 1] * q0[..., 0]
        w0 = d1[:, None, 0] * q1[..., 1] - d1[:, None, 1] * q1[..., 0]
        w1 = d2[:, None, 0] * q2[..., 1] - d2[:, None, 1] * q2[..., 0]
        area = (d0[:, 0] * (p[:, 2, 1] - p[:, 0, 1])
                - d0[:, 1] * (p[:, 2, 0] - p[:, 0, 0]))[:, None]
        sgn = np.sign(area)
        inside = ((w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
                  & (np.abs(area) > 1e-12))

        # perspective-correct depth: 1/z is linear in screen space
        denom = np.where(np.abs(area) < 1e-12, 1.0, area)
        b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
        inv_z = (b0 / zt[:, None, 0] + b1 / zt[:, None, 1]
                 + b2 / zt[:, None, 2])
        depth = 1.0 / np.maximum(inv_z, 1e-12)

        px = np.round(pix[..., 0]).astype(np.int64)
        py = np.round(pix[..., 1]).astype(np.int64)
        valid = inside & (px >= 0) & (px < W) & (py >= 0) & (py < H) & (depth > 0)
        idx = (py * W + px)[valid]
        dep = depth[valid]
        fidx = np.broadcast_to(fid[:, None], valid.shape)[valid]
        np.minimum.at(zbuf, idx, dep)
        samples.append((idx, dep, fidx))

    rgb = np.ones((H * W, 3)) * np.asarray(background)[None]
    mask = np.isfinite(zbuf)
    for idx, dep, fidx in samples:  # write colors of the z-winning samples
        win = dep <= zbuf[idx] * (1 + 1e-9)
        rgb[idx[win]] = shade[fidx[win]]
    return (rgb.reshape(H, W, 3).astype(np.float32),
            zbuf.reshape(H, W), mask.reshape(H, W))
