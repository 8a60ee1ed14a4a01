"""Mesh evaluation: Chamfer distance between two point-sampled meshes (port
of `neurecon_tpu/tools/eval_mesh.py`, host numpy and scipy).

  python -m neurecon_tpu_torch.tools.eval_mesh --pred pred.ply --gt gt.ply

Points are sampled uniformly by triangle area; nearest-neighbor distances are
computed with a scipy cKDTree. Optional --scale_mat applies the dataset's
scale_mat (cameras.npz) to bring predictions into GT world coordinates.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform sampling of n points on a triangle mesh."""
    rng = np.random.RandomState(seed)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    probs = areas / (areas.sum() + 1e-12)
    tri = rng.choice(len(faces), size=n, p=probs)
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[tri] + u * (b[tri] - a[tri]) + v * (c[tri] - a[tri])


def chamfer_distance(pts_a: np.ndarray, pts_b: np.ndarray):
    """Returns (chamfer_l2_mean, accuracy a->b, completeness b->a)."""
    from scipy.spatial import cKDTree
    d_ab = cKDTree(pts_b).query(pts_a, k=1)[0]
    d_ba = cKDTree(pts_a).query(pts_b, k=1)[0]
    acc = float(d_ab.mean())
    comp = float(d_ba.mean())
    return 0.5 * (acc + comp), acc, comp


def main_function(args):
    from neurecon_tpu_torch.utils.mesh import read_ply

    verts_p, faces_p = read_ply(args.pred)
    verts_g, faces_g = read_ply(args.gt)

    if args.scale_mat is not None:
        cams = np.load(args.scale_mat)
        S = cams["scale_mat_0"]
        verts_p = verts_p @ S[:3, :3].T + S[:3, 3]

    if len(faces_p) == 0 or len(faces_g) == 0:
        # e.g. a collapsed model whose SDF never crosses zero: report the
        # empty side instead of crashing in sample_surface
        result = {"chamfer": None, "no_surface": True,
                  "empty": "pred" if len(faces_p) == 0 else "gt"}
        print(json.dumps(result))
        return result

    pts_p = sample_surface(verts_p, faces_p, args.n_samples)
    pts_g = sample_surface(verts_g, faces_g, args.n_samples, seed=1)
    cd, acc, comp = chamfer_distance(pts_p, pts_g)
    result = {"chamfer": cd, "accuracy": acc, "completeness": comp,
              "n_samples": args.n_samples}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred", type=str, required=True)
    parser.add_argument("--gt", type=str, required=True)
    parser.add_argument("--n_samples", type=int, default=100000)
    parser.add_argument("--scale_mat", type=str, default=None,
                        help="cameras.npz providing scale_mat_0")
    main_function(parser.parse_args())
