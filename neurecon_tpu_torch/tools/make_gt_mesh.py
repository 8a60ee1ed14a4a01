"""Mesh an analytic synthetic-scene SDF for Chamfer evaluation (port of
`neurecon_tpu/tools/make_gt_mesh.py`), with the same marching-tetrahedra
extractor the learned surfaces go through.

    python -m neurecon_tpu_torch.tools.make_gt_mesh --shape torus --N 384 \
        --radius 0.5 --out /tmp/gt_torus.ply [--device cpu]

The SDFs are torch expressions, evaluated on the grid's device: the card
unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse

import torch


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """sqrt of a >= 0 through ATen's own elementwise kernels (within an ulp
    of the correctly rounded root). `torch.sqrt` of a CPU tensor goes to
    MKL's vector math library, split over worker threads whose accuracy is a
    per-thread mode, and the GT mesh must not depend on it."""
    return torch.where(a > 0, a * torch.rsqrt(a), torch.zeros_like(a))


class _TorchAsNumpy:
    """The part of numpy's API that `dataio.synthetic.composite_sdf` uses,
    on torch tensors of the points' dtype and device."""

    def __init__(self, like: torch.Tensor):
        self.like = like
        self.linalg = self

    def asarray(self, v):
        return torch.as_tensor(v, dtype=self.like.dtype, device=self.like.device)

    def sqrt(self, a):
        return _sqrt(a)

    def abs(self, a):
        return torch.abs(a)

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    def norm(self, a, axis):
        return torch.linalg.norm(a, dim=axis)


def analytic_sdf(shape: str, radius: float):
    """pts [n, 3] -> sdf [n] of the synthetic scene `shape` at `radius`; the
    torus and composite come from `dataio.synthetic`, so the mesh and the
    rendered scene agree."""
    from neurecon_tpu_torch.dataio.synthetic import composite_sdf, torus_radii

    if shape == "sphere":
        return lambda pts: torch.linalg.norm(pts, dim=-1) - radius
    if shape == "composite":
        return lambda pts: composite_sdf(pts, radius, xp=_TorchAsNumpy(pts))
    if shape == "torus":
        R_maj, r_min = torus_radii(radius)

        def torus(pts):
            q = _sqrt(pts[..., 0] ** 2 + pts[..., 2] ** 2) - R_maj
            return _sqrt(q ** 2 + pts[..., 1] ** 2) - r_min
        return torus
    raise ValueError(f"unknown shape {shape!r}")


def make_gt_mesh(shape: str, radius: float, N: int, volume_size: float, out: str,
                 device=None) -> dict:
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.utils.mesh import extract_mesh

    return extract_mesh(analytic_sdf(shape, radius), volume_size=volume_size, N=N,
                        filepath=out, chunk=2 ** 20, device=get_device(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=["sphere", "torus", "composite"], default="sphere")
    ap.add_argument("--radius", type=float, default=0.5,
                    help="scene bounding radius (matches data.radius)")
    ap.add_argument("--N", type=int, default=384)
    ap.add_argument("--volume_size", type=float, default=1.5)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return make_gt_mesh(args.shape, args.radius, args.N, args.volume_size, args.out,
                        device=args.device)


if __name__ == "__main__":
    main()
