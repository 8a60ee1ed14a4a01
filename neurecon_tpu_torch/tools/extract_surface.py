"""Mesh a checkpoint's surface with marching tetrahedra (port of
`neurecon_tpu/tools/extract_surface.py`):

  python -m neurecon_tpu_torch.tools.extract_surface --load_pt ckpt.pt \
      --N 512 --volume_size 2.0 --out surface.ply [--config cfg.yaml] [--device cpu]

Reads checkpoints of either package (the params pytree under 'model' /
'implicit_surface', or the bare pytree). The grid is queried through the
sdf-only CUDA kernel on the card; `--device cpu` runs the plain path. Unlike
the JAX tool, `--config` also carries `sphere_residual` (ROADMAP Queue C),
and `--use_siren` gives a SIREN surface without a config file (the flags
`--D 5 --skip -1 --embed_multires -1 --use_siren` are configs/volsdf_siren.yaml's).
"""
from __future__ import annotations

import argparse


def build_surface(args):
    """The ImplicitSurface the flags (or `args.config`) describe."""
    from neurecon_tpu_torch.models.base import ImplicitSurface

    surface_cfg = dict(W=args.W, D=args.D, skips=[args.skip] if args.skip >= 0 else [],
                       W_geo_feat=args.W_geo_feat, embed_multires=args.embed_multires,
                       radius_init=args.init_r, use_siren=getattr(args, "use_siren", False))
    if args.config is not None:
        from neurecon_tpu_torch.config import load_yaml
        cfg = load_yaml(args.config)
        s = cfg.model.surface
        surface_cfg = dict(W=s.get("W", 256), D=s.get("D", 8),
                           skips=s.get("skips", [4]),
                           W_geo_feat=cfg.model.get("W_geometry_feature", 256),
                           embed_multires=s.get("embed_multires", 6),
                           radius_init=s.get("radius_init", 1.0),
                           use_siren=s.get("use_siren", False),
                           sphere_residual=s.get("sphere_residual", False))
    return ImplicitSurface(**surface_cfg)


def main_function(args) -> dict:
    """Extract the mesh; returns `utils.mesh.extract_mesh`'s dict."""
    from neurecon_tpu_torch import bridge, get_device
    from neurecon_tpu_torch.utils.checkpoints import read_restricted
    from neurecon_tpu_torch.utils.mesh import extract_mesh

    dev = get_device(getattr(args, "device", None))
    state_dict = read_restricted(args.load_pt)
    params = state_dict["model"] if "model" in state_dict else state_dict
    surface = build_surface(args)
    bridge.load_surface_tree(surface, params.get("implicit_surface", params))
    surface = surface.to(dev)
    return extract_mesh(surface.forward_query, volume_size=args.volume_size,
                        level=args.level, N=args.N, filepath=args.out,
                        chunk=args.chunk, device=dev, show_progress=True)


def make_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--load_pt", type=str, required=True)
    parser.add_argument("--config", type=str, default=None,
                        help="experiment config yaml (for non-default nets)")
    parser.add_argument("--out", type=str, default="./surface.ply")
    parser.add_argument("--N", type=int, default=512)
    parser.add_argument("--volume_size", type=float, default=2.0)
    parser.add_argument("--level", type=float, default=0.0)
    parser.add_argument("--chunk", type=int, default=262144)
    parser.add_argument("--D", type=int, default=8)
    parser.add_argument("--W", type=int, default=256)
    parser.add_argument("--W_geo_feat", type=int, default=256)
    parser.add_argument("--skip", type=int, default=4)
    parser.add_argument("--init_r", type=float, default=1.0)
    parser.add_argument("--embed_multires", type=int, default=6)
    parser.add_argument("--use_siren", action="store_true",
                        help="a SIREN surface (sin(30 a) layers; no skips)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu (plain PyTorch path)")
    return parser


if __name__ == "__main__":
    main_function(make_parser().parse_args())
