"""Free-viewpoint rendering of a trained NeuS checkpoint.

  python -m neurecon_tpu_torch.tools.render_view --config configs/neus.yaml \
      --load_pt logs/neus_37/ckpts/latest.pt --camera_path small_circle \
      --camera_inds 11,14,17 --num_views 60 \
      [--use_surface_render sphere_tracing|root_finding] \
      [--render_mesh surface.ply] [--alter_radiance other.pt]

Runs on the CUDA card; `--device cpu` runs the plain PyTorch path on the CPU.
`render_frames` returns the frames; `main_function` writes the rgb, depth,
normal and rgb&normal videos (and rgb&mesh with `--render_mesh`, the mesh
rasterized by `tools/mesh_raster.py` along the same path). Volume rendering
by default; `--use_surface_render` casts rays to the surface
(`models/ray_casting.py`) and queries the radiance once at the hit point.
`--alter_radiance` swaps in the radiance net of another checkpoint.
Checkpoints written by the JAX package load as they are.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from neurecon_tpu_torch.tools.camera_paths import generate_camera_path
from neurecon_tpu_torch.utils import io as io_util
from neurecon_tpu_torch.utils.checkpoints import load_checkpoint, sorted_ckpts
from neurecon_tpu_torch.utils.console import log


def render_frames(args, device=None) -> dict:
    """Render the camera path of `args` from its checkpoint. Returns
    {"rgb" [n,H,W,3], "depth" [n,H,W,1] (per-frame normalized), "normal"
    [n,H,W,3] (mapped to [0,1]), "seconds" [n] wall time per frame, and
    with `render_mesh` "mesh" [n,H,W,3], the rasterized mesh}."""
    from neurecon_tpu_torch import bridge, get_device
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.frameworks import (checkpoint_render_kwargs,
                                                      get_model)
    from neurecon_tpu_torch.ops import get_rays
    from neurecon_tpu_torch.training import render_full_image

    dev = get_device(device)
    model, _kw_train, render_kwargs_test, render_factory = get_model(args, dev)

    if args.get("load_pt", None) is None:
        ckpt_file = sorted_ckpts(os.path.join(args.training.exp_dir, "ckpts"))[-1]
    else:
        ckpt_file = args.load_pt
    log.info("=> Use ckpt: " + str(ckpt_file))
    ckpt = load_checkpoint(ckpt_file)
    bridge.load_tree(model, ckpt["model"])
    step_kwargs = checkpoint_render_kwargs(args, ckpt["global_step"])
    if args.get("alter_radiance", None) is not None:
        alt = load_checkpoint(args.alter_radiance)
        bridge.load_tree(model, {"radiance_net": alt["model"]["radiance_net"]}, strict=False)
        log.info(f"=> Swapped radiance net from {args.alter_radiance}")

    if args.get("downscale", None):
        args.data["downscale"] = args.downscale
    dataset = get_data(args)
    intrinsics = np.array(dataset.intrinsics_all[0], np.float32)
    H, W = dataset.H, dataset.W
    # fx/cy scale with H, fy/cx with W (keep aspect per axis)
    if args.get("H_out", None):
        intrinsics[1, 2] *= args.H_out / H
        intrinsics[1, 1] *= args.H_out / H
        H = int(args.H_out)
    if args.get("W_out", None):
        intrinsics[0, 2] *= args.W_out / W
        intrinsics[0, 0] *= args.W_out / W
        W = int(args.W_out)
    log.info(f"=> Rendering resolution @ [{H} x {W}] on {dev}")

    render_c2ws = generate_camera_path(
        args.get("camera_path", "interpolation"), np.asarray(dataset.c2w_all),
        int(args.get("num_views", 60)), args.get("camera_inds", "11,15"))

    use_surface = args.get("use_surface_render", None)
    if use_surface:
        if use_surface not in ("sphere_tracing", "root_finding"):
            raise ValueError(f"--use_surface_render {use_surface!r}: want "
                             "sphere_tracing or root_finding")
        from neurecon_tpu_torch.models.ray_casting import make_surface_render_fn
        # the cast must reach from the farthest camera past the object
        cam_dist = float(np.linalg.norm(np.asarray(render_c2ws)[:, :3, 3], axis=-1).max())
        cast_cfg = {"near": 0.0,
                    "far": 1.2 * (cam_dist + args.model.get("obj_bounding_radius", 1.0))}
        if use_surface == "root_finding":
            cast_cfg["N_steps"] = 128
        render_fn = make_surface_render_fn(model, ray_casting_algo=use_surface,
                                           ray_casting_cfgs=cast_cfg)
        normal_key = "normals_surface"
    else:
        kwargs = {k: v for k, v in render_kwargs_test.items()
                  if k not in ("H", "W", "rayschunk")}
        kwargs.update(step_kwargs)
        render_fn = render_factory(detailed_output=False, calc_normal=True, **kwargs)
        normal_key = "normals_volume"
    mesh = None
    if args.get("render_mesh", None):
        from neurecon_tpu_torch.tools.mesh_raster import rasterize_mesh
        from neurecon_tpu_torch.utils.mesh import read_ply
        mesh = read_ply(args.render_mesh)
        log.info(f"=> Compositing mesh {args.render_mesh} "
                 f"({len(mesh[0])} verts, {len(mesh[1])} faces)")
    cull_r = (float(args.model.get("obj_bounding_radius", 1.0))
              if args.get("cull_miss", False) else None)
    intr_t = torch.as_tensor(intrinsics, device=dev)
    rgbs, depths, normals, meshes, seconds = [], [], [], [], []
    for i, c2w in enumerate(render_c2ws):
        t0 = time.perf_counter()
        rays_o, rays_d, _ = get_rays(
            torch.as_tensor(np.asarray(c2w, np.float32), device=dev), intr_t, H, W)
        ret = render_full_image(
            render_fn, rays_o, rays_d, rayschunk=int(args.get("rayschunk", 4096)),
            generator=torch.Generator(device=dev).manual_seed(i),
            cull_sphere_r=cull_r,
            miss_rgb=1.0 if render_kwargs_test.get("white_bkgd", False) else 0.0)
        seconds.append(time.perf_counter() - t0)  # includes the device sync
        rgbs.append(ret["rgb"].reshape(H, W, 3))
        depth = np.nan_to_num(ret["depth_volume"].reshape(H, W, 1), posinf=0.0)
        depths.append(depth / (depth.max() + 1e-10))
        normals.append(ret[normal_key].reshape(H, W, 3) / 2.0 + 0.5)
        if mesh is not None:
            meshes.append(rasterize_mesh(mesh[0], mesh[1], np.asarray(c2w), intrinsics,
                                         H, W)[0])
        log.info(f"  rendered view {i + 1}/{len(render_c2ws)} ({seconds[-1]:.2f}s)")
    out = {"rgb": np.stack(rgbs), "depth": np.stack(depths),
           "normal": np.stack(normals), "seconds": seconds}
    if meshes:
        out["mesh"] = np.stack(meshes)
    return out


def main_function(args):
    """Render the path and write the videos into args.outdir."""
    frames = render_frames(args, device=args.get("device", None))
    n, H, W = frames["rgb"].shape[:3]
    outdir = args.get("outdir", "./out")
    io_util.cond_mkdir(outdir)
    outbase = args.get("outbase", None) or args.expname
    post_fix = f"{H}x{W}_{n}_{args.get('camera_path', 'interpolation')}"
    if args.get("use_surface_render", None):
        post_fix += f"_{args.use_surface_render}"
    fps = int(args.get("fps", 30))
    videos = {"rgb": frames["rgb"], "depth": frames["depth"].repeat(3, -1),
              "normal": frames["normal"],
              "rgb&normal": np.concatenate([frames["rgb"], frames["normal"]], 1)}
    if "mesh" in frames:  # side by side
        videos["rgb&mesh"] = np.concatenate([frames["rgb"], frames["mesh"]], 2)
    for name, imgs in videos.items():
        io_util.save_video(imgs, os.path.join(outdir, f"{outbase}_{name}_{post_fix}.mp4"),
                           fps=fps)
    log.info(f"=> Wrote videos to {outdir}")


def _extra_args(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu (plain PyTorch path)")
    parser.add_argument("--num_views", type=int, default=60)
    parser.add_argument("--downscale", type=float, default=1)
    parser.add_argument("--rayschunk", type=int, default=4096)
    parser.add_argument("--cull_miss", action="store_true",
                        help="skip rays that miss the bounding sphere")
    parser.add_argument("--camera_path", type=str, default="interpolation")
    parser.add_argument("--camera_inds", type=str, default="11,15")
    parser.add_argument("--load_pt", type=str, default=None)
    parser.add_argument("--H_out", type=int, default=None)
    parser.add_argument("--W_out", type=int, default=None)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--outbase", type=str, default=None)
    parser.add_argument("--outdir", type=str, default="./out")
    parser.add_argument("--alter_radiance", type=str, default=None,
                        help="checkpoint whose radiance net replaces the model's")
    parser.add_argument("--use_surface_render", type=str, default=None,
                        help="sphere_tracing or root_finding (default: volume render)")
    parser.add_argument("--render_mesh", type=str, default=None,
                        help="extracted .ply to rasterize and composite")


if __name__ == "__main__":
    from neurecon_tpu_torch.config import parse_cli

    config, _ = parse_cli(extra_args_fn=_extra_args)
    main_function(config)
