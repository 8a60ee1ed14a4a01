"""Staged-checkpoint evaluation (port of `neurecon_tpu/tools/eval_staged.py`):
PSNR (with the masked interior / edge split) and Chamfer for many checkpoints
of one run, in one process, with the renderer built once.

  python -m neurecon_tpu_torch.tools.eval_staged --config configs/long_neus_sphere.yaml \
      --ckpts logs/long_neus_sphere/ckpts/00025000.pt \
              logs/long_neus_sphere/ckpts/final_00300000.pt \
      --gt_mesh /tmp/gt_sphere.ply --out /tmp/staged.jsonl [--device cpu]

The renders and each checkpoint's mesh grid (`mesh_N`^3, the sdf-only
kernel) run on the card; the metrics are host numpy and scipy.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def evaluate_ckpts(args, ckpts, gt_mesh=None, n_eval=None, rayschunk=8192,
                   microchunk=0, mesh_N=256, n_samples=100000, edge_px=2, out_path=None,
                   device=None):
    """One row per checkpoint: {"ckpt", "step", "psnr", "psnr_min",
    "psnr_max"[, masked metrics][, "chamfer", "accuracy", "completeness"]};
    views rendered in `microchunk`-ray blocks within each chunk (0: whole
    chunks)."""
    from neurecon_tpu_torch import bridge, get_device
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.frameworks import (checkpoint_render_kwargs,
                                                      get_model)
    from neurecon_tpu_torch.tools.eval_mesh import chamfer_distance, sample_surface
    from neurecon_tpu_torch.tools.eval_rgb import render_psnrs
    from neurecon_tpu_torch.utils.checkpoints import read_restricted
    from neurecon_tpu_torch.utils.console import log
    from neurecon_tpu_torch.utils.mesh import extract_mesh, read_ply

    dev = get_device(device)
    model, _kw_train, render_kwargs_test, render_factory = get_model(args, dev)
    kwargs = {k: v for k, v in render_kwargs_test.items()
              if k not in ("H", "W", "rayschunk")}
    dataset = get_data(args)
    n_eval = min(len(dataset), n_eval or len(dataset))

    gt_pts = None
    if gt_mesh is not None:
        vg, fg = read_ply(gt_mesh)
        gt_pts = sample_surface(vg, fg, n_samples, seed=1)

    results = []
    for ckpt in ckpts:
        sd = read_restricted(ckpt)
        bridge.load_tree(model, sd["model"] if "model" in sd else sd)
        step = int(sd.get("global_step", -1))
        row = {"ckpt": os.path.basename(ckpt), "step": step}
        render_fn = render_factory(detailed_output=False,
                                   **kwargs, **checkpoint_render_kwargs(args, step))
        r = render_psnrs(render_fn, dataset, n_eval, rayschunk, edge_px, dev,
                         microchunk=microchunk or None)
        row["psnr"] = float(np.mean(r["psnr"]))
        # the per-view spread: a low mean with a healthy max points at a
        # per-view or eval-path artifact rather than a bad model
        row["psnr_min"] = float(np.min(r["psnr"]))
        row["psnr_max"] = float(np.max(r["psnr"]))
        row.update(r["masked_means"])

        if gt_pts is not None:
            with tempfile.NamedTemporaryFile(suffix=".ply") as tmp:
                extract_mesh(model.implicit_surface.forward_query,
                             volume_size=float(args.data.get("volume_size", 2.0)),
                             N=mesh_N, filepath=tmp.name, device=dev)
                vp, fp = read_ply(tmp.name)
            if len(fp) == 0:
                # an sdf with no zero crossing inside the volume: report it
                log.warning(f"eval_staged: {ckpt}: no surface inside the volume "
                            "(empty mesh); chamfer skipped")
                row.update({"chamfer": None, "no_surface": True})
            else:
                cd, acc, comp = chamfer_distance(sample_surface(vp, fp, n_samples), gt_pts)
                row.update({"chamfer": cd, "accuracy": acc, "completeness": comp})

        log.info(f"eval_staged: {json.dumps(row)}")
        print(json.dumps(row), flush=True)
        results.append(row)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")
    return results


def _extra_args(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu (plain PyTorch path)")
    parser.add_argument("--ckpts", type=str, nargs="+", required=True)
    parser.add_argument("--gt_mesh", type=str, default=None)
    parser.add_argument("--n_eval", type=int, default=None)
    parser.add_argument("--rayschunk", type=int, default=8192)
    parser.add_argument("--microchunk", type=int, default=0)
    parser.add_argument("--mesh_N", type=int, default=256)
    parser.add_argument("--edge_px", type=int, default=2)
    parser.add_argument("--out", type=str, default=None)


if __name__ == "__main__":
    from neurecon_tpu_torch.config import parse_cli

    config, _ = parse_cli(extra_args_fn=_extra_args)
    evaluate_ckpts(config, config.ckpts, gt_mesh=config.get("gt_mesh"),
                   n_eval=config.get("n_eval"),
                   rayschunk=int(config.get("rayschunk", 8192)),
                   microchunk=int(config.get("microchunk", 0)),
                   mesh_N=int(config.get("mesh_N", 256)),
                   edge_px=int(config.get("edge_px", 2)),
                   out_path=config.get("out"), device=config.get("device"))
