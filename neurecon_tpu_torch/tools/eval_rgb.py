"""RGB evaluation (port of `neurecon_tpu/tools/eval_rgb.py`): render every
dataset view from a checkpoint and report PSNR, with the masked PSNR and its
interior / silhouette-edge split where the views carry object masks.

  python -m neurecon_tpu_torch.tools.eval_rgb --config configs/neus.yaml \
      --load_pt logs/neus_65/ckpts/latest.pt --downscale 4 [--device cpu]

The renders run on the card (volume render: the upsampler and forward+nablas
kernels); the metrics are host numpy.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def psnr(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray = None) -> float:
    pred = np.clip(np.asarray(pred, np.float64), 0, 1)
    gt = np.asarray(gt, np.float64)
    if mask is not None:
        se = ((pred - gt) ** 2)[mask]
    else:
        se = (pred - gt) ** 2
    mse = se.mean()
    return float(-10.0 * np.log10(mse + 1e-12))


def erode_mask(mask_hw: np.ndarray, k: int = 2) -> np.ndarray:
    """k-iteration 4-neighborhood binary erosion (no scipy dependency)."""
    m = np.asarray(mask_hw, bool)
    for _ in range(k):
        inner = m.copy()
        inner[1:] &= m[:-1]
        inner[:-1] &= m[1:]
        inner[:, 1:] &= m[:, :-1]
        inner[:, :-1] &= m[:, 1:]
        m = inner
    return m


def masked_psnr_decomposition(pred, gt, mask_flat, H, W, edge_px: int = 2):
    """Split the object-masked PSNR into an interior band and a silhouette
    edge band (mask minus its erosion): soft volume-rendered silhouettes
    against a binary-sampled GT concentrate squared error in a thin ring,
    which dominates the small masked denominator even when the interior is
    near-perfect — this measures that effect instead of guessing at it."""
    mask = np.asarray(mask_flat, bool).reshape(H, W)
    interior = erode_mask(mask, edge_px)
    edge = mask & ~interior
    pred = np.clip(np.asarray(pred, np.float64), 0, 1).reshape(H, W, -1)
    gt = np.asarray(gt, np.float64).reshape(H, W, -1)
    se = ((pred - gt) ** 2).mean(-1)
    total_se = se[mask].sum() + 1e-300
    out = {
        "psnr_interior": float(-10 * np.log10(se[interior].mean() + 1e-12))
        if interior.any() else float("nan"),
        "psnr_edge": float(-10 * np.log10(se[edge].mean() + 1e-12))
        if edge.any() else float("nan"),
        "edge_frac_of_masked_px": float(edge.sum() / max(mask.sum(), 1)),
        "edge_frac_of_masked_err": float(se[edge].sum() / total_se),
    }
    return out


def render_psnrs(render_fn, dataset, n_eval: int, rayschunk: int, edge_px: int,
                 device) -> dict:
    """PSNR of the first `n_eval` views of `dataset` rendered by `render_fn`:
    {"psnr": [...]} and, where the views carry object masks, "psnr_masked"
    and "decomp" (masked_psnr_decomposition per view); "masked_means" holds
    the means over the views of psnr_masked, psnr_interior, psnr_edge and
    edge_frac_of_masked_err (empty without masks)."""
    from neurecon_tpu_torch.ops import get_rays
    from neurecon_tpu_torch.training import render_full_image

    H, W = dataset.H, dataset.W
    out = {"psnr": [], "psnr_masked": [], "decomp": []}
    for i in range(n_eval):
        _, model_input, gt = dataset[i]
        rays_o, rays_d, _ = get_rays(
            torch.as_tensor(np.asarray(model_input["c2w"], np.float32), device=device),
            torch.as_tensor(np.asarray(model_input["intrinsics"], np.float32), device=device),
            H, W)
        ret = render_full_image(render_fn, rays_o, rays_d, rayschunk=rayschunk,
                                generator=torch.Generator(device=device).manual_seed(i))
        out["psnr"].append(psnr(ret["rgb"], gt["rgb"]))
        if "object_mask" in model_input:
            m = np.asarray(model_input["object_mask"], bool)
            out["psnr_masked"].append(psnr(ret["rgb"], gt["rgb"], m))
            out["decomp"].append(masked_psnr_decomposition(ret["rgb"], gt["rgb"], m, H, W,
                                                           edge_px))
    out["masked_means"] = {}
    if out["psnr_masked"]:
        out["masked_means"]["psnr_masked"] = float(np.mean(out["psnr_masked"]))
        for k in ("psnr_interior", "psnr_edge", "edge_frac_of_masked_err"):
            out["masked_means"][k] = float(np.mean([d[k] for d in out["decomp"]]))
    return out


def main_function(args, device=None) -> dict:
    from neurecon_tpu_torch import bridge, get_device
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.frameworks import (checkpoint_render_kwargs,
                                                      get_model)
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint, sorted_ckpts
    from neurecon_tpu_torch.utils.console import log

    dev = get_device(device if device is not None else args.get("device", None))
    model, _kw_train, render_kwargs_test, render_factory = get_model(args, dev)
    if args.get("load_pt", None) is None:
        ckpt_file = sorted_ckpts(os.path.join(args.training.exp_dir, "ckpts"))[-1]
    else:
        ckpt_file = args.load_pt
    ckpt = load_checkpoint(ckpt_file)
    bridge.load_tree(model, ckpt["model"])
    step_kwargs = checkpoint_render_kwargs(args, ckpt["global_step"])

    if args.get("downscale", None):
        args.data["downscale"] = args.downscale
    dataset = get_data(args)
    kwargs = {k: v for k, v in render_kwargs_test.items()
              if k not in ("H", "W", "rayschunk")}
    kwargs.update(step_kwargs)
    render_fn = render_factory(detailed_output=False, **kwargs)
    edge_px = int(args.get("edge_px", 2))
    n_eval = min(len(dataset), int(args.get("n_eval", len(dataset))))
    r = render_psnrs(render_fn, dataset, n_eval, int(args.get("rayschunk", 4096)),
                     edge_px, dev)
    for i, p in enumerate(r["psnr"]):
        msg = f"view {i}: psnr={p:.2f}"
        if r["decomp"]:
            dec = r["decomp"][i]
            msg += (f" masked={r['psnr_masked'][i]:.2f} interior={dec['psnr_interior']:.2f} "
                    f"edge={dec['psnr_edge']:.2f} "
                    f"(edge {dec['edge_frac_of_masked_px']:.1%} of px, "
                    f"{dec['edge_frac_of_masked_err']:.1%} of err)")
        log.info(msg)

    result = {"psnr_mean": float(np.mean(r["psnr"])), "n_views": n_eval}
    if r["masked_means"]:
        result.update({f"{k}_mean": v for k, v in r["masked_means"].items()})
        result["edge_px"] = edge_px
    print(json.dumps(result))
    return result


def _extra_args(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu (plain PyTorch path)")
    parser.add_argument("--load_pt", type=str, default=None)
    parser.add_argument("--downscale", type=float, default=None)
    parser.add_argument("--rayschunk", type=int, default=4096)
    parser.add_argument("--n_eval", type=int, default=10**9)
    parser.add_argument("--edge_px", type=int, default=2,
                        help="silhouette band width for the masked-PSNR "
                             "interior/edge decomposition")


if __name__ == "__main__":
    from neurecon_tpu_torch.config import parse_cli

    config, _ = parse_cli(extra_args_fn=_extra_args)
    main_function(config)
