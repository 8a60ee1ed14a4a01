"""NeuS, VolSDF and UNISURF training on one CUDA card (port of
`neurecon_tpu/train.py`):

    python -m neurecon_tpu_torch.train --config configs/synthetic_smoke.yaml
    python -m neurecon_tpu_torch.train --config configs/synthetic_smoke.yaml \
        --device cpu --training:num_iters 40   # the plain path, on the CPU
    python -m neurecon_tpu_torch.train --config configs/synthetic_quality_volsdf.yaml
    python -m neurecon_tpu_torch.train --config configs/unisurf.yaml \
        --data:data_dir ./data/DTU/scan65   # a DTU, BlendedMVS or custom scene

The loop of the JAX trainer on one device, eager: the dataset held on the
device; the image order from `np.random.RandomState(seed + epoch)`; one step
= sample rays, render (the framework's sampler and the forward kernels),
loss, backward (through the eikonal backward kernel), Adam, schedule;
validation renders at step 0 and every `i_val` steps, at the step's render
kwargs (UNISURF's interval, `checkpoint_render_kwargs`), with VolSDF's beta
heat-map and upsampling-round images and UNISURF's surface depth and mask;
a SIREN surface's sphere pretrain
(`models/base.py::pretrain_siren_sdf`, at `training.lr_pretrain`) before the
first step of a fresh run, saved as `latest.pt`; meshes of the surface (`exp_dir/meshes/
<step>.ply`, a `data.mesh_N`^3 grid over `data.volume_size`, queried through
the sdf-only kernel, at level 0: UNISURF's occupancy 0.5) at steps 3000,
5000 and 7000 and every `i_val_mesh`
steps, as the JAX trainer schedules them (`mesh_steps`); metrics fetched from
the device only every `i_log` steps (one copy), with a NaN watchdog; `latest`
(every `i_save` seconds), numbered backup and `final` checkpoints, and a save
on KeyboardInterrupt. `training.steps_per_call` is read and only groups the
loop's checks: eager PyTorch has no dispatch to amortize.

NeuS without a mask and VolSDF with `outside_scene: nerf++` train their
NeRF++ background net with the rest (its own parameter group under a
per-module lr dict, else the default group). Not ported yet, and refused
before the first step (ROADMAP.md): several devices,
`training.overlap_sampler` and the profiler window
(`training.profile_steps`).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from neurecon_tpu_torch import bridge, get_device
from neurecon_tpu_torch import config as config_lib
from neurecon_tpu_torch.dataio import get_data
from neurecon_tpu_torch.models.base import (count_parameters, make_optimizer,
                                            make_schedule, pretrain_siren_sdf)
from neurecon_tpu_torch.models.frameworks import (checkpoint_render_kwargs, get_model,
                                                  make_trainer)
from neurecon_tpu_torch.ops import get_rays, lin2img
from neurecon_tpu_torch.training import (fast_forward_schedule, make_train_step,
                                         render_full_image)
from neurecon_tpu_torch.utils import io as io_util
from neurecon_tpu_torch.utils.checkpoints import (CheckpointIO,
                                                  load_optimizer_state,
                                                  optimizer_state_to_numpy)
from neurecon_tpu_torch.utils.console import log
from neurecon_tpu_torch.utils.logger import Logger
from neurecon_tpu_torch.utils.mesh import extract_mesh

_MESH_STEPS = (3000, 5000, 7000)  # the JAX trainer's fixed mesh extractions


def mesh_steps(it: int, i_val_mesh: int, num_iters: int) -> list:
    """The steps after `it` at which the loop extracts a mesh, in order: the
    fixed steps 3000 / 5000 / 7000 and every `i_val_mesh` steps up to
    `num_iters` (none of those when `i_val_mesh` <= 0). The loop runs a mesh
    when it reaches a listed step, so steps >= num_iters never run."""
    return sorted({m for m in _MESH_STEPS if m > it}
                  | ({m for m in range(i_val_mesh, num_iters + 1, i_val_mesh) if m > it}
                     if i_val_mesh > 0 else set()))


def _refuse_unported(args) -> None:
    """Raise on any option of the JAX trainer that the port does not carry."""
    def refuse(what):
        raise NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")

    ids = args.get("device_ids", -1)
    if isinstance(ids, (list, tuple)) and len(ids) > 1:
        refuse("training on several devices")
    if args.training.get("overlap_sampler", False):
        refuse("training.overlap_sampler")
    if args.training.get("profile_steps", None):
        refuse("the profiler window (training.profile_steps)")


def main_function(args, device=None) -> dict:
    """Train; returns {"it", "exp_dir", "final_ckpt", "stats", "resumed_opt"}."""
    dev = get_device(device if device is not None else args.get("device", None))
    exp_dir = args.training.exp_dir
    io_util.cond_mkdir(exp_dir)
    logger = Logger(log_dir=exp_dir, img_dir=os.path.join(exp_dir, "imgs"),
                    monitoring=args.training.get("monitoring", "tensorboard"),
                    monitoring_dir=os.path.join(exp_dir, "events"))
    log.info(f"=> Experiments dir: {exp_dir} (device {dev})")
    io_util.backup(os.path.join(exp_dir, "backup"))
    config_lib.save_config(args, os.path.join(exp_dir, "config.yaml"))

    dataset, val_dataset = get_data(args, return_val=True,
                                    val_downscale=args.data.get("val_downscale", 4.0))
    seed = int(args.get("seed", 42))
    model, render_kwargs_train, render_kwargs_test, render_factory = get_model(
        args, dev, seed=seed)
    render_kwargs_train["H"], render_kwargs_train["W"] = dataset.H, dataset.W
    log.info(f"=> Model params: {count_parameters(model)}")
    optimizer, scheduler = make_optimizer(args, model)
    lr_factor = make_schedule(args)
    lr_cfg = args.training.lr
    base_lr = float(lr_cfg["default"] if isinstance(lr_cfg, dict) else lr_cfg)

    # ---- checkpoints ----
    checkpoint_io = CheckpointIO(checkpoint_dir=os.path.join(exp_dir, "ckpts"))
    load_dict = checkpoint_io.load_file(
        args.training.get("ckpt_file", None),
        ignore_keys=args.training.get("ckpt_ignore_keys", []),
        only_use_keys=args.training.get("ckpt_only_use_keys", None))
    logger.load_stats("stats.p")
    it = int(load_dict.get("global_step", 0))
    epoch_idx = int(load_dict.get("epoch_idx", 0))
    num_iters = int(args.training.num_iters)
    _refuse_unported(args)
    if "model" in load_dict:
        bridge.load_tree(model, load_dict["model"], strict=False)
    resumed_opt = "torch_opt_state" in load_dict
    if resumed_opt:
        load_optimizer_state(optimizer, load_dict["torch_opt_state"])
        scheduler.last_epoch = it
    elif it > 0:
        # a params-only checkpoint (e.g. the JAX trainer's, whose optax state
        # cannot be read here): the lr resumes at `it`, Adam's moments restart
        fast_forward_schedule(optimizer, scheduler, it)
        log.info(f"=> resumed the lr schedule at it={it}; Adam's moments restart")

    def save(filename):
        checkpoint_io.save(filename, global_step=it, epoch_idx=epoch_idx,
                           model=bridge.model_to_tree(model),
                           torch_opt_state=optimizer_state_to_numpy(optimizer))

    # ---- SIREN sphere pretrain (after the checkpoint load, as in the JAX trainer)
    surface = model.implicit_surface
    if (surface.use_siren and surface.geometric_init and it == 0
            and "model" not in load_dict):
        log.info("=> pretraining SIREN sdf to a sphere ...")
        pre_losses = pretrain_siren_sdf(
            surface, lr=float(args.training.get("lr_pretrain", 1e-4)),
            target_radius=surface.radius_init,
            obj_bounding_size=surface.obj_bounding_size,
            generator=torch.Generator(device=dev).manual_seed(seed + 7))
        log.info(f"   pretrain final l1: {float(pre_losses[-1]):.4f}")
        save("latest.pt")

    # ---- data on the device, the step ----
    data_dev = {"c2w": torch.as_tensor(np.asarray(dataset.c2w_all, np.float32), device=dev),
                "intrinsics": torch.as_tensor(np.asarray(dataset.intrinsics_all, np.float32),
                                              device=dev),
                "rgb": torch.as_tensor(np.asarray(dataset.rgb_images, np.float32),
                                       device=dev).reshape(len(dataset), -1, 3)}
    if (bool(args.training.get("with_mask", False))
            and getattr(dataset, "object_masks", None) is not None):
        data_dev["object_mask"] = torch.as_tensor(
            np.asarray(dataset.object_masks), device=dev).reshape(len(dataset), -1)
    if getattr(dataset, "masks_ignore", None) is not None:
        data_dev["mask_ignore"] = torch.as_tensor(
            np.asarray(dataset.masks_ignore), device=dev).reshape(len(dataset), -1)
    n_images = int(data_dev["c2w"].shape[0])
    N_rays = int(args.data.N_rays)
    step_fn = make_train_step(make_trainer(args, model, render_kwargs_train),
                              model, optimizer, scheduler)
    generator = torch.Generator(device=dev).manual_seed(seed)

    # ---- validation renderer ----
    val_kwargs = {k: v for k, v in render_kwargs_test.items()
                  if k not in ("H", "W", "rayschunk")}
    val_rayschunk = int(args.data.get("val_rayschunk", 4096))

    def do_validation(it):
        val_idx = int(np.random.RandomState(seed + it).randint(len(val_dataset)))
        _, val_in, val_gt = val_dataset[val_idx]
        Hv, Wv = val_dataset.H, val_dataset.W
        rays_o, rays_d, _ = get_rays(
            torch.as_tensor(np.asarray(val_in["c2w"], np.float32), device=dev),
            torch.as_tensor(np.asarray(val_in["intrinsics"], np.float32), device=dev),
            Hv, Wv)
        # at the current step's render kwargs (UNISURF's decayed interval)
        render_fn_test = render_factory(detailed_output=False, calc_normal=True,
                                        **val_kwargs, **checkpoint_render_kwargs(args, it))
        ret = render_full_image(render_fn_test, rays_o, rays_d, rayschunk=val_rayschunk,
                                generator=torch.Generator(device=dev).manual_seed(seed + it))

        def to_img(t):
            return np.asarray(lin2img(torch.as_tensor(np.asarray(t)), Hv, Wv))
        logger.add_imgs(to_img(np.asarray(val_gt["rgb"]).reshape(-1, 3)), "val/gt_rgb", it)
        logger.add_imgs(to_img(ret["rgb"]), "val/predicted_rgb", it)
        depth = ret["depth_volume"][..., None]
        logger.add_imgs(to_img(depth / (depth.max() + 1e-10)), "val/pred_depth_volume", it)
        logger.add_imgs(to_img(ret["mask_volume"][..., None]), "val/pred_mask_volume", it)
        if "depth_surface" in ret:  # UNISURF's root-found surface
            ds = ret["depth_surface"][..., None]
            logger.add_imgs(to_img(ds / (ds.max() + 1e-10)), "val/pred_depth_surface", it)
        if "mask_surface" in ret:
            logger.add_imgs(to_img(ret["mask_surface"][..., None].astype(np.float32)),
                            "val/predicted_mask", it)
        logger.add_imgs(to_img(ret["normals_volume"] / 2.0 + 0.5),
                        "val/predicted_normals", it)
        if "beta_map" in ret:  # VolSDF diagnostics (ref volsdf.py:647-683)
            bm = ret["beta_map"][..., None]
            logger.add_imgs(to_img(bm / (bm.max() + 1e-10)), "val/beta_heat_map", it)
            iu = ret["iter_usage"][..., None].astype(np.float32)
            iu[iu == -1] = iu.max() + 1
            logger.add_imgs(to_img(iu / (iu.max() + 1e-10)), "val/upsample_iters", it)

    mesh_dir = os.path.join(exp_dir, "meshes")

    def do_mesh(it):
        io_util.cond_mkdir(mesh_dir)
        out = extract_mesh(model.implicit_surface.forward_query,
                           volume_size=float(args.data.get("volume_size", 2.0)),
                           N=int(args.data.get("mesh_N", 256)),
                           filepath=os.path.join(mesh_dir, f"{it:08d}.ply"), device=dev)
        logger.add("perf", "mesh_sec", out["grid_s"] + out["triangulate_s"] + out["write_s"], it)

    # ---- loop ----
    i_save = args.training.get("i_save", 900)
    i_backup = int(args.training.get("i_backup", 50000))
    i_val = int(args.training.get("i_val", 500))
    i_log = int(args.training.get("i_log", 20))
    i_param_hist = int(args.training.get("i_param_hist", -1))
    K = max(1, int(args.training.get("steps_per_call", 1)))
    log.info(f"=> Start training..., it={it}, in {exp_dir} ({K} steps between checks)")
    t0 = t_last_log = time.time()
    it_last_log = it
    perm = np.random.RandomState(seed + epoch_idx).permutation(n_images)
    perm_pos = 0
    metrics, step_totals = None, []

    def _next_multiple(x, m):
        return ((x // m) + (1 if x % m else 0)) * m if x > 0 else 0

    next_val = _next_multiple(it, i_val) if i_val > 0 else None
    mesh_its = mesh_steps(it, int(args.training.get("i_val_mesh", 10000)), num_iters)
    next_log = it + i_log
    try:
        while it < num_iters:
            if next_val is not None and it >= next_val:
                do_validation(it)
                while next_val <= it:
                    next_val += i_val
            while mesh_its and it >= mesh_its[0]:
                do_mesh(mesh_its.pop(0))

            K_eff = min(K, num_iters - it)
            for _ in range(K_eff):
                if perm_pos >= n_images:
                    epoch_idx += 1
                    perm = np.random.RandomState(seed + epoch_idx).permutation(n_images)
                    perm_pos = 0
                idx = int(perm[perm_pos])
                perm_pos += 1
                batch = {k: v[idx:idx + 1] for k, v in data_dev.items()}
                metrics = step_fn(batch, generator, it)
                step_totals.append((it, metrics["losses"]["total"]))
                it += 1

            if i_param_hist > 0 and (it % i_param_hist) < K_eff and it >= i_param_hist:
                logger.add_module_param("model", model, it)

            # ---- logging: one device-to-host copy every >= i_log steps ----
            if it >= next_log and metrics is not None:
                next_log = it + i_log
                flat = [(("losses", k), v) for k, v in metrics["losses"].items()]
                flat += [(("grad", k), v) for k, v in metrics["grad_norms"].items()]
                flat += [(("scalars", k), v) for k, v in metrics.get("scalars", {}).items()]
                flat += [(("extras", k), v) for k, v in metrics["extras_stats"].items()]
                flat += [(("step", i), v) for i, v in step_totals]
                vals = torch.stack([v.float().reshape(()) for _, v in flat]).cpu().tolist()
                m = {key: v for (key, _), v in zip(flat, vals)}
                step_totals = []
                # NaN watchdog: save the state at the failure and halt
                if not np.isfinite(m[("losses", "total")]):
                    log.error(f"non-finite loss at it={it} — saving nan_{it:08d}.pt")
                    save(f"nan_{it:08d}.pt")
                    logger.save_stats("stats.p")
                    if bool(args.training.get("halt_on_nan", True)):
                        raise RuntimeError(f"training diverged (non-finite loss) at "
                                           f"it={it}; forensic checkpoint saved")
                for (cat, k), v in m.items():
                    if cat == "losses":
                        logger.add("losses", k, v, it)
                    elif cat == "grad":
                        logger.add("grad", k, v, it)
                    elif cat == "scalars":
                        logger.add("scalars", k, v, it)
                    elif cat == "extras":
                        name, stat = k.rsplit(".", 1)
                        logger.add(f"extras_{name}", f"whole.{stat}", v, it)
                    else:  # every step's total since the last log
                        logger.add("losses", "total_per_step", v, k)
                logger.add("learning rates", "whole", base_lr * lr_factor(it), it)
                dt = (time.time() - t_last_log) / max(it - it_last_log, 1)
                t_last_log, it_last_log = time.time(), it
                logger.add("perf", "sec_per_step", dt, it)
                log.info(f"it={it} loss={m[('losses', 'total')]:.4f} "
                         f"({dt * 1000:.0f} ms/step, {N_rays / max(dt, 1e-9):.0f} rays/s)")

            if i_save > 0 and time.time() - t0 > i_save:
                save("latest.pt")
                logger.save_stats("stats.p")
                t0 = time.time()
            if i_backup > 0 and (it % i_backup) < K_eff and it >= i_backup:
                save(f"{it:08d}.pt")
    except KeyboardInterrupt:
        save("latest.pt")
        logger.save_stats("stats.p")
        sys.exit()

    final = f"final_{it:08d}.pt"
    save(final)
    logger.save_stats("stats.p")
    log.info("Everything done.")
    return {"it": it, "exp_dir": exp_dir, "stats": logger.stats,
            "final_ckpt": os.path.join(checkpoint_io.checkpoint_dir, final),
            "resumed_opt": resumed_opt}


def _extra_args(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu (plain PyTorch path)")


if __name__ == "__main__":
    config, _args = config_lib.parse_cli(extra_args_fn=_extra_args)
    main_function(config)
