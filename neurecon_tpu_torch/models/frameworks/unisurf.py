"""UNISURF: occupancy volume rendering around a root-found surface (port of
`neurecon_tpu/models/frameworks/unisurf.py`).

  * occupancy logits, (+) outside and (-) inside: opacity = sigmoid(-logit)
    and its inverse `get_surface_from_opacity`;
  * nablas normalized before they enter the radiance net;
  * the sampler: a gradient-free root find per ray (a 256-step march and 8
    secant steps through `forward_surface_fast`, the sdf-only CUDA kernel
    on a card, `models/ray_casting.py`), N_query stratified samples in
    [d - Δ, d + Δ] and N_freespace in [near, d - Δ], with the
    no-intersection and too-close fallbacks;
  * one batched query over the render points (and, in training with
    w_reg > 0, the surface point and a jittered neighbour): the
    forward+nablas kernel, and in training its backward (the eikonal
    backward kernel) through `ops/fused_nablas_vjp.py`;
  * Δ decays with the training step: max(δ_max exp(-it δ_β), δ_min)
    (`interval_at`); a checkpoint renders at its step's Δ
    (`frameworks.checkpoint_render_kwargs`);
  * the loss: L1 rgb + w_reg x the smoothness of the unit normals between
    each surface point and its neighbour.

Every random draw comes from the caller's `torch.Generator`; `uniforms=`
takes the draws instead (a test feeds those of the JAX package's keys).
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from neurecon_tpu_torch.models.base import ImplicitSurface, RadianceNet
from neurecon_tpu_torch.models.ray_casting import root_finding_surface_points
from neurecon_tpu_torch.ops import linspace01, near_far_from_sphere
from neurecon_tpu_torch.parallel.sharding import RayShard


class UNISURF(nn.Module):
    def __init__(self,
                 input_ch: int = 3,
                 W_geo_feat: int = -1,
                 surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None):
        super().__init__()
        self.implicit_surface = ImplicitSurface(
            input_ch=input_ch, W_geo_feat=W_geo_feat, **(surface_cfg or {}))
        if W_geo_feat < 0:
            W_geo_feat = self.implicit_surface.W
        self.radiance_net = RadianceNet(W_geo_feat=W_geo_feat, **(radiance_cfg or {}))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.implicit_surface.reset_parameters(gen)
        self.radiance_net.reset_parameters(gen)

    def forward_surface(self, x):
        return self.implicit_surface(x)

    def forward_surface_fast(self, x):
        """Gradient-free occupancy-logit query (the sdf-only kernel on a card)."""
        return self.implicit_surface.forward_query(x)

    def forward_with_nablas(self, x):
        return self.implicit_surface.forward_with_nablas(x)

    def forward(self, x, view_dirs):
        """(radiance, logit, nablas) at points x [..., 3]; the radiance net
        sees the unit normal (occupancy nablas have no unit norm)."""
        occ, nablas, geo_feat = self.forward_with_nablas(x)
        normals = nablas / (torch.linalg.norm(nablas, dim=-1, keepdim=True) + 1e-10)
        radiances = self.radiance_net(x, view_dirs, normals, geo_feat)
        return radiances, occ, nablas

    @staticmethod
    def get_surface_from_opacity(opacity, eps: float = 1e-4):
        opacity = np.clip(opacity, eps, 1 - eps)
        # logits are (+) outside: the opposite sign of the opacity's logit
        return -1.0 * np.log(opacity / (1 - opacity))

    @staticmethod
    def get_opacity_from_surface(logits):
        odds = torch.exp(-1.0 * logits)
        return odds / (1 + odds)


def _stratified(lower, upper, N: int, perturb: bool, u=None):
    """N samples in per-ray [lower, upper] ([...] each -> [..., N]): one in
    each of N equal strata at the uniforms u [..., N] (perturb), or the N
    evenly spaced depths with both ends."""
    if perturb:
        t = linspace01(N + 1, lower.device)
        edges = lower[..., None] * (1 - t) + upper[..., None] * t
        lo, hi = edges[..., :-1], edges[..., 1:]
        return lo + (hi - lo) * u
    t = linspace01(N, lower.device)
    return lower[..., None] * (1 - t) + upper[..., None] * t


def _prepare_rays(rays_o, rays_d, radius_of_interest,
                  near_bypass=None, far_bypass=None):
    """Flat float rays [N, 3] with unit directions, and near / far [N] on the
    sphere of interest."""
    rays_o = rays_o.reshape(-1, 3).float()
    rays_d = rays_d.reshape(-1, 3).float()
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near, far = near_far_from_sphere(rays_o, rays_d, r=radius_of_interest, keepdim=False)
    if near_bypass is not None:
        near = torch.full_like(near, near_bypass)
    if far_bypass is not None:
        far = torch.full_like(far, far_bypass)
    return rays_o.contiguous(), rays_d.contiguous(), near, far


def compute_ray_samples(model: UNISURF, rays_o, rays_d,
                        *,
                        logit_tau: float = 0.0,
                        method: str = "secant",
                        near_bypass: Optional[float] = None,
                        far_bypass: Optional[float] = None,
                        radius_of_interest: float = 4.0,
                        N_steps: int = 256,
                        **dummy_kwargs):
    """The gradient-free surface root find, apart from the render: returns
    (d_pred_out, pt_pred, mask, mask_sign_change) flat over the rays, the
    form `surface_override=` takes. Misses keep `far` (fill_inf off)."""
    rays_o, rays_d, near, far = _prepare_rays(
        rays_o, rays_d, radius_of_interest, near_bypass, far_bypass)
    return root_finding_surface_points(
        model.forward_surface_fast, rays_o, rays_d, near=near, far=far,
        N_steps=N_steps, method=method, logit_tau=logit_tau, fill_inf=False)


def volume_render_rays(model: UNISURF, rays_o, rays_d, interval,
                       *,
                       generator: Optional[torch.Generator] = None,
                       uniforms=None,
                       logit_tau: float = 0.0,
                       use_view_dirs: bool = True,
                       method: str = "secant",
                       white_bkgd: bool = False,
                       near_bypass: Optional[float] = None,
                       far_bypass: Optional[float] = None,
                       radius_of_interest: float = 4.0,
                       perturb: bool = False,
                       too_close_threshold: float = 0.1,
                       N_query: int = 64,
                       N_freespace: int = 32,
                       N_steps: int = 256,
                       calc_normal: bool = False,
                       detailed_output: bool = True,
                       reg_perturb: Optional[float] = None,
                       surface_override=None,
                       **dummy_kwargs):
    """Render a flat batch of rays [N, 3] at the sampling interval Δ
    (`interval`, a float). Differentiable in the model's parameters where
    grad is on; the samples never carry a gradient.

    uniforms: (u_interval [N, N_query], u_free [N, N_freespace], u_reg
    [N, 3]) in place of draws from `generator` (the first two used with
    `perturb`, the last with `reg_perturb`). reg_perturb (training only):
    also query the nablas at the surface point and at a neighbour jittered
    by up to ±reg_perturb, in the same batched call, and return them as
    ret['nablas_surface_reg'] [N, 2, 3]. surface_override: the root find's
    output (`compute_ray_samples`) in place of running it."""
    rays_o, rays_d, near, far = _prepare_rays(
        rays_o, rays_d, radius_of_interest, near_bypass, far_bypass)
    N, dev = rays_o.shape[0], rays_o.device
    view_dirs = rays_d if use_view_dirs else None
    d_threshold = near + (far - near) * too_close_threshold

    if surface_override is not None:
        d_pred_out, pt_pred, mask, mask_sign_change = (
            surface_override[0].reshape(N).detach(), surface_override[1].reshape(N, 3).detach(),
            surface_override[2].reshape(N), surface_override[3].reshape(N))
    else:
        d_pred_out, pt_pred, mask, mask_sign_change = root_finding_surface_points(
            model.forward_surface_fast, rays_o, rays_d, near=near, far=far,
            N_steps=N_steps, method=method, logit_tau=logit_tau, fill_inf=False)

    if uniforms is None:
        def draw(*shape):
            return torch.rand(*shape, generator=generator, device=dev)
        uniforms = (draw(N, N_query) if perturb else None,
                    draw(N, N_freespace) if perturb else None,
                    draw(N, 3) if reg_perturb is not None else None)
    u_interval, u_free, u_reg = uniforms

    d_pred_out = torch.minimum(torch.maximum(d_pred_out, near), far)
    d_upper = torch.minimum(d_pred_out + interval, far)
    d_lower = torch.maximum(d_pred_out - interval, near)
    d_samples_interval = _stratified(d_lower, d_upper, N_query, perturb, u_interval)

    # the free-space samples end at the interval's start, kept past the
    # too-close threshold; rays without a crossing, or degenerate, take far
    d_lower = torch.maximum(d_lower, d_threshold)
    d_lower = torch.where(mask_sign_change, d_lower, far)
    d_lower = torch.where(d_lower < 1e-10, far, d_lower)
    d_samples_freespace = _stratified(near, d_lower, N_freespace, perturb, u_free)

    d_all = torch.sort(torch.cat([d_samples_freespace, d_samples_interval], -1), -1).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * d_all[..., None]
    P_render = pts.shape[-2]
    if reg_perturb is not None:
        neighbors = pt_pred + (u_reg - 0.5) * 2.0 * reg_perturb
        pts = torch.cat([pts, pt_pred[:, None, :], neighbors[:, None, :]], dim=-2)

    views = view_dirs[:, None, :].expand_as(pts) if use_view_dirs else None
    radiances, logits, nablas = model(pts, views)
    nablas_surface_reg = None
    if reg_perturb is not None:
        nablas_surface_reg = nablas[:, P_render:]
        radiances, logits, nablas = (radiances[:, :P_render], logits[:, :P_render],
                                     nablas[:, :P_render])

    opacity_alpha = UNISURF.get_opacity_from_surface(logits)
    shifted_transparency = torch.cat(
        [torch.ones_like(opacity_alpha[..., :1]),
         torch.clamp(1.0 - opacity_alpha, min=0.0) + 1e-10], dim=-1)
    visibility_weights = opacity_alpha * torch.cumprod(shifted_transparency, dim=-1)[..., :-1]

    rgb_map = torch.sum(visibility_weights[..., None] * radiances, dim=-2)
    depth_map = torch.sum(
        visibility_weights / (torch.sum(visibility_weights, -1, keepdim=True) + 1e-10) * d_all,
        dim=-1)
    acc_map = torch.sum(visibility_weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    ret = {"rgb": rgb_map, "depth_volume": depth_map, "mask_volume": acc_map,
           "mask_surface": mask, "depth_surface": d_pred_out}
    if nablas_surface_reg is not None:
        ret["nablas_surface_reg"] = nablas_surface_reg
    if calc_normal:
        normals_map = nablas / (torch.linalg.norm(nablas, dim=-1, keepdim=True) + 1e-10)
        ret["normals_volume"] = torch.sum(normals_map * visibility_weights[..., None], dim=-2)
    if detailed_output:
        ret.update({"surface_points": pt_pred, "radiance": radiances,
                    "implicit_surface": logits, "implicit_nablas": nablas,
                    "alpha": opacity_alpha, "visibility_weights": visibility_weights})
    return ret


def interval_at(args, it) -> float:
    """The sampling interval Δ of training step `it`: max(delta_max
    exp(-it delta_beta), delta_min). A checkpoint renders at its own step's
    Δ: one trained at delta_min has its radiance supervised only in that
    narrow band around the surface."""
    t = args.training
    return float(max(float(t.delta_max) * math.exp(-float(it) * float(t.delta_beta)),
                     float(t.delta_min)))


def _interval_f32(it, delta_max: float, delta_min: float, delta_beta: float) -> float:
    """`interval_at` in float32, as the JAX loss computes it inside its step."""
    f = np.float32
    return float(max(f(delta_max) * np.exp(f(-f(it)) * f(delta_beta)), f(delta_min)))


def make_volume_render_fn(model: UNISURF, default_interval: float = 1.0,
                          interval: Optional[float] = None, **render_kwargs):
    """(rays_o, rays_d, generator=None, interval=None, surface_override=None,
    uniforms=None) -> (rgb, depth, extras), leading batch dims preserved.
    The interval defaults to `interval` (a checkpoint's, from
    `checkpoint_render_kwargs`), else `default_interval`."""
    for k in ("H", "W", "rayschunk", "netchunk", "batched", "tau"):
        render_kwargs.pop(k, None)
    bound_interval = default_interval if interval is None else interval

    def render(rays_o, rays_d, generator=None, interval=None, surface_override=None,
               uniforms=None):
        prefix = rays_o.shape[:-1]
        ret = volume_render_rays(model, rays_o, rays_d,
                                 bound_interval if interval is None else interval,
                                 generator=generator, uniforms=uniforms,
                                 surface_override=surface_override, **render_kwargs)
        ret = {k: v.reshape(prefix + v.shape[1:]) for k, v in ret.items()}
        return ret["rgb"], ret["depth_volume"], ret

    return render


def make_ray_loss_fn(model: UNISURF, args, render_kwargs_train: dict,
                     shard: Optional[RayShard] = None):
    """ray_loss(rb, generator=None, it=0, surface_override=None,
    uniforms=None) -> (total, (losses, extras)) on a ray batch from
    `training.sample_ray_batch`. With a `shard`, `rb` is this rank's block
    and the losses its shares."""
    shard = shard or RayShard()
    w_reg = float(args.training.setdefault("w_reg", 0.0))
    perturb_surface_pts = float(args.training.setdefault("perturb_surface_pts", 0.01))
    deltas = (float(args.training.delta_max), float(args.training.delta_min),
              float(args.training.delta_beta))
    render_fn = make_volume_render_fn(
        model, detailed_output=True,
        reg_perturb=(perturb_surface_pts if w_reg > 0 else None),
        **{k: v for k, v in render_kwargs_train.items() if k not in ("H", "W")})

    def unit(v):
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-10)

    def ray_loss(rb, generator=None, it=0, surface_override=None, uniforms=None):
        interval = _interval_f32(it, *deltas)
        rgb, _depth, extras = render_fn(rb["rays_o"], rb["rays_d"], generator,
                                        interval=interval, surface_override=surface_override,
                                        uniforms=uniforms)
        losses = {"loss_img": shard.mean(torch.abs(rgb - rb["target_rgb"]))}
        if w_reg > 0:
            # the unit normals: unnormalized occupancy nablas blow up the
            # gradient
            reg = extras["nablas_surface_reg"]
            losses["loss_reg"] = w_reg * shard.mean(
                (unit(reg[..., 1, :]) - unit(reg[..., 0, :])) ** 2)
        else:
            losses["loss_reg"] = torch.zeros((), device=rgb.device)
        losses["total"] = losses["loss_img"] + losses["loss_reg"]
        extras["scalars"] = {"interval": torch.full((), interval, device=rgb.device)}
        return losses["total"], (losses, extras)

    return ray_loss


def draw_step_uniforms(render_kwargs_train: dict, w_reg: float, N: int, generator,
                       device) -> tuple:
    """A training step's draws after its pixels, at N rays, in the order the
    render makes them (`volume_render_rays`' `uniforms`): the interval's and
    the free space's under `perturb`, then the regularisation neighbours'
    (with `w_reg` > 0)."""
    kw = render_kwargs_train

    def draw(*shape):
        return torch.rand(*shape, generator=generator, device=device)
    return (draw(N, kw["N_query"]) if kw["perturb"] else None,
            draw(N, kw["N_freespace"]) if kw["perturb"] else None,
            draw(N, 3) if w_reg > 0 else None)


def _draw_step(args, render_kwargs_train: dict, shard: RayShard):
    from neurecon_tpu_torch.training import make_draw_step

    w_reg = float(args.training.setdefault("w_reg", 0.0))
    return make_draw_step(
        render_kwargs_train["H"], render_kwargs_train["W"], int(args.data.N_rays),
        lambda N, g, dev: draw_step_uniforms(render_kwargs_train, w_reg, N, g, dev), shard)


def make_pipeline_fns(model: UNISURF, args, render_kwargs_train: dict,
                      shard: Optional[RayShard] = None) -> dict:
    """The training step split for the pipelined step, as
    `neus.make_pipeline_fns`: depth_sample(rb, uniforms) is the root find
    (`compute_ray_samples`: a march and 8 secant steps through kernel 4 on a
    card; it draws nothing), and loss_with_samples(rb, surface, uniforms,
    generator, it) the loss with the root find's output as
    `surface_override`, at step `it`'s interval."""
    shard = shard or RayShard()
    ray_loss = make_ray_loss_fn(model, args, render_kwargs_train, shard=shard)
    sample_kwargs = {k: v for k, v in render_kwargs_train.items()
                     if k not in ("H", "W", "rayschunk")}

    def depth_sample(rb, uniforms):
        return compute_ray_samples(model, rb["rays_o"], rb["rays_d"], **sample_kwargs)

    def loss_with_samples(rb, surface, uniforms, generator, it):
        return ray_loss(rb, generator, it, surface_override=surface, uniforms=uniforms)

    return {"draw_step": _draw_step(args, render_kwargs_train, shard),
            "depth_sample": depth_sample, "loss_with_samples": loss_with_samples}


def get_model(args, device=None, seed: int = 0):
    """(model, render_kwargs_train, render_kwargs_test, render_factory) from
    a config. The model is initialized on the CPU from `seed` (geometric
    init), then moved to `device`."""
    from neurecon_tpu_torch import get_device

    model_config = {"W_geo_feat": args.model.setdefault("W_geometry_feature", 256)}
    surface_cfg = {
        "use_siren": args.model.surface.setdefault(
            "use_siren", args.model.setdefault("use_siren", False)),
        "embed_multires": args.model.surface.setdefault("embed_multires", 6),
        "radius_init": args.model.surface.setdefault("radius_init", 1.0),
        "geometric_init": args.model.surface.setdefault("geometric_init", True),
        "D": args.model.surface.setdefault("D", 8),
        "W": args.model.surface.setdefault("W", 256),
        "skips": args.model.surface.setdefault("skips", [4]),
    }
    radiance_cfg = {
        "use_siren": args.model.radiance.setdefault(
            "use_siren", args.model.setdefault("use_siren", False)),
        "embed_multires": args.model.radiance.setdefault("embed_multires", -1),
        "embed_multires_view": args.model.radiance.setdefault("embed_multires_view", -1),
        "use_view_dirs": args.model.radiance.setdefault("use_view_dirs", True),
        "D": args.model.radiance.setdefault("D", 4),
        "W": args.model.radiance.setdefault("W", 256),
        "skips": args.model.radiance.setdefault("skips", []),
    }
    model = UNISURF(surface_cfg=surface_cfg, radiance_cfg=radiance_cfg, **model_config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(get_device(device))

    render_kwargs_train = {
        "perturb": args.model.setdefault("perturb", True),
        "white_bkgd": args.model.setdefault("white_bkgd", False),
        "logit_tau": float(UNISURF.get_surface_from_opacity(args.model.tau)),
        "radius_of_interest": args.model.obj_bounding_radius,
        "N_query": args.model.setdefault("N_query", 64),
        "N_freespace": args.model.setdefault("N_freespace", 32),
        "N_steps": args.model.setdefault("N_steps", 256),
    }
    render_kwargs_test = copy.deepcopy(render_kwargs_train)
    render_kwargs_test["rayschunk"] = args.data.val_rayschunk
    render_kwargs_test["perturb"] = False

    def render_factory(**kwargs):
        return make_volume_render_fn(model, **kwargs)

    return model, render_kwargs_train, render_kwargs_test, render_factory
