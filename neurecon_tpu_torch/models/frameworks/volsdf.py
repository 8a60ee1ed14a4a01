"""VolSDF volume rendering (port of `neurecon_tpu/models/frameworks/volsdf.py`).

The port carries the render and the training loss for the builtin sphere
background: the §3.4 error-bounded fine sampler (gradient-free; CUDA kernels
`volsdf_fine_sample` with the sdf-only kernel `sdf_forward`, through
`ops/fused_fine_sample.py`), one batched sdf + nablas + geometry query over
the coarse and fine samples and the eikonal points (CUDA kernel
`nablas_forward`, and in training its backward `nablas_backward`), the
radiance net, the p_i / tau_i compositor, the L1 + eikonal (+ optional sdf
anchor) losses, and the model's point queries for the surface renderer and
the mesh grids, for Softplus and SIREN nets alike (a SIREN surface is
pretrained to a sphere by `train.py`). The background is the builtin sphere
(sdf min R - |x|, `outside_scene: builtin`) or the NeRF++ background
(`outside_scene: nerf++`): then each ray ends where it leaves the sphere of
`obj_bounding_radius` (far 0 where it misses it), and N_outside samples
beyond, at radii R / t, go through the background net
(`models/base.py::NeRF`, plain PyTorch layers) and are composited after the
inside samples.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from neurecon_tpu_torch.models.base import ImplicitSurface, RadianceNet, outside_nerf
from neurecon_tpu_torch.ops import fused_fine_sample as ffs
from neurecon_tpu_torch.ops import get_dvals_from_radius, get_sphere_intersection
from neurecon_tpu_torch.ops.fused_fine_sample import error_bound, opacity_approx, sdf_to_sigma
from neurecon_tpu_torch.ops.sampling import linspace01, stratified_jitter
from neurecon_tpu_torch.parallel.sharding import RayShard
from neurecon_tpu_torch.utils.trace import span

__all__ = ["VolSDF", "sdf_to_sigma", "error_bound", "opacity_approx", "volume_render_rays",
           "compute_ray_samples", "make_volume_render_fn", "make_ray_loss_fn",
           "make_pipeline_fns", "get_model"]


class VolSDF(nn.Module):
    def __init__(self,
                 beta_init: float = 0.1,
                 speed_factor: float = 1.0,
                 input_ch: int = 3,
                 W_geo_feat: int = -1,
                 obj_bounding_radius: float = 3.0,
                 use_nerfplusplus: bool = False,
                 surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None):
        super().__init__()
        self.speed_factor = speed_factor
        self.ln_beta_init = np.log(beta_init) / speed_factor
        self.ln_beta = nn.Parameter(torch.tensor([self.ln_beta_init], dtype=torch.float32))
        self.use_sphere_bg = not use_nerfplusplus
        self.obj_bounding_radius = obj_bounding_radius
        self.implicit_surface = ImplicitSurface(
            W_geo_feat=W_geo_feat, input_ch=input_ch,
            obj_bounding_size=obj_bounding_radius, **(surface_cfg or {}))
        if W_geo_feat < 0:
            W_geo_feat = self.implicit_surface.W
        self.radiance_net = RadianceNet(W_geo_feat=W_geo_feat, **(radiance_cfg or {}))
        self.nerf_outside = outside_nerf() if use_nerfplusplus else None

    @property
    def sphere_bg_r(self):
        """The builtin background sphere's radius, or None under NeRF++."""
        return self.obj_bounding_radius if self.use_sphere_bg else None

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.ln_beta.fill_(self.ln_beta_init)
        self.implicit_surface.reset_parameters(gen)
        self.radiance_net.reset_parameters(gen)
        if self.nerf_outside is not None:
            self.nerf_outside.reset_parameters(gen)

    def forward_ab(self):
        """(alpha, beta) = (1 / beta, exp(ln_beta * speed_factor))."""
        beta = torch.exp(self.ln_beta[0] * self.speed_factor)
        return 1.0 / beta, beta

    def forward_surface(self, x):
        """sdf at x [..., 3], min the background sphere's R - |x| (builtin)."""
        return ffs.background_min(self.implicit_surface(x), x, self.sphere_bg_r)

    def forward_surface_fast(self, x):
        """Gradient-free sdf query (the sdf-only kernel on a card), min R - |x|
        (builtin)."""
        return ffs.background_min(self.implicit_surface.forward_query(x), x,
                                  self.sphere_bg_r)

    def forward_surface_with_nablas(self, x):
        """(sdf, nablas, h): with the builtin background the sdf (not the
        nablas) swapped for R - |x| where the background sphere is closer,
        which keeps more eikonal constraints (ref volsdf.py:317-325)."""
        sdf, nablas, h = self.implicit_surface.forward_with_nablas(x)
        if not self.use_sphere_bg:
            return sdf, nablas, h
        d_bg = self.obj_bounding_radius - torch.linalg.norm(x, dim=-1)
        return torch.where(d_bg < sdf, d_bg, sdf), nablas, h

    def forward_with_nablas(self, x):
        return self.implicit_surface.forward_with_nablas(x)

    def forward(self, x, view_dirs):
        """(radiance, sdf, nablas) at points x [..., 3]."""
        sdf, nablas, geo_feat = self.forward_surface_with_nablas(x)
        radiances = self.radiance_net(x, view_dirs, nablas, geo_feat)
        return radiances, sdf, nablas


def _ray_bounds(rays_o, rays_d, near, far, obj_bounding_radius=3.0, use_nerfplusplus=False):
    """Flat, normalized rays and per-ray [near, far]: the config's constants,
    and under NeRF++ the far where the ray leaves the sphere of
    `obj_bounding_radius` (0 where it misses it)."""
    rays_o = rays_o.reshape(-1, 3).float()
    rays_d = rays_d.reshape(-1, 3).float()
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    N = rays_o.shape[0]
    nears = torch.full((N, 1), float(near), device=rays_o.device)
    if use_nerfplusplus:
        _, fars, _ = get_sphere_intersection(rays_o, rays_d, r=obj_bounding_radius)
    else:
        fars = torch.full((N, 1), float(far), device=rays_o.device)
    return rays_o.contiguous(), rays_d.contiguous(), nears, fars.contiguous()


def _draw_uniforms(N, n_draws, n_final, perturb, generator, device):
    """The opacity draws' uniforms [N, n_draws * n_final]: jnp.linspace(0, 1,
    n_final) per draw, or unsorted draws from `generator`."""
    if not perturb:
        return ffs.det_uniforms(n_final, n_draws, N, device)
    return torch.rand(N, n_draws * n_final, generator=generator, device=device)


@torch.no_grad()
def _fine_samples(model: VolSDF, rays_o, rays_d, nears, fars, *, generator, perturb,
                  N_samples, N_importance, max_upsample_steps, max_bisection_steps, epsilon,
                  fine_sample_mul, u_fin):
    """The sampler on flat unit rays and their [near, far] (`_ray_bounds`)."""
    with span("volsdf.sample"):
        N = rays_o.shape[0]
        alpha, beta = model.forward_ab()
        # a denser d_init speeds up the up-sampling's convergence (ref volsdf.py:425-435)
        t_init = linspace01(N_samples * fine_sample_mul, rays_o.device)
        d_init = (nears * (1 - t_init) + fars * t_init).contiguous()
        if u_fin is None:
            u_fin = _draw_uniforms(N, max_upsample_steps + 2, N_importance, perturb, generator,
                                   rays_o.device)
        return ffs.fused_fine_sample(
            model.implicit_surface, rays_o, rays_d, d_init, fars, alpha.detach(), beta.detach(),
            u_fin, eps=epsilon, max_iter=max_upsample_steps,
            max_bisection=max_bisection_steps, n_final=N_importance,
            n_up=N_samples * fine_sample_mul, sphere_bg_r=model.sphere_bg_r)


def compute_ray_samples(model: VolSDF, rays_o, rays_d, *,
                        generator: Optional[torch.Generator] = None,
                        near: float = 0.0,
                        far: float = 6.0,
                        obj_bounding_radius: float = 3.0,
                        use_nerfplusplus: bool = False,
                        perturb: bool = False,
                        N_samples: int = 128,
                        N_importance: int = 64,
                        max_upsample_steps: int = 5,
                        max_bisection_steps: int = 10,
                        epsilon: float = 0.1,
                        fine_sample_mul: int = 4,
                        u_fin=None,
                        **dummy_kwargs):
    """The gradient-free §3.4 sampler: (d_fine [N, N_importance], beta_map
    [N], iter_usage [N] int32), flat over rays, as `volume_render_rays`
    samples them without a `fine_override` (so this followed by the render
    on its output is the render). `u_fin` [N, (max_upsample_steps + 2) *
    N_importance]: the draws' uniforms (`_draw_uniforms`) in place of
    drawing them."""
    rays_o, rays_d, nears, fars = _ray_bounds(rays_o, rays_d, near, far, obj_bounding_radius,
                                              use_nerfplusplus)
    return _fine_samples(
        model, rays_o, rays_d, nears, fars, generator=generator, perturb=perturb,
        N_samples=N_samples, N_importance=N_importance, max_upsample_steps=max_upsample_steps,
        max_bisection_steps=max_bisection_steps, epsilon=epsilon,
        fine_sample_mul=fine_sample_mul, u_fin=u_fin)


def volume_render_rays(model: VolSDF, rays_o, rays_d,
                       *,
                       generator: Optional[torch.Generator] = None,
                       near: float = 0.0,
                       far: float = 6.0,
                       obj_bounding_radius: float = 3.0,
                       use_view_dirs: bool = True,
                       white_bkgd: bool = False,
                       use_nerfplusplus: bool = False,
                       perturb: bool = False,
                       N_samples: int = 128,
                       N_importance: int = 64,
                       N_outside: int = 32,
                       max_upsample_steps: int = 5,
                       max_bisection_steps: int = 10,
                       epsilon: float = 0.1,
                       fine_sample_mul: int = 4,
                       calc_normal: bool = False,
                       detailed_output: bool = True,
                       eik_pts=None,
                       fine_override=None,
                       u_out=None,
                       u_fin=None,
                       **dummy_kwargs):
    """Render a flat batch of rays [N, 3] -> dict of per-ray outputs.

    Differentiable in the model's parameters where grad is on (training); the
    fine samples never carry a gradient. `eik_pts` [N, K, 3]: extra points
    whose nablas the trainer needs, appended to the one batched network query
    and returned as ret['eik_nablas']. `fine_override` (d_fine, beta_map,
    iter_usage) replaces the sampler's output. Under NeRF++ the N_outside
    radii are jittered under `perturb` by the uniforms `u_out` [N,
    N_outside] (drawn from `generator` when None); `u_fin` is the sampler's
    (see `compute_ray_samples`)."""
    rays_o, rays_d, nears, fars = _ray_bounds(rays_o, rays_d, near, far, obj_bounding_radius,
                                              use_nerfplusplus)
    view_dirs = rays_d if use_view_dirs else None
    N = rays_o.shape[0]
    _t = linspace01(N_samples, rays_o.device)
    d_coarse = nears * (1 - _t) + fars * _t
    alpha, beta = model.forward_ab()

    if fine_override is not None:
        d_fine, beta_map, iter_usage = (t.detach() for t in fine_override)
        d_fine = d_fine.reshape(N, -1).float()
        beta_map, iter_usage = beta_map.reshape(N), iter_usage.reshape(N)
    else:
        d_fine, beta_map, iter_usage = _fine_samples(
            model, rays_o, rays_d, nears, fars, generator=generator, perturb=perturb,
            N_samples=N_samples, N_importance=N_importance,
            max_upsample_steps=max_upsample_steps, max_bisection_steps=max_bisection_steps,
            epsilon=epsilon, fine_sample_mul=fine_sample_mul, u_fin=u_fin)

    with span("volsdf.render"):
        # the paper samples the fine set only; the coarse concat avoids early
        # local minima (ref volsdf.py:439-443)
        d_all = torch.sort(torch.cat([d_coarse, d_fine], dim=-1), dim=-1).values
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d_all[..., None]
        P = pts.shape[-2]
        if eik_pts is not None:
            pts = torch.cat([pts, eik_pts.reshape(N, -1, 3).float()], dim=-2)
        views = view_dirs[:, None, :].expand_as(pts) if use_view_dirs else None
        radiances, sdf, nablas = model(pts, views)
        eik_nablas = None
        if eik_pts is not None:
            eik_nablas = nablas[:, P:]
            radiances, sdf, nablas = radiances[:, :P], sdf[:, :P], nablas[:, :P]
        sigma = sdf_to_sigma(sdf, alpha, beta)

        sigma_out = radiance_out = None
        if use_nerfplusplus:
            t_out = linspace01(N_outside + 2, rays_o.device)[1:-1]
            rs = (obj_bounding_radius / torch.flip(t_out, dims=[-1])).expand(N, N_outside)
            if perturb:
                if u_out is None:
                    u_out = torch.rand(N, N_outside, generator=generator, device=rays_o.device)
                rs = stratified_jitter(rs, u_out.reshape(N, N_outside))
            d_out = get_dvals_from_radius(rays_o, rays_d, rs)
            pts_out = rays_o[:, None, :] + rays_d[:, None, :] * d_out[..., None]
            x_out = torch.cat([pts_out / rs[..., None], 1.0 / rs[..., None]], dim=-1)
            views_out = view_dirs[:, None, :].expand_as(pts_out) if use_view_dirs else None
            sigma_out, radiance_out = model.nerf_outside(x_out, views_out)
            d_all = torch.cat([d_all, d_out], dim=-1)  # already sorted
            sigma = torch.cat([sigma, sigma_out], dim=-1)
            radiances = torch.cat([radiances, radiance_out], dim=-2)

        # p_i = exp(-relu(sigma delta)); tau_i = (1 - p_i) * cumprod(shifted p)
        delta = d_all[:, 1:] - d_all[:, :-1]
        p_i = torch.exp(-torch.clamp(sigma[:, :-1] * delta, min=0.0))
        tau_i = (torch.clamp(1 - p_i, min=0.0) + 1e-10) * torch.cumprod(
            torch.cat([torch.ones_like(p_i[:, :1]), p_i], dim=-1), dim=-1)[:, :-1]
        rgb_map = torch.sum(tau_i[..., None] * radiances[:, :-1], dim=-2)
        depth_map = torch.sum(tau_i / (torch.sum(tau_i, -1, keepdim=True) + 1e-10)
                              * d_all[:, :-1], dim=-1)
        acc_map = torch.sum(tau_i, dim=-1)
        if white_bkgd:
            rgb_map = rgb_map + (1.0 - acc_map[..., None])

        ret = {"rgb": rgb_map, "depth_volume": depth_map, "mask_volume": acc_map,
               # per-ray diagnostics: the beta heat-map and the upsampling rounds used
               "beta_map": beta_map, "iter_usage": iter_usage}
        if eik_nablas is not None:
            ret["eik_nablas"] = eik_nablas
        if calc_normal:
            normals_map = nablas / (torch.linalg.norm(nablas, dim=-1, keepdim=True) + 1e-10)
            Pn = min(tau_i.shape[-1], normals_map.shape[-2])
            ret["normals_volume"] = torch.sum(normals_map[:, :Pn] * tau_i[:, :Pn, None], dim=-2)
        if detailed_output:
            ret.update({"implicit_surface": sdf, "implicit_nablas": nablas,
                        "radiance": radiances, "alpha": 1.0 - p_i, "p_i": p_i,
                        "visibility_weights": tau_i, "d_vals": d_all, "sigma": sigma})
            if use_nerfplusplus:
                ret.update({"sigma_out": sigma_out, "radiance_out": radiance_out})
        return ret


def make_volume_render_fn(model: VolSDF, **render_kwargs):
    """(rays_o, rays_d, generator=None, eik_pts=None, fine_override=None,
    u_out=None, u_fin=None) -> (rgb, depth, extras), leading batch dims
    preserved."""
    for k in ("H", "W", "rayschunk", "netchunk", "batched"):
        render_kwargs.pop(k, None)

    def render(rays_o, rays_d, generator=None, eik_pts=None, fine_override=None, u_out=None,
               u_fin=None):
        prefix = rays_o.shape[:-1]
        if eik_pts is not None:
            eik_pts = eik_pts.reshape(-1, *eik_pts.shape[len(prefix):])
        ret = volume_render_rays(model, rays_o, rays_d, generator=generator,
                                 eik_pts=eik_pts, fine_override=fine_override,
                                 u_out=u_out, u_fin=u_fin, **render_kwargs)
        ret = {k: v.reshape(prefix + v.shape[1:]) for k, v in ret.items()}
        return ret["rgb"], ret["depth_volume"], ret

    return render


def make_ray_loss_fn(model: VolSDF, args, render_kwargs_train: dict,
                     shard: Optional[RayShard] = None):
    """ray_loss(rb, generator=None, it=0, fine_override=None, eik_pts=None,
    u_out=None, u_fin=None) -> (total, (losses, extras)), per ref
    volsdf.py:572-644: L1 rgb (over `mask_ignore` where given) + eikonal on
    the max-visibility sample and one uniform box point per ray (`eik_pts`
    [..., N_rays, 1, 3] replaces the draw from `generator`; `u_out` the
    NeRF++ radii's jitter and `u_fin` the sampler's uniforms, see
    `volume_render_rays`) + the optional decaying sdf anchor at the origin.
    With a `shard`, `rb` is this rank's block and the losses its shares."""
    shard = shard or RayShard()
    w_eikonal = float(args.training.w_eikonal)
    eik_bounding_box = float(args.model.obj_bounding_radius)
    w_anchor = float(args.training.get("w_sdf_anchor", 0.0))
    anchor_until = max(1, int(args.training.get("sdf_anchor_until", 20000)))
    anchor_target = float(args.training.get("sdf_anchor_target", -1.0))
    render_fn = make_volume_render_fn(
        model, detailed_output=True,
        **{k: v for k, v in render_kwargs_train.items() if k not in ("H", "W")})

    def ray_loss(rb, generator=None, it=0, fine_override=None, eik_pts=None, u_out=None,
                 u_fin=None):
        with span("volsdf.loss"):
            target_rgb = rb["target_rgb"]
            mask_ignore = rb.get("mask_ignore")
            if eik_pts is None:
                eik_pts = (torch.rand(rb["rays_o"].shape[:-1] + (1, 3), generator=generator,
                                      device=target_rgb.device) * 2 - 1) * eik_bounding_box
            rgb, _depth, extras = render_fn(rb["rays_o"], rb["rays_d"], generator,
                                            eik_pts=eik_pts, fine_override=fine_override,
                                            u_out=u_out, u_fin=u_fin)

            nablas = extras["implicit_nablas"]  # [..., N_rays, P, 3]
            # one max-visibility surface point per ray (§3.5 of the paper)
            ind = torch.argmax(extras["visibility_weights"][..., :nablas.shape[-2]], dim=-1)
            nablas_surf = torch.gather(
                nablas, -2, ind[..., None, None].expand(*ind.shape, 1, 3))
            nablas_all = torch.cat([nablas_surf, extras["eik_nablas"]], dim=-2)
            nablas_norm = torch.linalg.norm(nablas_all, dim=-1)

            losses = {}
            loss_img = torch.abs(rgb - target_rgb)
            losses["loss_eikonal"] = w_eikonal * shard.mean((nablas_norm - 1.0) ** 2)
            if mask_ignore is not None:
                mi = mask_ignore.float()
                losses["loss_img"] = shard.masked_mean(torch.sum(loss_img * mi[..., None]),
                                                       torch.sum(mi))
            else:
                losses["loss_img"] = shard.mean(loss_img)
            sdf0 = None
            if w_anchor > 0.0:
                sdf0 = model.forward_surface(torch.zeros(1, 3, device=target_rgb.device))
                wt = w_anchor * max(0.0, 1.0 - it / anchor_until)
                losses["loss_sdf_anchor"] = shard.replicated(
                    wt * torch.mean((sdf0 - anchor_target) ** 2))

            losses["total"] = sum(losses.values())
            extras["implicit_nablas_norm"] = nablas_norm
            alpha, beta = model.forward_ab()
            extras["scalars"] = {"beta": beta.detach(), "alpha": alpha.detach()}
            if sdf0 is not None:
                extras["scalars"]["sdf_origin"] = sdf0[0].detach()
            return losses["total"], (losses, extras)

    return ray_loss


def draw_step_uniforms(render_kwargs_train: dict, eik_bounding_box: float, N: int,
                       generator, device) -> dict:
    """A training step's draws after its pixels, at N rays, in the order the
    loss and the render make them: the eikonal box points (`eik_pts`), the
    sampler's uniforms (`u_fin`), then the NeRF++ radii's jitter (`u_out`,
    with a background under `perturb`)."""
    kw = render_kwargs_train
    draws = {"eik_pts": (torch.rand(N, 1, 3, generator=generator, device=device) * 2 - 1)
             * eik_bounding_box,
             "u_fin": _draw_uniforms(N, kw["max_upsample_steps"] + 2, kw["N_importance"],
                                     kw["perturb"], generator, device)}
    if kw["use_nerfplusplus"] and kw["perturb"]:
        draws["u_out"] = torch.rand(N, kw["N_outside"], generator=generator, device=device)
    return draws


def _draw_step(args, render_kwargs_train: dict, shard: RayShard):
    from neurecon_tpu_torch.training import make_draw_step

    box = float(args.model.obj_bounding_radius)
    return make_draw_step(
        render_kwargs_train["H"], render_kwargs_train["W"], int(args.data.N_rays),
        lambda N, g, dev: draw_step_uniforms(render_kwargs_train, box, N, g, dev), shard)


def make_pipeline_fns(model: VolSDF, args, render_kwargs_train: dict,
                      shard: Optional[RayShard] = None) -> dict:
    """The training step split for the pipelined step, as
    `neus.make_pipeline_fns`: depth_sample(rb, draws) is the §3.4 sampler
    (`compute_ray_samples`: kernel 4 and kernels (a)-(c) on a card) on the
    draws' `u_fin`, and loss_with_samples(rb, fine, draws, generator, it)
    the loss with its (d_fine, beta_map, iter_usage) as `fine_override`, the
    eikonal points and the NeRF++ jitter from the draws."""
    shard = shard or RayShard()
    ray_loss = make_ray_loss_fn(model, args, render_kwargs_train, shard=shard)
    sample_kwargs = {k: v for k, v in render_kwargs_train.items()
                     if k not in ("H", "W", "rayschunk")}

    def depth_sample(rb, draws):
        return compute_ray_samples(model, rb["rays_o"], rb["rays_d"], u_fin=draws["u_fin"],
                                   **sample_kwargs)

    def loss_with_samples(rb, fine, draws, generator, it):
        return ray_loss(rb, generator, it, fine_override=fine, eik_pts=draws["eik_pts"],
                        u_out=draws.get("u_out"))

    return {"draw_step": _draw_step(args, render_kwargs_train, shard),
            "depth_sample": depth_sample, "loss_with_samples": loss_with_samples}


def get_model(args, device=None, seed: int = 0):
    """(model, render_kwargs_train, render_kwargs_test, render_factory) from
    a config, as the JAX package reads it. The model is initialized on the CPU
    from `seed` (geometric init), then moved to `device`."""
    from neurecon_tpu_torch import get_device

    model_config = {
        "use_nerfplusplus": args.model.setdefault("outside_scene", "builtin") == "nerf++",
        "obj_bounding_radius": args.model.obj_bounding_radius,
        "W_geo_feat": args.model.setdefault("W_geometry_feature", 256),
        "speed_factor": args.training.setdefault("speed_factor", 1.0),
        "beta_init": args.training.setdefault("beta_init", 0.1),
    }
    surface_cfg = {
        "use_siren": args.model.surface.setdefault(
            "use_siren", args.model.setdefault("use_siren", False)),
        "embed_multires": args.model.surface.setdefault("embed_multires", 6),
        "radius_init": args.model.surface.setdefault("radius_init", 1.0),
        "geometric_init": args.model.surface.setdefault("geometric_init", True),
        "D": args.model.surface.setdefault("D", 8),
        "W": args.model.surface.setdefault("W", 256),
        "skips": args.model.surface.setdefault("skips", [4]),
        "sphere_residual": args.model.surface.setdefault("sphere_residual", False),
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
    model = VolSDF(surface_cfg=surface_cfg, radiance_cfg=radiance_cfg, **model_config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(get_device(device))

    render_kwargs_train = {
        "near": args.data.near,
        "far": args.data.far,
        "N_samples": args.model.setdefault("N_samples", 128),
        "N_importance": args.model.setdefault("N_importance", 64),
        "N_outside": args.model.setdefault("N_outside", 32),
        "perturb": args.model.setdefault("perturb", True),
        "white_bkgd": args.model.setdefault("white_bkgd", False),
        "max_upsample_steps": args.model.setdefault("max_upsample_iter", 5),
        "max_bisection_steps": args.model.setdefault("max_bisection_steps", 10),
        "epsilon": args.model.setdefault("epsilon", 0.1),
        "fine_sample_mul": args.model.setdefault("fine_sample_mul", 4),
        "use_nerfplusplus": model_config["use_nerfplusplus"],
        "obj_bounding_radius": args.model.obj_bounding_radius,
    }
    render_kwargs_test = copy.deepcopy(render_kwargs_train)
    render_kwargs_test["rayschunk"] = args.data.val_rayschunk
    render_kwargs_test["perturb"] = False

    def render_factory(**kwargs):
        return make_volume_render_fn(model, **kwargs)

    return model, render_kwargs_train, render_kwargs_test, render_factory
