"""NeuS volume rendering (port of `neurecon_tpu/models/frameworks/neus.py`).

The port carries the render and the training loss: the `official_solution`
hierarchical upsampler (CUDA kernel `neus_upsample`, gradient-free), one
batched sdf + nablas + geometry query over sections and midpoints (CUDA
kernel `nablas_forward`, and in training its backward `nablas_backward`
through `ops/fused_nablas_vjp.py`), the radiance net, the sdf -> alpha ->
visibility-weight compositor, the L1 + eikonal (+ mask) losses, and the
model's point queries for the surface renderer and the mesh grids
(`forward_surface_fast`, CUDA kernel `sdf_forward`). Without a mask
(`with_mask: false`) the NeRF++ background (`models/base.py::NeRF`, plain
PyTorch layers, as the JAX package computes it outside any kernel) takes
the midpoints outside the bounding sphere and N_outside samples beyond it,
in the inverted-sphere coordinates (x / r, 1 / r). The other two upsample
algorithms wait for a later slice (ROADMAP Queue A, [A4/A5]).
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

import torch.nn.functional as F

from neurecon_tpu_torch.models.base import ImplicitSurface, RadianceNet, outside_nerf
from neurecon_tpu_torch.ops import fused_upsample, near_far_from_sphere
from neurecon_tpu_torch.ops.sampling import alpha_to_w, linspace01, stratified_jitter


def cdf_Phi_s(x, s):
    return torch.sigmoid(x * s)


def sdf_to_alpha(sdf, s):
    """sdf at section points [..., P] -> (cdf [..., P], alpha [..., P-1])."""
    cdf = cdf_Phi_s(sdf, s)
    opacity_alpha = (cdf[..., :-1] - cdf[..., 1:]) / (cdf[..., :-1] + 1e-10)
    return cdf, torch.clamp(opacity_alpha, min=0.0)


class NeuS(nn.Module):
    def __init__(self,
                 variance_init: float = 0.05,
                 speed_factor: float = 1.0,
                 input_ch: int = 3,
                 W_geo_feat: int = -1,
                 use_outside_nerf: bool = False,
                 obj_bounding_radius: float = 1.0,
                 surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None):
        super().__init__()
        self.speed_factor = speed_factor
        self.ln_s_init = -np.log(variance_init) / speed_factor
        self.ln_s = nn.Parameter(torch.tensor([self.ln_s_init], dtype=torch.float32))
        self.implicit_surface = ImplicitSurface(
            W_geo_feat=W_geo_feat, input_ch=input_ch,
            obj_bounding_size=obj_bounding_radius, **(surface_cfg or {}))
        if W_geo_feat < 0:
            W_geo_feat = self.implicit_surface.W
        self.radiance_net = RadianceNet(W_geo_feat=W_geo_feat, **(radiance_cfg or {}))
        self.nerf_outside = outside_nerf() if use_outside_nerf else None

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.ln_s.fill_(self.ln_s_init)
        self.implicit_surface.reset_parameters(gen)
        self.radiance_net.reset_parameters(gen)
        if self.nerf_outside is not None:
            self.nerf_outside.reset_parameters(gen)

    def forward_s(self):
        return torch.exp(self.ln_s[0] * self.speed_factor)

    def forward_surface(self, x):
        return self.implicit_surface(x)

    def forward_surface_fast(self, x):
        """Gradient-free sdf query (the sdf-only kernel on a card)."""
        return self.implicit_surface.forward_query(x)

    def forward_with_nablas(self, x):
        return self.implicit_surface.forward_with_nablas(x)

    def forward(self, x, view_dirs):
        """(radiance, sdf, nablas) at points x [..., 3]: the surface
        renderer's hit-point query (under no_grad, kernel 1 alone)."""
        sdf, nablas, geo_feat = self.forward_with_nablas(x)
        radiances = self.radiance_net(x, view_dirs, nablas, geo_feat)
        return radiances, sdf, nablas


def _uniforms(N, n_iters, n_per_iter, perturb, generator, device):
    """Per-round uniforms [N, n_iters * n_per_iter], sorted within each round:
    the det linspace (1.0 included), or sorted draws from `generator`."""
    if not perturb:
        u = torch.linspace(0.0, 1.0, n_per_iter, device=device)
        return u.repeat(n_iters).expand(N, -1).contiguous()
    u = torch.rand(N, n_iters, n_per_iter, generator=generator, device=device)
    return torch.sort(u, dim=-1).values.reshape(N, -1)


def neus_upsample(model: NeuS, rays_o, rays_d, d_coarse, *, N_importance: int,
                  N_upsample_iters: int, perturb: bool,
                  generator: Optional[torch.Generator] = None,
                  upsample_algo: str = "official_solution"):
    """Hierarchical up-sampling, gradient-free: returns the sorted d_all."""
    if upsample_algo != "official_solution":
        raise NotImplementedError(
            f"upsample_algo {upsample_algo!r} is not ported yet (ROADMAP "
            "Queue A, [A4/A5]); only official_solution is")
    n_per_iter = N_importance // N_upsample_iters
    u = _uniforms(rays_o.shape[0], N_upsample_iters, n_per_iter, perturb,
                  generator, rays_o.device)
    return fused_upsample.fused_neus_upsample(
        model.implicit_surface, rays_o, rays_d, d_coarse.contiguous(), u,
        n_iters=N_upsample_iters, n_per_iter=n_per_iter)


def _prepare_rays(rays_o, rays_d, obj_bounding_radius,
                  near_bypass=None, far_bypass=None):
    rays_o = rays_o.reshape(-1, 3).float()
    rays_d = rays_d.reshape(-1, 3).float()
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near, far = near_far_from_sphere(rays_o, rays_d, r=obj_bounding_radius)
    if near_bypass is not None:
        near = torch.full_like(near, near_bypass)
    if far_bypass is not None:
        far = torch.full_like(far, far_bypass)
    return rays_o.contiguous(), rays_d.contiguous(), near, far


def volume_render_rays(model: NeuS, rays_o, rays_d,
                       *,
                       generator: Optional[torch.Generator] = None,
                       obj_bounding_radius: float = 1.0,
                       use_view_dirs: bool = True,
                       white_bkgd: bool = False,
                       near_bypass: Optional[float] = None,
                       far_bypass: Optional[float] = None,
                       perturb: bool = False,
                       N_samples: int = 64,
                       N_importance: int = 64,
                       N_outside: int = 0,
                       upsample_algo: str = "official_solution",
                       N_upsample_iters: int = 4,
                       calc_normal: bool = False,
                       detailed_output: bool = True,
                       d_all_override=None,
                       u_out=None,
                       **dummy_kwargs):
    """Render a flat batch of rays [N, 3] -> dict of per-ray outputs;
    rays_d need not be normalized. Differentiable in the model's parameters
    where grad is on (training); the samples d_all never carry a gradient.
    Under no_grad (the render) no graph is built and only the forward
    kernels run. With N_outside > 0 the model's NeRF++ background takes the
    midpoints outside the sphere of `obj_bounding_radius` and N_outside
    samples at far / t beyond `far`, jittered under `perturb` by the
    uniforms `u_out` [N, N_outside] (drawn from `generator` when None)."""
    rays_o, rays_d, near, far = _prepare_rays(
        rays_o, rays_d, obj_bounding_radius, near_bypass, far_bypass)

    if d_all_override is not None:
        d_all = d_all_override.reshape(rays_o.shape[0], -1).float().detach()
    else:
        _t = torch.linspace(0, 1, N_samples, device=rays_o.device)
        d_coarse = near * (1 - _t) + far * _t
        with torch.no_grad():  # the upsampler is gradient-free
            d_all = neus_upsample(
                model, rays_o, rays_d, d_coarse, N_importance=N_importance,
                N_upsample_iters=N_upsample_iters, perturb=perturb,
                generator=generator, upsample_algo=upsample_algo)

    # sdf on sections, radiance on midpoints; one batched query
    pts = rays_o[:, None, :] + rays_d[:, None, :] * d_all[..., None]
    d_mid = 0.5 * (d_all[..., 1:] + d_all[..., :-1])
    pts_mid = rays_o[:, None, :] + rays_d[:, None, :] * d_mid[..., None]
    P = pts.shape[-2]
    pts_all = torch.cat([pts, pts_mid], dim=-2)
    sdf_all, nablas_all, h_all = model.implicit_surface.forward_with_nablas(pts_all)
    sdf, nablas = sdf_all[:, :P], nablas_all[:, :P]
    nablas_mid, h_mid = nablas_all[:, P:], h_all[:, P:]
    cdf, opacity_alpha = sdf_to_alpha(sdf, model.forward_s())
    view_dirs_mid = (rays_d[:, None, :].expand_as(pts_mid)
                     if use_view_dirs else None)
    radiances = model.radiance_net(pts_mid, view_dirs_mid, nablas_mid, h_mid)

    sigma_out = radiance_out = None
    if N_outside > 0:
        t_out = linspace01(N_outside + 2, rays_o.device)[1:-1]
        d_vals_out = far / torch.flip(t_out, dims=[-1])  # [N, N_outside]
        if perturb:
            if u_out is None:
                u_out = torch.rand(d_vals_out.shape, generator=generator, device=rays_o.device)
            d_vals_out = stratified_jitter(d_vals_out, u_out.reshape(d_vals_out.shape))
        d_vals_out = torch.cat([d_mid, d_vals_out], dim=-1)  # sorted
        pts_out = rays_o[:, None, :] + rays_d[:, None, :] * d_vals_out[..., None]
        # the safe norm: a midpoint at the exact origin (a principal ray of a
        # centred camera) would give 0 / 0 here; the where-merge below hides
        # it in the forward but not in the background net's gradients, so
        # the square is clamped before the root (zero gradient at the clamp)
        r = torch.sqrt(torch.clamp(torch.sum(pts_out ** 2, dim=-1, keepdim=True),
                                   min=1e-12))
        x_out = torch.cat([pts_out / r, 1.0 / r], dim=-1)
        views_out = rays_d[:, None, :].expand_as(pts_out) if use_view_dirs else None
        sigma_out, radiance_out = model.nerf_outside(x_out, views_out)
        dists = d_vals_out[..., 1:] - d_vals_out[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
        # softplus, not relu, as in the official NeuS repo
        alpha_out = 1 - torch.exp(-F.softplus(sigma_out) * dists)
        n_mid = d_mid.shape[-1]
        inside = torch.linalg.norm(pts_mid, dim=-1) <= obj_bounding_radius
        opacity_alpha = torch.cat([torch.where(inside, opacity_alpha, alpha_out[:, :n_mid]),
                                   alpha_out[:, n_mid:]], dim=-1)
        radiances = torch.cat([torch.where(inside[..., None], radiances,
                                           radiance_out[:, :n_mid]),
                               radiance_out[:, n_mid:]], dim=-2)
        d_final = d_vals_out
    else:
        d_final = d_mid

    visibility_weights = alpha_to_w(opacity_alpha)
    rgb_map = torch.sum(visibility_weights[..., None] * radiances, dim=-2)
    depth_map = torch.sum(
        visibility_weights
        / (torch.sum(visibility_weights, -1, keepdim=True) + 1e-10) * d_final,
        dim=-1)
    acc_map = torch.sum(visibility_weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    ret = {"rgb": rgb_map, "depth_volume": depth_map, "mask_volume": acc_map}
    if calc_normal:
        normals_map = nablas / (torch.linalg.norm(nablas, dim=-1, keepdim=True)
                                + 1e-10)
        Pn = min(visibility_weights.shape[-1], normals_map.shape[-2])
        ret["normals_volume"] = torch.sum(
            normals_map[:, :Pn] * visibility_weights[:, :Pn, None], dim=-2)
    if detailed_output:
        ret.update({"implicit_nablas": nablas, "implicit_surface": sdf,
                    "radiance": radiances, "alpha": opacity_alpha,
                    "cdf": cdf, "visibility_weights": visibility_weights,
                    "d_final": d_final, "d_all": d_all})
        if N_outside > 0:
            ret.update({"sigma_out": sigma_out, "radiance_out": radiance_out})
    return ret


def make_volume_render_fn(model: NeuS, **render_kwargs):
    """(rays_o, rays_d, generator=None, d_all=None, u_out=None) -> (rgb,
    depth, extras), leading batch dims preserved; static render options
    bound here."""
    for k in ("H", "W", "rayschunk", "netchunk", "batched"):
        render_kwargs.pop(k, None)

    def render(rays_o, rays_d, generator=None, d_all=None, u_out=None):
        prefix = rays_o.shape[:-1]
        ret = volume_render_rays(model, rays_o, rays_d, generator=generator,
                                 d_all_override=d_all, u_out=u_out, **render_kwargs)
        ret = {k: v.reshape(prefix + v.shape[1:]) for k, v in ret.items()}
        return ret["rgb"], ret["depth_volume"], ret

    return render


def compute_losses(model: NeuS, rays_o, rays_d, target_rgb, *, render_fn,
                   w_eikonal: float, with_mask: bool, w_mask: float = 0.0,
                   target_mask=None, mask_ignore=None, generator=None,
                   d_all=None, u_out=None):
    """NeuS training losses: L1 rgb + eikonal on the section points + the
    mask BCE on the clamped accumulation map (with a mask). Returns (total,
    (losses, extras))."""
    rgb, _depth, extras = render_fn(rays_o, rays_d, generator, d_all=d_all, u_out=u_out)

    nablas = extras["implicit_nablas"]
    nablas_norm = torch.linalg.norm(nablas, dim=-1)
    # clamp against the exploding BCE gradient where pred ~ 1 but GT = 0
    mask_volume = torch.clamp(extras["mask_volume"], 1e-3, 1 - 1e-3)
    extras["mask_volume_clipped"] = mask_volume

    losses = {}
    loss_img = torch.abs(rgb - target_rgb)
    losses["loss_eikonal"] = w_eikonal * torch.mean((nablas_norm - 1.0) ** 2)
    if with_mask:
        tm = target_mask.float()
        bce = -(tm * torch.log(mask_volume) + (1 - tm) * torch.log(1 - mask_volume))
        losses["loss_mask"] = w_mask * torch.mean(bce)
        if mask_ignore is not None:
            tm = (target_mask.bool() & mask_ignore.bool()).float()
        losses["loss_img"] = torch.sum(loss_img * tm[..., None]) / (torch.sum(tm) + 1e-10)
    elif mask_ignore is not None:
        mi = mask_ignore.float()
        losses["loss_img"] = torch.sum(loss_img * mi[..., None]) / (torch.sum(mi) + 1e-10)
    else:
        losses["loss_img"] = torch.mean(loss_img)

    losses["total"] = sum(losses.values())
    extras["implicit_nablas_norm"] = nablas_norm
    extras["scalars"] = {"1/s": 1.0 / model.forward_s().detach()}
    return losses["total"], (losses, extras)


def make_ray_loss_fn(model: NeuS, args, render_kwargs_train: dict):
    """ray_loss(rb, generator=None, it=0, d_all=None, u_out=None) -> (total,
    (losses, extras)) on a ray batch from `training.sample_ray_batch`
    (`u_out`: the outside samples' jitter uniforms, see
    `volume_render_rays`)."""
    with_mask = bool(args.training.with_mask)
    w_mask = float(args.training.setdefault("w_mask", 0.0))
    w_eikonal = float(args.training.w_eikonal)
    render_fn = make_volume_render_fn(
        model, detailed_output=True, **{k: v for k, v in render_kwargs_train.items()
                                        if k not in ("H", "W")})

    def ray_loss(rb, generator=None, it=0, d_all=None, u_out=None):
        return compute_losses(
            model, rb["rays_o"], rb["rays_d"], rb["target_rgb"],
            render_fn=render_fn, w_eikonal=w_eikonal, with_mask=with_mask,
            w_mask=w_mask, target_mask=rb.get("target_mask"),
            mask_ignore=rb.get("mask_ignore"), generator=generator, d_all=d_all,
            u_out=u_out)

    return ray_loss


def make_trainer(model: NeuS, args, render_kwargs_train: dict):
    """loss_fn(batch, generator, it) -> (total, (losses, extras)); batch is
    one image {'c2w' [1,4,4], 'intrinsics' [1,4,4], 'rgb' [1,H*W,3],
    'object_mask' [1,H*W], ...} on the device, and N_rays pixels of it are
    drawn from `generator`."""
    from neurecon_tpu_torch.training import sample_ray_batch

    H, W = render_kwargs_train["H"], render_kwargs_train["W"]
    N_rays = int(args.data.N_rays)
    ray_loss = make_ray_loss_fn(model, args, render_kwargs_train)

    def loss_fn(batch, generator, it):
        rb = sample_ray_batch(generator, batch, H, W, N_rays)
        return ray_loss(rb, generator, it)

    return loss_fn


def get_model(args, device=None, seed: int = 0):
    """(model, render_kwargs_train, render_kwargs_test, render_factory) from
    a config. The model is initialized on the CPU from `seed` (geometric
    init), then moved to `device`."""
    from neurecon_tpu_torch import get_device

    if not args.training.with_mask:
        if not ("N_outside" in args.model and args.model.N_outside > 0):
            raise ValueError("Please specify a positive model:N_outside for neus with nerf++")
    model_config = {
        "obj_bounding_radius": args.model.obj_bounding_radius,
        "W_geo_feat": args.model.setdefault("W_geometry_feature", 256),
        "use_outside_nerf": not args.training.with_mask,
        "speed_factor": args.training.setdefault("speed_factor", 1.0),
        "variance_init": args.model.setdefault("variance_init", 0.05),
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
    model = NeuS(surface_cfg=surface_cfg, radiance_cfg=radiance_cfg, **model_config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(get_device(device))

    render_kwargs_train = {
        "upsample_algo": args.model.setdefault("upsample_algo", "official_solution"),
        "N_upsample_iters": args.model.setdefault("N_upsample_iters", 4),
        "N_samples": args.model.setdefault("N_samples", 64),
        "N_importance": args.model.setdefault("N_importance", 64),
        "N_outside": args.model.setdefault("N_outside", 0),
        "obj_bounding_radius": args.data.setdefault("obj_bounding_radius", 1.0),
        "perturb": args.model.setdefault("perturb", True),
        "white_bkgd": args.model.setdefault("white_bkgd", False),
    }
    render_kwargs_test = copy.deepcopy(render_kwargs_train)
    render_kwargs_test["rayschunk"] = args.data.val_rayschunk
    render_kwargs_test["perturb"] = False

    def render_factory(**kwargs):
        return make_volume_render_fn(model, **kwargs)

    return model, render_kwargs_train, render_kwargs_test, render_factory
