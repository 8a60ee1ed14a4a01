"""NeuS (Wang et al., NeurIPS 2021) as the program's configuration runs it:
the `official_solution` hierarchical upsampler (gradient-free), the one
batched sdf + nablas query over sections and midpoints, the radiance net on
the midpoints, sdf -> alpha -> visibility weights, and the L1 + eikonal +
mask BCE loss. With a mask, no NeRF++ background. The harness's framework
interface (`benchmark.registry.framework`) is at the end."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.sampling import alpha_to_w, sample_pdf


def near_far(rays_o, rays_d, r: float):
    """Conservative near / far [N, 1] from the bounding sphere of radius r."""
    mid = -torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
    return torch.clamp(mid - r, min=0.0), torch.clamp(mid + r, min=r)


@torch.no_grad()
def upsample(nets, rays_o, rays_d, d_coarse, u, n_iters: int, n_per_iter: int):
    """The sorted d_all [N, Bc + n_iters * n_per_iter]: each round sharpens
    s = 64 * 2^i, estimates each section's sdf at its ends from the smaller
    of its own and the previous section's slope, and draws n_per_iter depths
    at its uniforms from the resulting weights."""
    def query(d):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
        return nets.surface(pts.reshape(-1, 3))[0].reshape(d.shape)

    d, sdf = d_coarse, query(d_coarse)
    for i in range(n_iters):
        prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
        prev_z, next_z = d[:, :-1], d[:, 1:]
        mid_sdf = 0.5 * (prev_sdf + next_sdf)
        dot = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
        prev_dot = torch.cat([torch.zeros_like(dot[:, :1]), dot[:, :-1]], dim=-1)
        dot = torch.clamp(torch.minimum(prev_dot, dot), -10.0, 0.0)
        dist = next_z - prev_z
        s = 64 * (2 ** i)
        prev_cdf = torch.sigmoid((mid_sdf - dot * dist * 0.5) * s)
        next_cdf = torch.sigmoid((mid_sdf + dot * dist * 0.5) * s)
        alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
        d_fine = sample_pdf(d, alpha_to_w(alpha), u[:, i * n_per_iter:(i + 1) * n_per_iter])
        d = torch.cat([d, d_fine], dim=-1)
        sdf = torch.cat([sdf, query(d_fine)], dim=-1)
        d, order = torch.sort(d, dim=-1, stable=True)
        sdf = torch.gather(sdf, -1, order)
    return d


def render(nets, params, kw: dict, rays_o, rays_d, u_up, train: bool, follow=None):
    """Flat rays [N, 3] -> dict of per-ray rgb, depth, acc, normals, the
    sections' nablas and the upsampler's depths `samples`. `u_up` [N,
    N_importance]: the upsampler's uniforms, sorted within each round;
    `train` builds the graph of the loss; `follow` (depths [N, P]) renders
    at those depths in place of the upsampler's own."""
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near, far = near_far(rays_o, rays_d, float(kw["obj_bounding_radius"]))
    t = torch.linspace(0, 1, int(kw["N_samples"]), device=rays_o.device)
    d_coarse = near * (1 - t) + far * t
    n_iters = int(kw["N_upsample_iters"])
    samples = upsample(nets, rays_o, rays_d, d_coarse, u_up, n_iters,
                       int(kw["N_importance"]) // n_iters)
    d_all = samples  # a program that sampled other rays is read against these
    if follow is not None and follow.numel() == samples.numel():
        d_all = follow.reshape(samples.shape).to(samples.dtype)

    N, P = d_all.shape
    d_mid = 0.5 * (d_all[:, 1:] + d_all[:, :-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * d_all[..., None]
    pts_mid = rays_o[:, None, :] + rays_d[:, None, :] * d_mid[..., None]
    pts_all = torch.cat([pts, pts_mid], dim=-2)
    sdf_all, nablas_all, h_all = nets.surface_with_nablas(pts_all.reshape(-1, 3), train)
    sdf_all = sdf_all.reshape(N, 2 * P - 1)
    nablas_all = nablas_all.reshape(N, 2 * P - 1, 3)
    h_all = h_all.reshape(N, 2 * P - 1, -1)
    sdf, nablas = sdf_all[:, :P], nablas_all[:, :P]
    s = torch.exp(params["ln_s"][0] * kw["speed_factor"])
    cdf = torch.sigmoid(sdf * s)
    alpha = torch.clamp((cdf[:, :-1] - cdf[:, 1:]) / (cdf[:, :-1] + 1e-10), min=0.0)
    views = rays_d[:, None, :].expand_as(pts_mid)
    rad = nets.radiance(pts_mid.reshape(-1, 3), views.reshape(-1, 3),
                        nablas_all[:, P:].reshape(-1, 3),
                        h_all[:, P:].reshape(N * (P - 1), -1)).reshape(N, P - 1, 3)
    w = alpha_to_w(alpha)
    normals = nablas / (torch.linalg.norm(nablas, dim=-1, keepdim=True) + 1e-10)
    return {"rgb": torch.sum(w[..., None] * rad, dim=-2),
            "depth": torch.sum(w / (torch.sum(w, -1, keepdim=True) + 1e-10) * d_mid, dim=-1),
            "acc": torch.sum(w, dim=-1),
            "normals": torch.sum(normals[:, :P - 1] * w[..., None], dim=-2),
            "nablas": nablas, "samples": samples}


def loss(out, target_rgb, target_mask, train_cfg: dict):
    """L1 over the masked rays + w_eikonal * the eikonal term on the sections
    + w_mask * the BCE of the clamped accumulation."""
    norm = torch.linalg.norm(out["nablas"], dim=-1)
    acc = torch.clamp(out["acc"], 1e-3, 1 - 1e-3)
    tm = target_mask.float()
    eik = float(train_cfg["w_eikonal"]) * torch.mean((norm - 1.0) ** 2)
    bce = -(tm * torch.log(acc) + (1 - tm) * torch.log(1 - acc))
    mask = float(train_cfg["w_mask"]) * torch.mean(bce)
    img = torch.sum(torch.abs(out["rgb"] - target_rgb) * tm[..., None]) / (torch.sum(tm) + 1e-10)
    return eik + mask + img


def render_kwargs(cfg: dict) -> dict:
    """The upsampler's and renderer's settings of a configuration."""
    m, d = cfg["model"], cfg["data"]
    return {"obj_bounding_radius": d.get("obj_bounding_radius", 1.0),
            "N_samples": m["N_samples"], "N_importance": m["N_importance"],
            "N_upsample_iters": m["N_upsample_iters"],
            "speed_factor": float(cfg["training"]["speed_factor"])}


def extra_weights(cfg: dict, gen, device) -> dict:
    """ln_s at its init: s = exp(ln_s * speed_factor) starts at
    1 / variance_init. Draws nothing."""
    init = float(-np.log(cfg["model"]["variance_init"]) / float(cfg["training"]["speed_factor"]))
    return {"ln_s": torch.tensor([init], dtype=torch.float32, device=device)}


def draws(cfg: dict, n: int, gen, device) -> dict:
    """The upsampler's uniforms, sorted within each round."""
    m = cfg["model"]
    k = int(m["N_upsample_iters"])
    u = torch.rand(n, k, int(m["N_importance"]) // k, generator=gen, device=device)
    return {"u_up": torch.sort(u, dim=-1).values.reshape(n, -1)}


def train_loss(nets, params, cfg: dict, rays_o, rays_d, dr: dict, target, mask, step: int,
               follow=None):
    """One step's render at the program's d_all (`follow["samples"]`) and its
    loss; the reference keeps its own upsampler's d_all."""
    out = render(nets, params, render_kwargs(cfg), rays_o, rays_d, dr["u_up"], train=True,
                 follow=None if follow is None else follow["samples"])
    return (loss(out, target, mask, cfg["training"]), out["rgb"],
            {"samples": out["samples"]}, 0)


def render_eval(nets, params, cfg: dict, rays_o, rays_d) -> dict:
    """The novel-view render: each round's uniforms a linspace over [0, 1]."""
    m = cfg["model"]
    k = int(m["N_upsample_iters"])
    u = torch.linspace(0.0, 1.0, int(m["N_importance"]) // k, device=rays_o.device).to(
        rays_o.dtype).repeat(k).expand(rays_o.shape[0], -1).contiguous()
    out = render(nets, params, render_kwargs(cfg), rays_o, rays_d, u, train=False)
    return {k2: out[k2] for k2 in ("rgb", "depth", "normals")}


def recorded(sampled, extras: dict) -> dict:
    """Of a program's step: the upsampler's d_all."""
    return {"samples": sampled}


def shifted(cfg: dict, sampled):
    """d_all moved by half a coarse step: each ray's span over 2 N_samples."""
    d = sampled
    return d + (d.amax(-1, keepdim=True) - d.amin(-1, keepdim=True)) / (
        2 * int(cfg["model"]["N_samples"]))


def points(cfg: dict, n: int, train: bool) -> dict:
    """The upsampler's sdf-only queries at the P = N_samples + N_importance
    sections, sdf + nablas at the sections and their midpoints, the
    radiance net at the midpoints."""
    m = cfg["model"]
    P = int(m["N_samples"]) + int(m["N_importance"])
    return {"upsample": n * P, "sampler": 0, "nablas": n * (2 * P - 1), "radiance": n * (P - 1)}


def sdf_launches(cfg: dict) -> int:
    """None: the upsampler queries inside its own kernel (kernel 2)."""
    return 0


def shrink(m: dict) -> None:
    m.update(N_samples=8, N_importance=8, N_upsample_iters=2)
