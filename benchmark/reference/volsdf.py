"""VolSDF (Yariv et al., NeurIPS 2021) as the program's configuration runs
it: the §3.4 error-bounded fine sampler (gradient-free, a fixed number of
rounds), the batched sdf + nablas + radiance query over the coarse and fine
samples and one eikonal point a ray, the builtin background sphere (sdf min
R - |x|), the p_i / tau_i compositor, and the L1 + eikonal loss. The
harness's framework interface (`benchmark.registry.framework`) is at the
end."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.sampling import linspace01, sample_cdf, sample_pdf


def sdf_to_sigma(sdf, alpha, beta):
    """alpha times the Laplace CDF of -sdf with scale beta (§3.1)."""
    e = 0.5 * torch.exp(-torch.abs(sdf) / beta)
    return alpha * torch.where(sdf >= 0, e, 1 - e)


def _r_t(d, sdf, alpha, beta):
    sigma = sdf_to_sigma(sdf, alpha, beta)
    delta = d[..., 1:] - d[..., :-1]
    return torch.cat([torch.zeros_like(sdf[..., :1]),
                      torch.cumsum(sigma[..., :-1] * delta, dim=-1)], dim=-1)[..., :-1]


def error_bound(d, sdf, alpha, beta):
    """§3.3's bound on the opacity error per interval; NaN becomes +inf."""
    sdf_abs = torch.abs(sdf)
    delta = d[..., 1:] - d[..., :-1]
    d_star = torch.clamp(0.5 * (sdf_abs[..., :-1] + sdf_abs[..., 1:] - delta), min=0.0)
    errors = alpha / (4 * beta) * (delta ** 2) * torch.exp(-d_star / beta)
    bounds = torch.exp(-_r_t(d, sdf, alpha, beta)) * (torch.exp(torch.cumsum(errors, -1)) - 1.0)
    return torch.where(torch.isnan(bounds), torch.full_like(bounds, float("inf")), bounds)


def _invert_opacity(d, sdf, alpha, beta, u):
    return sample_cdf(d, 1.0 - torch.exp(-_r_t(d, sdf, alpha, beta)), u)


@torch.no_grad()
def fine_sample(nets, rays_o, rays_d, d_init, far, alpha_net, beta_net, u_fin, *, eps: float,
                max_iter: int, max_bisection: int, n_final: int, n_up: int, bg_r: float):
    """(fine depths [N, n_final], beta [N], rounds used [N]) of the sampler:
    beta+ from eq. 10, then `max_iter` rounds of n_up depths drawn from the
    bounds, a convergence check under the net's beta, a bisection of beta
    and the draw of the rays that converged; rays that never do draw at the
    last beta. u_fin [N, (max_iter + 2) n_final]: checkpoint 0,
    checkpoints 1..max_iter, then the fallback draw."""
    N = d_init.shape[0]

    def query(d):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
        sdf = nets.surface(pts.reshape(-1, 3))[0].reshape(d.shape)
        return torch.minimum(sdf, bg_r - torch.linalg.norm(pts, dim=-1))

    def u_at(i):
        return u_fin[:, i * n_final:(i + 1) * n_final]

    def bound_max(d, sdf, a, b):
        return error_bound(d, sdf, a, b).amax(dim=-1)

    d = d_init
    sdf = query(d)
    denom = float(np.float32(4 * (d.shape[-1] - 1) * np.log(1 + eps)))
    beta = torch.sqrt(far.reshape(N, 1) ** 2 / torch.tensor(denom, device=d.device))
    bad = bound_max(d, sdf, alpha_net, beta_net) > eps
    bounds = torch.clamp(error_bound(d, sdf, 1.0 / beta, beta), 0.0, 1e5)
    converged = ~bad
    usage = torch.where(bad, -1, 0).int()
    fine = _invert_opacity(d, sdf, alpha_net, beta_net, u_at(0))
    for it in range(1, max_iter + 1):
        u = linspace01(n_up + 2, d.device).expand(N, -1)
        up = sample_pdf(d, bounds, u)[:, 1:-1].contiguous()
        d, order = torch.sort(torch.cat([d, up], dim=-1), dim=-1, stable=True)
        sdf = torch.gather(torch.cat([sdf, query(up)], dim=-1), -1, order)
        mask = ~converged
        still_bad = bound_max(d, sdf, alpha_net, beta_net) > eps
        newly = mask & ~still_bad
        fine = torch.where(newly[:, None], _invert_opacity(d, sdf, alpha_net, beta_net,
                                                           u_at(it)), fine)
        usage = torch.where(newly, it, usage).int()
        converged = converged | newly
        mask = mask & still_bad
        right, left = beta, torch.full_like(beta, float(beta_net))
        for _ in range(max_bisection):
            mid = 0.5 * (left + right)
            good = bound_max(d, sdf, 1.0 / mid, mid)[:, None] <= eps
            right = torch.where(good, mid, right)
            left = torch.where(good, left, mid)
        beta = torch.where(mask[:, None], right, beta)
        if it < max_iter:
            bounds = torch.clamp(error_bound(d, sdf, 1.0 / beta, beta), 0.0, 1e5)
    last = _invert_opacity(d, sdf, 1.0 / beta, beta, u_at(max_iter + 1))
    fine = torch.where(converged[:, None], fine, last)
    beta_out = torch.where(converged, torch.full_like(beta[:, 0], float(beta_net)), beta[:, 0])
    return fine, beta_out, torch.where(converged, usage, -1).int()


def render(nets, params, kw: dict, rays_o, rays_d, u_fin, eik_pts, train: bool, follow=None):
    """Flat rays [N, 3] -> dict of per-ray rgb, depth, acc, normals, the
    samples' nablas and visibility weights, the eikonal points' nablas
    (`eik_pts` [N, K, 3] or None) and the sampler's fine depths `samples`;
    `follow` (fine depths [N, N_importance]) renders at those depths in place
    of the sampler's own."""
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    N, dev = rays_o.shape[0], rays_o.device
    nears = torch.full((N, 1), float(kw["near"]), device=dev, dtype=rays_o.dtype)
    fars = torch.full((N, 1), float(kw["far"]), device=dev, dtype=rays_o.dtype)
    beta = torch.exp(params["ln_beta"][0] * kw["speed_factor"])
    alpha = 1.0 / beta
    n0 = int(kw["N_samples"]) * int(kw["fine_sample_mul"])
    t_init = linspace01(n0, dev)
    samples, _, _ = fine_sample(
        nets, rays_o, rays_d, nears * (1 - t_init) + fars * t_init, fars, alpha.detach(),
        beta.detach(), u_fin, eps=float(kw["epsilon"]), max_iter=int(kw["max_upsample_steps"]),
        max_bisection=int(kw["max_bisection_steps"]), n_final=int(kw["N_importance"]),
        n_up=n0, bg_r=float(kw["obj_bounding_radius"]))
    d_fine = samples  # a program that sampled other rays is read against these
    if follow is not None and follow.numel() == samples.numel():
        d_fine = follow.reshape(samples.shape).to(samples.dtype)
    t = linspace01(int(kw["N_samples"]), dev)
    d_all = torch.sort(torch.cat([nears * (1 - t) + fars * t, d_fine], dim=-1), dim=-1).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * d_all[..., None]
    P = pts.shape[1]
    if eik_pts is not None:
        pts = torch.cat([pts, eik_pts.reshape(N, -1, 3)], dim=-2)
    K = pts.shape[1]
    sdf, nablas, h = nets.surface_with_nablas(pts.reshape(-1, 3), train)
    sdf, nablas = sdf.reshape(N, K), nablas.reshape(N, K, 3)
    d_bg = float(kw["obj_bounding_radius"]) - torch.linalg.norm(pts, dim=-1)
    sdf = torch.where(d_bg < sdf, d_bg, sdf)
    views = rays_d[:, None, :].expand(N, P, 3)
    rad = nets.radiance(pts[:, :P].reshape(-1, 3), views.reshape(-1, 3),
                        nablas[:, :P].reshape(-1, 3),
                        h.reshape(N, K, -1)[:, :P].reshape(N * P, -1)).reshape(N, P, 3)
    sigma = sdf_to_sigma(sdf[:, :P], alpha, beta)
    delta = d_all[:, 1:] - d_all[:, :-1]
    p = torch.exp(-torch.clamp(sigma[:, :-1] * delta, min=0.0))
    tau = (torch.clamp(1 - p, min=0.0) + 1e-10) * torch.cumprod(
        torch.cat([torch.ones_like(p[:, :1]), p], dim=-1), dim=-1)[:, :-1]
    normals = nablas[:, :P] / (torch.linalg.norm(nablas[:, :P], dim=-1, keepdim=True) + 1e-10)
    out = {"rgb": torch.sum(tau[..., None] * rad[:, :-1], dim=-2),
           "depth": torch.sum(tau / (torch.sum(tau, -1, keepdim=True) + 1e-10) * d_all[:, :-1],
                              dim=-1),
           "acc": torch.sum(tau, dim=-1),
           "normals": torch.sum(normals[:, :P - 1] * tau[..., None], dim=-2),
           "nablas": nablas[:, :P], "tau": tau, "samples": samples}
    if eik_pts is not None:
        out["eik_nablas"] = nablas[:, P:]
    return out


TIE = 1e-4  # a ray's weights this close (relative) to its maximum tie with it


def eikonal_index(tau, program=None):
    """(each ray's eikonal sample [N], how many rays took the program's): the
    argmax of the ray's visibility weights tau [N, P], or the program's
    index (`program` [N]) where the reference's own weight there lies
    within a relative TIE of its own maximum: a near-tie that the
    rounding of float32 may settle either way. Elsewhere the reference
    keeps its own argmax, so a program that takes another sample fails."""
    tau = tau.detach()
    own = torch.argmax(tau, dim=-1)
    if program is None or program.numel() != own.numel():
        return own, 0
    program = program.reshape(own.shape).to(own.device)
    top = torch.gather(tau, 1, own[:, None])[:, 0]
    at = torch.gather(tau, 1, program[:, None])[:, 0]
    take = (top - at <= TIE * top) & (program != own)
    return torch.where(take, program, own), int(take.sum())


def loss(out, target_rgb, train_cfg: dict, program_index=None):
    """(L1 over all rays + w_eikonal * the eikonal term on each ray's
    max-visibility sample (`eikonal_index`, against the program's
    `program_index`) and its eikonal point, how many rays took the
    program's sample at a near-tie)."""
    nablas = out["nablas"]
    ind, ties = eikonal_index(out["tau"][:, :nablas.shape[1]], program_index)
    surf = torch.gather(nablas, 1, ind[:, None, None].expand(-1, 1, 3))
    norm = torch.linalg.norm(torch.cat([surf, out["eik_nablas"]], dim=1), dim=-1)
    eik = float(train_cfg["w_eikonal"]) * torch.mean((norm - 1.0) ** 2)
    return eik + torch.mean(torch.abs(out["rgb"] - target_rgb)), ties


def render_kwargs(cfg: dict) -> dict:
    """The sampler's and renderer's settings of a configuration."""
    m, d = cfg["model"], cfg["data"]
    return {"near": d["near"], "far": d["far"], "N_samples": m["N_samples"],
            "N_importance": m["N_importance"], "fine_sample_mul": m["fine_sample_mul"],
            "epsilon": m["epsilon"], "max_upsample_steps": m["max_upsample_iter"],
            "max_bisection_steps": m["max_bisection_steps"],
            "obj_bounding_radius": m["obj_bounding_radius"],
            "speed_factor": float(cfg["training"]["speed_factor"])}


def extra_weights(cfg: dict, gen, device) -> dict:
    """ln_beta at its init: beta = exp(ln_beta * speed_factor) starts at
    beta_init. Draws nothing."""
    t = cfg["training"]
    init = float(np.log(t["beta_init"]) / float(t["speed_factor"]))
    return {"ln_beta": torch.tensor([init], dtype=torch.float32, device=device)}


def draws(cfg: dict, n: int, gen, device) -> dict:
    """The eikonal box points, then the sampler's uniforms."""
    m = cfg["model"]
    box = float(m["obj_bounding_radius"])
    eik_pts = (torch.rand(n, 1, 3, generator=gen, device=device) * 2 - 1) * box
    u_fin = torch.rand(n, (int(m["max_upsample_iter"]) + 2) * int(m["N_importance"]),
                       generator=gen, device=device)
    return {"eik_pts": eik_pts, "u_fin": u_fin}


def train_loss(nets, params, cfg: dict, rays_o, rays_d, dr: dict, target, mask, step: int,
               follow=None):
    """One step's render at the program's fine depths (`follow["samples"]`)
    and its loss, with the program's eikonal samples at near-ties
    (`follow["eik_ind"]`); the reference keeps its own sampler's depths and
    its own argmax."""
    out = render(nets, params, render_kwargs(cfg), rays_o, rays_d, dr["u_fin"], dr["eik_pts"],
                 train=True, follow=None if follow is None else follow["samples"])
    total, ties = loss(out, target, cfg["training"],
                       None if follow is None else follow["eik_ind"])
    own, _ = eikonal_index(out["tau"][:, :out["nablas"].shape[1]])
    return total, out["rgb"], {"samples": out["samples"], "eik_ind": own}, ties


def render_eval(nets, params, cfg: dict, rays_o, rays_d) -> dict:
    """The novel-view render: each draw's uniforms a linspace over [0, 1]."""
    m = cfg["model"]
    k = int(m["max_upsample_iter"]) + 2
    u = linspace01(int(m["N_importance"]), rays_o.device).to(rays_o.dtype).repeat(k).expand(
        rays_o.shape[0], -1).contiguous()
    out = render(nets, params, render_kwargs(cfg), rays_o, rays_d, u, None, train=False)
    return {k2: out[k2] for k2 in ("rgb", "depth", "normals")}


def recorded(sampled, extras: dict) -> dict:
    """Of a program's step: the sampler's fine depths (the first of its
    (d_fine, beta_map, iter_usage)) and each ray's eikonal sample, the
    argmax of its visibility weights as the program's loss takes it."""
    tau = extras["visibility_weights"][..., :extras["implicit_nablas"].shape[-2]]
    return {"samples": sampled[0], "eik_ind": torch.argmax(tau, dim=-1).reshape(-1)}


def shifted(cfg: dict, sampled):
    """The fine depths moved by half a coarse step: each ray's span over
    2 N_samples."""
    d = sampled[0]
    d = d + (d.amax(-1, keepdim=True) - d.amin(-1, keepdim=True)) / (
        2 * int(cfg["model"]["N_samples"]))
    return (d, *sampled[1:])


def points(cfg: dict, n: int, train: bool) -> dict:
    """The sampler's sdf-only queries (the n0 = N_samples * fine_sample_mul
    initial depths and n0 new ones in each of max_upsample_iter rounds),
    sdf + nablas at the N_samples + N_importance samples (and in training
    one eikonal point a ray), the radiance net at the samples."""
    m = cfg["model"]
    n0 = int(m["N_samples"]) * int(m["fine_sample_mul"])
    P = int(m["N_samples"]) + int(m["N_importance"])
    return {"upsample": 0, "sampler": n * n0 * (1 + int(m["max_upsample_iter"])),
            "nablas": n * (P + (1 if train else 0)), "radiance": n * P}


def sdf_launches(cfg: dict) -> int:
    """Kernel 4 once for the initial depths and once a round."""
    return 1 + int(cfg["model"]["max_upsample_iter"])


def shrink(m: dict) -> None:
    m.update(N_samples=16, N_importance=8, fine_sample_mul=2, max_upsample_iter=2)
