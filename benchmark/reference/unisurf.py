"""UNISURF (Oechsle, Peng & Geiger, ICCV 2021, arXiv:2104.10078) as the
program's configuration runs it: an occupancy net whose logits are (+)
outside and (-) inside, a gradient-free root find per ray (a march of
N_steps evenly spaced depths on [near, far] of the sphere of interest, the
first + -> - crossing, 8 secant steps), N_query stratified samples in
[d - Δ, d + Δ] around the root and N_freespace in free space before it,
opacity = sigmoid(-logit) composited as alpha times the shifted product of
max(1 - alpha, 0) + 1e-10, the radiance net on unit normals, and the loss
L1 rgb + w_reg x the mean squared difference of the unit normals at each
surface point and a neighbour jittered by up to ±perturb_surface_pts. Δ
shrinks with the step: max(delta_max exp(-it delta_beta), delta_min), in
float32. The harness's framework interface (`benchmark.registry.framework`)
is at the end.

Where this follows neurecon's code rather than the paper's text: misses
keep `far` as their root (neurecon's `fill_inf` off), a ray whose first
march depth is inside takes depth 0, the free-space samples end at the
interval's start but no nearer than a tenth of [near, far] (the too-close
threshold), and a ray without a crossing, or whose free space would end
before 1e-10, takes its free-space samples over [near, far]. The program's
configuration against UNISURF's own is in `benchmark/configs/unisurf.json`
under `assumed.departs_from_paper`.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.neus import near_far
from benchmark.reference.sampling import alpha_to_w, linspace01

N_SECANT = 8      # the program's secant steps after the march
TOO_CLOSE = 0.1   # free space ends no nearer than this share of [near, far]


def logit_tau(tau: float) -> float:
    """The logit of the surface's opacity tau, (+) outside: -log(tau / (1 -
    tau)), tau clipped to [1e-4, 1 - 1e-4]; 0 at tau 0.5."""
    t = float(np.clip(tau, 1e-4, 1 - 1e-4))
    return float(-np.log(t / (1 - t)))


def interval(train_cfg: dict, step: int) -> float:
    """Δ at training step `step`: max(delta_max exp(-step delta_beta),
    delta_min), in float32 arithmetic."""
    f = np.float32
    return float(max(f(train_cfg["delta_max"]) * np.exp(f(-f(step)) * f(train_cfg["delta_beta"])),
                     f(train_cfg["delta_min"])))


@torch.no_grad()
def root_find(nets, rays_o, rays_d, near, far, n_steps: int, tau_logit: float):
    """Per ray, the first + -> - crossing of logit - tau_logit along [near,
    far] ([N] each): (depth [N], point [N, 3], mask [N], sign_change [N]).
    The march queries n_steps evenly spaced depths; the crossing is the
    argmin of sign(v_i v_{i+1}) (n_steps - i), the first of equal minima;
    the secant then runs N_SECANT steps inside the bracketing interval.
    `mask`: a sign change that goes from + to - on a ray whose first depth
    is outside. Misses keep `far`; a ray whose first depth is inside takes
    0; the point is (1, 1, 1) where `mask` is off."""
    N, dev = rays_o.shape[0], rays_o.device

    def query(d):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
        return nets.surface(pts.reshape(-1, 3))[0].reshape(d.shape) - tau_logit

    t = linspace01(n_steps, dev).to(rays_o.dtype)
    d = near[:, None] * (1 - t) + far[:, None] * t
    val = query(d)
    outside_first = val[:, 0] > 0
    sign = torch.cat([torch.sign(val[:, :-1] * val[:, 1:]), torch.ones_like(val[:, :1])], -1)
    cost = sign * torch.arange(n_steps, 0, -1, device=dev).to(val.dtype)
    ind = torch.argmin(cost, -1)  # the first of equal minima
    sign_change = torch.gather(cost, 1, ind[:, None])[:, 0] < 0
    mask = sign_change & (torch.gather(val, 1, ind[:, None])[:, 0] > 0) & outside_first
    above = torch.clamp(ind + 1, max=n_steps - 1)
    d_hi, f_hi = torch.gather(d, 1, ind[:, None]), torch.gather(val, 1, ind[:, None])
    d_lo, f_lo = torch.gather(d, 1, above[:, None]), torch.gather(val, 1, above[:, None])

    def secant(f_lo, f_hi, d_lo, d_hi):
        den = f_hi - f_lo
        den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        return -f_lo * (d_hi - d_lo) / den + d_lo

    d_pred = secant(f_lo, f_hi, d_lo, d_hi)
    for _ in range(N_SECANT):
        f_mid = query(d_pred)
        low = f_mid < 0
        d_lo, f_lo = torch.where(low, d_pred, d_lo), torch.where(low, f_mid, f_lo)
        d_hi, f_hi = torch.where(low, d_hi, d_pred), torch.where(low, f_hi, f_mid)
        d_pred = secant(f_lo, f_hi, d_lo, d_hi)
    d_pred = d_pred[:, 0]
    point = torch.where(mask[:, None], rays_o + d_pred[:, None] * rays_d,
                        torch.ones_like(rays_o))
    depth = torch.where(mask, d_pred, far)
    return torch.where(outside_first, depth, torch.zeros_like(depth)), point, mask, sign_change


def stratified(lower, upper, n: int, u=None):
    """n depths in each ray's [lower, upper] ([N] each): one in each of n
    equal strata at the uniforms u [N, n], or without u the n evenly spaced
    depths with both ends."""
    if u is None:
        t = linspace01(n, lower.device).to(lower.dtype)
        return lower[:, None] * (1 - t) + upper[:, None] * t
    t = linspace01(n + 1, lower.device).to(lower.dtype)
    edges = lower[:, None] * (1 - t) + upper[:, None] * t
    return edges[:, :-1] + (edges[:, 1:] - edges[:, :-1]) * u


def unit(v):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-10)


def render(nets, cfg: dict, rays_o, rays_d, delta: float, draws: dict, train: bool,
           follow=None):
    """Flat rays [N, 3] -> dict of per-ray rgb, depth, acc, normals, the
    root find's own output (`root`: depth, point, mask, sign_change) and,
    with draws["u_reg"], the unit normals at each ray's surface point and
    its neighbour (`reg_normals` [N, 2, 3]). `draws`: u_interval [N,
    N_query] and u_free [N, N_freespace] (none: evenly spaced samples), and
    u_reg [N, 3] in training. `follow` (the program's root: depth, point,
    mask, sign_change) renders around that root in place of its own."""
    m = cfg["model"]
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near, far = (x[:, 0] for x in near_far(rays_o, rays_d, float(m["obj_bounding_radius"])))
    own = root_find(nets, rays_o, rays_d, near, far, int(m["N_steps"]), logit_tau(m["tau"]))
    root = own  # a program that found other rays' roots is read against these
    if follow is not None and follow[0].numel() == own[0].numel():
        root = tuple(f.reshape(o.shape).to(o.dtype) for f, o in zip(follow, own))
    depth, point, _, sign_change = root

    depth = torch.minimum(torch.maximum(depth, near), far)
    upper = torch.minimum(depth + delta, far)
    lower = torch.maximum(depth - delta, near)
    d_interval = stratified(lower, upper, int(m["N_query"]), draws.get("u_interval"))
    free_end = torch.maximum(lower, near + (far - near) * TOO_CLOSE)
    free_end = torch.where(sign_change, free_end, far)
    free_end = torch.where(free_end < 1e-10, far, free_end)
    d_free = stratified(near, free_end, int(m["N_freespace"]), draws.get("u_free"))
    d_all = torch.sort(torch.cat([d_free, d_interval], -1), -1).values

    N, P = d_all.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * d_all[..., None]
    if "u_reg" in draws:
        neighbour = point + (draws["u_reg"] - 0.5) * 2.0 * float(
            cfg["training"]["perturb_surface_pts"])
        pts = torch.cat([pts, point[:, None, :], neighbour[:, None, :]], dim=1)
    logit, nablas, h = nets.surface_with_nablas(pts.reshape(-1, 3), train)
    K = pts.shape[1]
    logit, nablas = logit.reshape(N, K), nablas.reshape(N, K, 3)
    normals = unit(nablas[:, :P])
    views = rays_d[:, None, :].expand(N, P, 3)
    rad = nets.radiance(pts[:, :P].reshape(-1, 3), views.reshape(-1, 3),
                        normals.reshape(-1, 3),
                        h.reshape(N, K, -1)[:, :P].reshape(N * P, -1)).reshape(N, P, 3)
    w = alpha_to_w(torch.sigmoid(-logit[:, :P]))
    out = {"rgb": torch.sum(w[..., None] * rad, dim=-2),
           "depth": torch.sum(w / (torch.sum(w, -1, keepdim=True) + 1e-10) * d_all, dim=-1),
           "acc": torch.sum(w, dim=-1),
           "normals": torch.sum(normals * w[..., None], dim=-2), "root": own}
    if "u_reg" in draws:
        out["reg_normals"] = unit(nablas[:, P:])
    return out


def loss(out, target_rgb, train_cfg: dict):
    """L1 over all rays + w_reg * the mean squared difference of the unit
    normals at the surface points and their neighbours."""
    reg = out["reg_normals"]
    smooth = float(train_cfg["w_reg"]) * torch.mean((reg[:, 1] - reg[:, 0]) ** 2)
    return torch.mean(torch.abs(out["rgb"] - target_rgb)) + smooth


def _record(root) -> dict:
    """The root find's answer (depth, point, mask, sign_change), and as
    `samples` each ray's segment [0, depth] from its origin to its root (to
    `far` for a miss), so that `samples_p90` / `samples_p99` read each
    root's gap over its depth."""
    depth, point, mask, sign_change = root
    return {"samples": torch.stack([torch.zeros_like(depth), depth], dim=-1), "depth": depth,
            "point": point, "mask": mask, "sign_change": sign_change}


def extra_weights(cfg: dict, gen, device) -> dict:
    """None: UNISURF learns no scalar beside its nets. Draws nothing."""
    return {}


def draws(cfg: dict, n: int, gen, device) -> dict:
    """The interval's uniforms, the free space's, then the neighbours'
    jitter (the program draws all three with perturb on and w_reg > 0, as
    its configuration has them)."""
    m = cfg["model"]
    return {"u_interval": torch.rand(n, int(m["N_query"]), generator=gen, device=device),
            "u_free": torch.rand(n, int(m["N_freespace"]), generator=gen, device=device),
            "u_reg": torch.rand(n, 3, generator=gen, device=device)}


def train_loss(nets, params, cfg: dict, rays_o, rays_d, dr: dict, target, mask, step: int,
               follow=None):
    """One step's render around the program's root (`follow`: its depth,
    point, mask and sign change) at Δ of step `step`, and its loss; the
    reference keeps its own root find's answer."""
    root = None if follow is None else tuple(
        follow[k] for k in ("depth", "point", "mask", "sign_change"))
    out = render(nets, cfg, rays_o, rays_d, interval(cfg["training"], step), dr, True, root)
    return loss(out, target, cfg["training"]), out["rgb"], _record(out["root"]), 0


def render_eval(nets, params, cfg: dict, rays_o, rays_d) -> dict:
    """The novel-view render: evenly spaced samples at the default Δ of 1.0
    that a render without a checkpoint's step takes."""
    out = render(nets, cfg, rays_o, rays_d, 1.0, {}, False)
    return {k: out[k] for k in ("rgb", "depth", "normals")}


def recorded(sampled, extras: dict) -> dict:
    """Of a program's step: its root find's output, `depth_sample`'s (depth,
    point, mask, sign_change), and its depths in the check's form."""
    return _record(sampled)


def shifted(cfg: dict, sampled):
    """The root depths moved by half a march step of a ray through the
    sphere of interest's centre, whose span is the diameter: r / N_steps
    (the output holds no ray, so the point stays)."""
    m = cfg["model"]
    d = sampled[0] + float(m["obj_bounding_radius"]) / int(m["N_steps"])
    return (d, *sampled[1:])


def points(cfg: dict, n: int, train: bool) -> dict:
    """The root find's sdf-only queries (N_steps march depths and the
    secant steps), logits + nablas at the N_query + N_freespace render
    samples (and in training each ray's surface point and its neighbour),
    the radiance net at the render samples."""
    m = cfg["model"]
    P = int(m["N_query"]) + int(m["N_freespace"])
    return {"upsample": 0, "sampler": n * (int(m["N_steps"]) + N_SECANT),
            "nablas": n * (P + (2 if train else 0)), "radiance": n * P}


def sdf_launches(cfg: dict) -> int:
    """Kernel 4 once for the march and once a secant step."""
    return 1 + N_SECANT


def shrink(m: dict) -> None:
    m.update(N_steps=16, N_query=8, N_freespace=4)
