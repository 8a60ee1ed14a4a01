"""The reference's training steps and renders: the ray batch and the draws
of a step replayed from the generator state it started at, the loss and
its gradients by autograd, Adam, and the learning-rate schedules."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import neus, volsdf
from benchmark.reference.nets import Nets, spec
from benchmark.reference.sampling import linspace01


def pixel_rays(i, j, c2w, intrinsics):
    """Rays through pixel coordinates i (x), j (y) [N] of one camera:
    (origins, unnormalized directions) [N, 3]."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy, sk = intrinsics[0, 2], intrinsics[1, 2], intrinsics[0, 1]
    x = (i - cx + cy * sk / fy - sk * j / fy) / fx
    y = (j - cy) / fy
    world = (c2w[None, :3, 0] * x[:, None] + c2w[None, :3, 1] * y[:, None]
             + c2w[None, :3, 2] + c2w[None, :3, 3])
    o = c2w[None, :3, 3].expand_as(world)
    return o, world - o


def lr_factor(train_cfg: dict, step: int) -> float:
    """The schedule's factor at `step`, in float32 arithmetic."""
    f32 = np.float32
    sch = train_cfg["scheduler"]
    total = int(train_cfg["num_iters"])
    if sch["type"] == "warmupcosine":
        warm, lo = int(sch["warmup_steps"]), float(sch.get("min_factor", 0.1))
        if step < warm:
            return float(f32(step) / f32(warm))
        c = f32(np.cos(f32(np.pi) * (f32(step) - f32(warm)) / f32(total - warm)))
        return float((c + f32(1.0)) * f32(0.5) * f32(1 - lo) + f32(lo))
    if sch["type"] == "exponential_step":
        t = np.clip(f32(step) / f32(total), f32(0), f32(1))
        return float(np.exp(t * np.log(f32(sch.get("min_factor", 0.1)))))
    raise NotImplementedError(sch["type"])


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected),
    in torch.optim.Adam's order of operations, so that a step a few ulps of
    the parameters long (the warm-up's first steps) rounds as it does
    there."""

    def __init__(self, params: dict):
        self.p = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].lerp_(g, 1 - 0.9)
            self.v[k].mul_(0.999).addcmul_(g, g, value=1 - 0.999)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(1e-8)
            p.addcdiv_(self.m[k], denom, value=-(lr / c1))


def draws(cfg: dict, n: int, H: int, W: int, gen, device) -> dict:
    """A training step's draws in the order the program's step makes them:
    the pixels' rows then columns, then NeuS's sorted upsampler uniforms, or
    VolSDF's eikonal box points then its sampler's uniforms."""
    m = cfg["model"]
    out = {"hs": torch.randint(0, H, (n,), generator=gen, device=device),
           "ws": torch.randint(0, W, (n,), generator=gen, device=device)}
    if m["framework"] == "NeuS":
        k = int(m["N_upsample_iters"])
        u = torch.rand(n, k, int(m["N_importance"]) // k, generator=gen, device=device)
        out["u_up"] = torch.sort(u, dim=-1).values.reshape(n, -1)
    else:
        box = float(m["obj_bounding_radius"])
        out["eik_pts"] = (torch.rand(n, 1, 3, generator=gen, device=device) * 2 - 1) * box
        out["u_fin"] = torch.rand(n, (int(m["max_upsample_iter"]) + 2) * int(m["N_importance"]),
                                  generator=gen, device=device)
    return out


def render_kwargs(cfg: dict) -> dict:
    """The sampler's and renderer's settings of a configuration."""
    m, d = cfg["model"], cfg["data"]
    if m["framework"] == "NeuS":
        return {"obj_bounding_radius": d.get("obj_bounding_radius", 1.0),
                "N_samples": m["N_samples"], "N_importance": m["N_importance"],
                "N_upsample_iters": m["N_upsample_iters"]}
    return {"near": d["near"], "far": d["far"], "N_samples": m["N_samples"],
            "N_importance": m["N_importance"], "fine_sample_mul": m["fine_sample_mul"],
            "epsilon": m["epsilon"], "max_upsample_steps": m["max_upsample_iter"],
            "max_bisection_steps": m["max_bisection_steps"],
            "obj_bounding_radius": m["obj_bounding_radius"]}


def train_steps(cfg: dict, weights: dict, scene: dict, steps: list, tf32: bool = False,
                dtype=torch.float32, follow=None) -> dict:
    """Follow the program's first training steps. `steps`: per step, the
    image index and the generator state it started at. Returns each step's
    loss, its sampler's own depths (`samples`) and its rays' rendered rgb,
    the first step's gradients and the parameters after the last, on the
    weights' device. `follow`: per step, depths to render at in place of the
    sampler's own (the program's, whose sampler is compared by itself).
    `dtype` float64 computes every step in double precision (a witness, not
    the check)."""
    params = {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in weights.items()}
    nets = Nets(spec(cfg), params, tf32=tf32)
    kw = render_kwargs(cfg)
    opt = Adam(params)
    H, W = scene["H"], scene["W"]
    dev = next(iter(weights.values())).device
    base_lr = float(cfg["training"]["lr"])
    n = int(cfg["data"]["N_rays"])
    losses, first_grads, samples, rgbs = [], None, [], []
    for k, (idx, state) in enumerate(steps):
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        dr = {k: v if k in ("hs", "ws") else v.to(dtype)
              for k, v in draws(cfg, n, H, W, gen, dev).items()}
        sel = dr["hs"] * W + dr["ws"]
        o, d = pixel_rays(dr["ws"].to(dtype), dr["hs"].to(dtype), scene["c2w"][idx].to(dtype),
                          scene["intrinsics"][idx].to(dtype))
        target = scene["rgb"][idx][sel].to(dtype)
        at = None if follow is None else follow[k]
        if cfg["model"]["framework"] == "NeuS":
            out = neus.render(nets, params, kw, o, d, dr["u_up"], train=True, follow=at)
            total = neus.loss(out, target, scene["object_mask"][idx][sel], cfg["training"])
        else:
            out = volsdf.render(nets, params, kw, o, d, dr["u_fin"], dr["eik_pts"], train=True,
                                follow=at)
            total = volsdf.loss(out, target, cfg["training"])
        samples.append(out["samples"].detach())
        rgbs.append(out["rgb"].detach())
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names])))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(total.detach()))
        del out, total
        opt.step(grads, base_lr * lr_factor(cfg["training"], k))
    return {"losses": losses, "grads": first_grads, "samples": samples, "rgb": rgbs,
            "params": {k: v.detach().clone() for k, v in params.items()}}


@torch.no_grad()
def render_rays(cfg: dict, weights: dict, rays_o, rays_d, block: int = 1024,
                tf32: bool = False, dtype=torch.float32) -> dict:
    """The novel-view render (no perturbation) of flat rays, in blocks:
    rgb, depth, normals [N, ...]; `dtype` as for `train_steps`."""
    weights = {k: v.to(dtype) for k, v in weights.items()}
    rays_o, rays_d = rays_o.to(dtype), rays_d.to(dtype)
    nets = Nets(spec(cfg), weights, tf32=tf32)
    kw = render_kwargs(cfg)
    m = cfg["model"]
    outs = []
    for a in range(0, rays_o.shape[0], block):
        o, d = rays_o[a:a + block], rays_d[a:a + block]
        n = o.shape[0]
        if m["framework"] == "NeuS":
            k = int(m["N_upsample_iters"])
            u = torch.linspace(0.0, 1.0, int(m["N_importance"]) // k,
                               device=o.device).to(dtype).repeat(k).expand(n, -1).contiguous()
            out = neus.render(nets, weights, kw, o, d, u, train=False)
        else:
            k = int(m["max_upsample_iter"]) + 2
            u = linspace01(int(m["N_importance"]), o.device).to(dtype).repeat(k).expand(
                n, -1).contiguous()
            out = volsdf.render(nets, weights, kw, o, d, u, None, train=False)
        outs.append({k2: out[k2] for k2 in ("rgb", "depth", "normals")})
    return {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "depth", "normals")}
