"""The reference's training steps and renders: the ray batch and the draws
of a step replayed from the generator state it started at, the loss and
its gradients by autograd, Adam, and the learning-rate schedules. What
differs between frameworks comes from the framework's module
(`benchmark.registry.framework`)."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.nets import Nets, spec
from benchmark.registry import framework


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
    if sch["type"] == "multistep":
        passed = int(np.sum(step >= np.asarray(sorted(sch["milestones"]))))
        return float(f32(sch["gamma"]) ** passed)
    raise NotImplementedError(sch["type"])


ADAM_EPS = 1e-8  # torch.optim.Adam's, as the program's optimizer runs it


def round_off(grads: dict) -> dict:
    """Per leaf, the components whose first gradient is under 10 Adam eps:
    Adam's first step there is lr g / (|g| + eps), not lr times g's sign,
    so the gradient's rounding (~1e-8 between two sound float32 runs) moves
    it by up to 2 lr."""
    return {k: g.abs() < 10 * ADAM_EPS for k, g in grads.items()}


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
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(ADAM_EPS)
            p.addcdiv_(self.m[k], denom, value=-(lr / c1))


def draws(cfg: dict, n: int, H: int, W: int, gen, device) -> dict:
    """A training step's draws in the order the program's step makes them:
    the pixels' rows then columns, then the framework's own."""
    out = {"hs": torch.randint(0, H, (n,), generator=gen, device=device),
           "ws": torch.randint(0, W, (n,), generator=gen, device=device)}
    out.update(framework(cfg).draws(cfg, n, gen, device))
    return out


def train_steps(cfg: dict, weights: dict, scene: dict, steps: list, tf32: bool = False,
                dtype=torch.float32, follow=None) -> dict:
    """Follow the program's first training steps. `steps`: per step, the
    image index and the generator state it started at. Returns each step's
    loss, its sampler's own depths (`samples`), its rays' rendered rgb and
    what the program's recorder keeps of it, as the reference computes it
    (`follow`: the parameters the step started from and the framework's
    `recorded`), the rays at which a near-tie was settled the program's way
    (`ties`), how many parameter values it took from the program
    (`adopted`, summed over the steps), the first step's gradients and the
    parameters' change over the steps, on the weights' device.

    `follow`: per step, the program's record. Its sampler's depths are
    rendered at in place of the reference's own (the sampler is compared
    by itself), and every step after the first takes the program's values
    of the components that Adam moved by round-off alone (`round_off` of
    the first gradients): there the two sides part by up to 2 lr, which
    would move the next step's sampler by more than any limit. Elsewhere
    the reference keeps its own state. `dtype` float64 computes every step
    in double precision (a witness, not the check)."""
    fw = framework(cfg)
    start = {k: v.detach().to(dtype) for k, v in weights.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    nets = Nets(spec(cfg), params, tf32=tf32)
    opt = Adam(params)
    H, W = scene["H"], scene["W"]
    dev = next(iter(weights.values())).device
    base_lr = float(cfg["training"]["lr"])
    n = int(cfg["data"]["N_rays"])
    losses, first_grads, own, rgbs, ties, adopted = [], None, [], [], 0, 0
    for k, (idx, state) in enumerate(steps):
        at = None if follow is None else follow[k]
        if k and at is not None:
            with torch.no_grad():
                for name, loose in round_off(first_grads).items():
                    params[name][loose] = at["params"][name][loose].to(dtype)
                    adopted += int(loose.sum())
        before = {name: p.detach().clone() for name, p in params.items()}
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        dr = {k: v if k in ("hs", "ws") else v.to(dtype)
              for k, v in draws(cfg, n, H, W, gen, dev).items()}
        sel = dr["hs"] * W + dr["ws"]
        o, d = pixel_rays(dr["ws"].to(dtype), dr["hs"].to(dtype), scene["c2w"][idx].to(dtype),
                          scene["intrinsics"][idx].to(dtype))
        total, rgb, kept, tied = fw.train_loss(
            nets, params, cfg, o, d, dr, scene["rgb"][idx][sel].to(dtype),
            scene["object_mask"][idx][sel], k, at)
        own.append({"params": before, **{key: v.detach() for key, v in kept.items()}})
        rgbs.append(rgb.detach())
        ties += tied
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names])))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(total.detach()))
        del rgb, total
        opt.step(grads, base_lr * lr_factor(cfg["training"], k))
    return {"losses": losses, "grads": first_grads, "samples": [f["samples"] for f in own],
            "rgb": rgbs, "follow": own, "ties": ties, "adopted": adopted,
            "change": {k: p.detach() - start[k] for k, p in params.items()}}


@torch.no_grad()
def render_rays(cfg: dict, weights: dict, rays_o, rays_d, block: int = 1024,
                tf32: bool = False, dtype=torch.float32) -> dict:
    """The novel-view render (no perturbation) of flat rays, in blocks:
    rgb, depth, normals [N, ...]; `dtype` as for `train_steps`."""
    fw = framework(cfg)
    weights = {k: v.to(dtype) for k, v in weights.items()}
    rays_o, rays_d = rays_o.to(dtype), rays_d.to(dtype)
    nets = Nets(spec(cfg), weights, tf32=tf32)
    outs = [fw.render_eval(nets, weights, cfg, rays_o[a:a + block], rays_d[a:a + block])
            for a in range(0, rays_o.shape[0], block)]
    return {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "depth", "normals")}
