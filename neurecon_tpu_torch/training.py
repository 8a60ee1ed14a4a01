"""Training-step machinery (port of `neurecon_tpu/training.py`).

One eager step: zero the grads, loss, backward, (over several ranks) one sum
of the gradients and metrics over the process group, Adam step, scheduler
step. Metrics stay on the device (the loop fetches them every `i_log`
steps), so no step waits on the host. `make_train_step` takes any loss;
`make_pipelined_train_step`, train.py's step, takes a framework's pipeline
functions and, given the next step's batch (`training.overlap_sampler`),
samples that step's depths against the parameters before this step's
update, on a second CUDA stream while this step's backward runs. `render_full_image` is the chunked
render of the validation images and the eval tools, split over the ranks by
pixel when given a process group, and in `microchunk`-ray blocks inside each
chunk when asked.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from neurecon_tpu_torch.bridge import unwrap
from neurecon_tpu_torch.parallel.sharding import (RayShard, broadcast_parameters,
                                                  make_sharded_render, shard_rays,
                                                  take_rows)


def sample_ray_batch(generator, batch, H: int, W: int, N_rays: int):
    """N_rays random pixels of an image batch, drawn on its device.

    batch: {'c2w' [B,4,4], 'intrinsics' [B,4,4], 'rgb' [B,H*W,3], optional
    'object_mask' / 'mask_ignore' [B,H*W]}. Returns a ray batch whose arrays
    all have the ray axis at dim 1."""
    from neurecon_tpu_torch.ops import get_rays

    rays_o, rays_d, select_inds = get_rays(batch["c2w"], batch["intrinsics"], H, W,
                                           N_rays=N_rays, generator=generator)
    rb = {"rays_o": rays_o, "rays_d": rays_d,
          "target_rgb": torch.gather(
              batch["rgb"], -2, select_inds[..., None].expand(*select_inds.shape, 3))}
    for k, out in (("object_mask", "target_mask"), ("mask_ignore", "mask_ignore")):
        if k in batch:
            rb[out] = torch.gather(batch[k], -1, select_inds)
    return rb


def make_draw_step(H: int, W: int, N_rays: int, draw_uniforms: Callable,
                   shard: Optional[RayShard] = None) -> Callable:
    """draw_step(batch, generator) -> (rb, draws): N_rays pixels of one image
    batch (`sample_ray_batch`), then the step's uniforms
    `draw_uniforms(N_rays, generator, device)` (a dict, tuple or list of flat
    per-ray tensors), each drawn at the whole batch's shape, and this rank's
    block of each (`shard`; the whole of each without one)."""
    shard = shard or RayShard()

    def draw_step(batch, generator):
        rb = sample_ray_batch(generator, batch, H, W, N_rays)
        draws = draw_uniforms(N_rays, generator, rb["rays_o"].device)
        return shard_rays(rb, shard), take_rows(draws, shard)

    return draw_step


def grad_norms_by_module(model) -> Dict[str, torch.Tensor]:
    """Global grad norm per top-level entry of the JAX pytree (`ln_s` or
    `ln_beta`, `implicit_surface`, `radiance_net`), as a device tensor each."""
    sq = {}
    for name, p in unwrap(model).named_parameters():
        if p.grad is not None:
            top = name.split(".")[0]
            sq[top] = sq.get(top, 0.0) + torch.sum(p.grad.float() ** 2)
    return {k: torch.sqrt(v) for k, v in sq.items()}


# intermediates whose mean/min/max/norm are logged (as the JAX package does)
_EXTRAS_STAT_KEYS = ("radiance", "alpha", "implicit_surface",
                     "implicit_nablas_norm", "sigma_out", "radiance_out")


def _stat_inputs(extras):
    """(name, detached float tensor) of each logged intermediate present."""
    if not isinstance(extras, dict):
        return []
    return [(n, extras[n].detach().float()) for n in _EXTRAS_STAT_KEYS
            if extras.get(n) is not None]


def extras_stats(extras) -> Dict[str, torch.Tensor]:
    """mean/min/max/norm of the render intermediates, on the device."""
    out = {}
    for n, v in _stat_inputs(extras):
        out[f"{n}.mean"] = v.mean()
        out[f"{n}.min"] = v.min()
        out[f"{n}.max"] = v.max()
        out[f"{n}.norm"] = torch.sqrt(torch.sum(v * v))
    return out


def _reduce_step(shard: RayShard, params, losses, extras):
    """Over the ranks: sum the gradients (in place) and the loss shares in one
    all-reduce with each intermediate's mean share and sum of squares, then
    take the intermediates' max and min in one more. Returns the global
    (losses, extras_stats)."""
    grads = [p.grad for p in params if p.grad is not None]
    keys = list(losses)
    inter = _stat_inputs(extras)
    sums = [losses[k].detach().float().reshape(()) for k in keys]
    sums += [shard.mean(v) for _, v in inter] + [torch.sum(v * v) for _, v in inter]
    flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(sums)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=shard.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    tail = flat[offset:]
    out_losses = {k: tail[i] for i, k in enumerate(keys)}
    stats = {}
    if inter:
        n = len(inter)
        means, sumsq = tail[len(keys):len(keys) + n], tail[len(keys) + n:]
        ext = torch.stack([v.max() for _, v in inter] + [-v.min() for _, v in inter])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=shard.group)
        for i, (name, _) in enumerate(inter):
            stats[f"{name}.mean"] = means[i]
            stats[f"{name}.min"] = -ext[n + i]
            stats[f"{name}.max"] = ext[i]
            stats[f"{name}.norm"] = torch.sqrt(sumsq[i])
    return out_losses, stats


def _update(model, optimizer, scheduler, group):
    """The part of a step after the loss: finish(total, losses, extras,
    before_adam=None) -> metrics runs the backward, (over several ranks)
    the sum of the gradients and metrics, `before_adam()`, then Adam and
    the schedule. With a group, the rank-0 parameters are broadcast once
    here."""
    shard = RayShard(group)
    params = [p for p in model.parameters() if p.requires_grad]
    if shard.sharded:
        broadcast_parameters(model, group)

    def finish(total, losses, extras, before_adam=None):
        total.backward()
        if shard.sharded:
            losses, stats = _reduce_step(shard, params, losses, extras)
        else:
            losses, stats = {k: v.detach() for k, v in losses.items()}, extras_stats(extras)
        metrics = {"losses": losses, "grad_norms": grad_norms_by_module(model),
                   "extras_stats": stats}
        if before_adam is not None:
            before_adam()
        optimizer.step()
        scheduler.step()
        if isinstance(extras, dict) and "scalars" in extras:
            metrics["scalars"] = extras["scalars"]
        return metrics

    return finish


def make_train_step(loss_fn: Callable, model, optimizer, scheduler, group=None) -> Callable:
    """loss_fn(batch, generator, it, **kw) -> (total, (losses, extras)).

    Returns step(batch, generator, it, **kw) -> metrics: the step's losses,
    per-module grad norms, extras['scalars'] and the intermediates' stats,
    all as device tensors (nothing is fetched here).

    With a process group (`group`), `loss_fn` returns this rank's share of
    the loss over the whole batch (a framework loss made with
    `RayShard(group)`): the rank-0 parameters are broadcast once here, and
    every step sums the gradients over the ranks before Adam, so the metrics
    are those of the whole batch on every rank."""
    finish = _update(model, optimizer, scheduler, group)

    def step(batch, generator, it, **kw):
        optimizer.zero_grad(set_to_none=True)
        total, (losses, extras) = loss_fn(batch, generator, it, **kw)
        return finish(total, losses, extras)

    return step


def _new_stream(dev):
    """The pipelined step's side stream on `dev`'s card."""
    return torch.cuda.Stream(dev)


def make_pipelined_train_step(pipeline_fns: dict, model, optimizer, scheduler,
                              group=None) -> Callable:
    """train.py's step, and with `next_batch` the software-pipelined step of
    `training.overlap_sampler` (the JAX package's
    `make_sharded_train_block(pipeline_fns=...)`).

    pipeline_fns: a framework's `make_pipeline_fns` (made with
    `RayShard(group)` under a group): draw_step, depth_sample,
    loss_with_samples. Returns step(batch, generator, it, next_batch=None)
    -> metrics, as `make_train_step`'s step.

    A call draws its rays and uniforms and samples its depths afresh, unless
    the call before it was given this `batch` as its `next_batch`: that call
    drew them (after its own, so the draws keep the standard step's order)
    and sampled the depths right after its forward, against the parameters
    it started from, before its update. The rendered values and the
    gradients always use the current parameters: only where the samples lie
    is one step stale. So a group of K steps called with `next_batch` from
    its first to its last but one is the JAX package's K-step pipelined
    block; a call without `next_batch` after a call without one is the
    standard step; with lr 0 the two steps are equal.

    On a card the next step's sampler runs on a second CUDA stream, under
    no_grad, while this step's backward (and, over several ranks, its
    all-reduce) runs on the current stream. The side stream first waits on
    the current one (the ray batch, the uniforms and the surface pack that
    this step's forward made), and the current stream waits on the side
    stream's event before Adam writes the parameters the sampler reads. The
    sampler's workspaces are allocated under the side stream; its outputs,
    read on the current stream, are marked with `record_stream`. What the
    sampler reads from the current stream (the ray batch, the uniforms, the
    parameters and the surface pack, which the next forward replaces) stays
    alive until the current stream has waited on the event. On the CPU the
    same code runs in order."""
    finish = _update(model, optimizer, scheduler, group)
    draw_step = pipeline_fns["draw_step"]
    depth_sample = pipeline_fns["depth_sample"]
    loss_with_samples = pipeline_fns["loss_with_samples"]
    side = {}  # the side stream, made on the first call on a card
    ahead = {}  # the next step's batch, rays, uniforms and depths

    def sample_ahead(batch, generator):
        """Draw `batch`'s rays and uniforms, and enqueue their depths' sampler
        (on the side stream on a card). Returns (held, wait): what the next
        call takes, and what the current stream must run before Adam (None
        on the CPU)."""
        rb, draws = draw_step(batch, generator)
        dev = rb["rays_o"].device
        if dev.type != "cuda":
            with torch.no_grad():
                return (batch, rb, draws, depth_sample(rb, draws)), None
        main = torch.cuda.current_stream(dev)
        stream = side.get(dev)
        if stream is None:
            stream = side[dev] = _new_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream), torch.no_grad():
            samples = depth_sample(rb, draws)
            done = torch.cuda.Event()
            done.record(stream)
        for t in (samples if isinstance(samples, (tuple, list)) else (samples,)):
            t.record_stream(main)
        return (batch, rb, draws, samples), lambda: main.wait_event(done)

    def step(batch, generator, it, next_batch=None):
        held = ahead.pop("next", None)
        if held is not None and held[0] is not batch:
            raise ValueError("the pipelined step was given another batch than the "
                             "next_batch of its call before")
        if held is None:
            rb, draws = draw_step(batch, generator)
            with torch.no_grad():
                samples = depth_sample(rb, draws)
        else:
            _, rb, draws, samples = held
        optimizer.zero_grad(set_to_none=True)
        total, (losses, extras) = loss_with_samples(rb, samples, draws, generator, it)
        held, wait = sample_ahead(next_batch, generator) if next_batch is not None else (None, None)
        metrics = finish(total, losses, extras, wait)
        if held is not None:
            ahead["next"] = held
        return metrics

    return step


def fast_forward_schedule(optimizer, scheduler, step: int) -> None:
    """Resume the lr schedule at `step` for a checkpoint that brings
    parameters but no optimizer state, as the JAX package sets every optax
    `count` to `step`: the scheduler's count and each group's lr, and Adam's
    per-parameter step (its bias correction) with fresh zero moments."""
    scheduler.last_epoch = step
    for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(step)
    scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


def render_full_image(render_fn, rays_o, rays_d, *, rayschunk: int = 4096,
                      generator: Optional[torch.Generator] = None,
                      cull_sphere_r: Optional[float] = None,
                      miss_rgb: float = 0.0, microchunk: Optional[int] = None,
                      group=None):
    """Render all rays of an image in chunks of `rayschunk` rays.

    render_fn: (rays_o [n,3], rays_d [n,3], generator) -> (rgb, depth,
    extras). Returns a dict of host numpy arrays, one row per ray.

    `microchunk`: each chunk is rendered in blocks of that many rays, one
    after the other (peak memory set by the block, as the JAX package's
    `lax.map` inside a dispatch); `rayschunk` must be a multiple of it, and
    each block draws its own uniforms from `generator`. None, 0 or a block
    no smaller than the chunk: one block a chunk.

    `group` (a process group): every rank calls this with the same rays, and
    each block is split over the ranks by pixel (`parallel.
    make_sharded_render`); `rayschunk` and `microchunk` are first rounded up
    to multiples of the world size, as the JAX package rounds them to its
    mesh. Every rank returns the whole image.

    `cull_sphere_r`: only rays that pass within that radius of the origin go
    through the network; the others get `miss_rgb` and zeros (their depth
    and extras are visualization-only).
    """
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    N = rays_o.shape[0]

    if cull_sphere_r:
        o_np = rays_o.detach().cpu().numpy().astype(np.float64)
        d_np = rays_d.detach().cpu().numpy().astype(np.float64)
        dn = d_np / np.linalg.norm(d_np, axis=-1, keepdims=True)
        t_mid = -np.sum(o_np * dn, axis=-1)
        closest = o_np + t_mid[:, None] * dn
        hit = ((np.linalg.norm(closest, axis=-1) <= cull_sphere_r)
               & (t_mid + cull_sphere_r > 0))
        if not hit.all():
            hit_idx = np.nonzero(hit)[0]
            # zero hits: run one ray through to learn the output structure
            probe_idx = hit_idx if hit_idx.size else np.asarray([0])
            idx_t = torch.as_tensor(probe_idx, device=rays_o.device)
            sub = render_full_image(render_fn, rays_o[idx_t], rays_d[idx_t],
                                    rayschunk=rayschunk, generator=generator,
                                    microchunk=microchunk, group=group)
            out = {}
            for k, v in sub.items():
                full = np.zeros((N,) + v.shape[1:], v.dtype)
                if k == "rgb":
                    full[...] = miss_rgb
                if hit_idx.size:
                    full[hit_idx] = v
                out[k] = full
            return out

    if group is not None:
        w = RayShard(group).world
        rayschunk = -(-rayschunk // w) * w
        if microchunk and microchunk > 0:
            microchunk = -(-int(microchunk) // w) * w
        render_fn = make_sharded_render(render_fn, group)
    if not microchunk or microchunk <= 0 or microchunk >= rayschunk:
        microchunk = rayschunk
    if rayschunk % microchunk:
        raise ValueError(f"rayschunk {rayschunk} must be a multiple of microchunk {microchunk}")

    outs = []
    with torch.no_grad():
        for i in range(0, N, microchunk):
            rgb, depth, extras = render_fn(rays_o[i:i + microchunk],
                                           rays_d[i:i + microchunk], generator)
            chunk = {"rgb": rgb, "depth_volume": depth}
            chunk.update({k: v for k, v in extras.items()
                          if k not in ("rgb", "depth_volume")})
            outs.append({k: v.cpu().numpy() for k, v in chunk.items()})
    return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
