"""Data-parallel training and rendering over the ray axis (port of
`neurecon_tpu/parallel/sharding.py`).

Model: parameters replicated on every rank; each step's ray batch split into
contiguous blocks of the ray axis, one a rank, as `NamedSharding(P('rays'))`
splits it over a JAX mesh; the gradients summed over the ranks. Where the
JAX package lets XLA insert the collectives, the port makes them itself:

* every random tensor of a step is drawn at the global batch's shape from a
  generator seeded alike on every rank, and each rank takes its block
  (`shard_rays`, `take_rows`), so a step on w ranks is the step on one;
* each rank's loss is its share of the loss over the whole batch
  (`RayShard`): a mean over equal blocks is the local mean over w, a mean
  over a mask divides by the mask's count summed over the ranks, a term
  every rank computes alike (VolSDF's sdf anchor) is divided by w. The
  shares' gradients sum to the global loss's gradient, and the shares to
  the global loss;
* `training.make_train_step` sums the gradients, the loss shares and the
  intermediates' statistics in one flat all-reduce (and their min / max in
  one more), so every rank takes the same Adam step and logs the global
  metrics. DDP's wrapper is not used: the frameworks' losses reach the
  model's networks directly, never through the wrapper's `forward`, whose
  call DDP's gradient hooks need;
* validation frames are split over the ranks by pixel
  (`make_sharded_render`) and gathered in ray order;
* the pipelined step (`training.make_pipelined_train_step`) draws the next
  step's rays and uniforms as the step draws its own and samples the rank's
  block on its side stream; the sum over the ranks stays on the current
  stream.

`make_mesh` and `replicate` have no counterpart: without a mesh, a process
group and the rank's block are all there is to place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class RayShard:
    """This rank's contiguous block of the ray axis, and the reductions that
    make a loss over the blocks the loss over the whole batch. Without a
    group: one rank, the whole batch, no collective."""

    def __init__(self, group=None):
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def block(self, n: int) -> tuple:
        """(start, length) of this rank's block of n rays."""
        if n % self.world:
            raise ValueError(f"{n} rays do not split into {self.world} equal blocks")
        m = n // self.world
        return self.rank * m, m

    def take(self, x, axis: int = 0):
        start, m = self.block(x.shape[axis])
        return x if self.world == 1 else x.narrow(axis, start, m)

    def all_sum(self, x):
        """The sum of `x` over the ranks (a new tensor)."""
        if not self.sharded:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def mean(self, x):
        """This rank's share of the mean of `x` over the whole batch."""
        m = torch.mean(x)
        return m if self.world == 1 else m / self.world

    def masked_mean(self, num, den):
        """This rank's share of sum(num) / (sum(den) + 1e-10) over the whole
        batch, `num` and `den` being this rank's sums."""
        return num / (self.all_sum(den.detach()) + 1e-10)

    def replicated(self, x):
        """This rank's share of a term that every rank computes alike."""
        return x if self.world == 1 else x / self.world

    def gather(self, x):
        """Every rank's block of `x` (ray axis 0), concatenated in rank order."""
        if not self.sharded:
            return x
        as_bool = x.dtype == torch.bool
        x = x.to(torch.uint8) if as_bool else x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        out = torch.cat(parts, 0)
        return out.bool() if as_bool else out


def shard_rays(ray_batch: dict, shard: RayShard, ray_axis: int = 1) -> dict:
    """This rank's block of every leaf of a ray batch (`training.
    sample_ray_batch`'s: the ray axis at dim 1)."""
    return {k: shard.take(v, ray_axis) for k, v in ray_batch.items()}


def take_rows(tree, shard: RayShard):
    """This rank's block of every tensor of a dict / tuple / list of flat
    per-ray draws (ray axis 0); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: take_rows(v, shard) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(take_rows(v, shard) for v in tree)
    return shard.take(tree, 0)


@torch.no_grad()
def broadcast_parameters(model, group) -> None:
    """Rank 0's parameters on every rank, written in place through the
    parameters themselves, so each one's version moves and the surface pack
    (`ops/surface_pack.py`) is made anew from the new values."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    offset = 0
    for p in params:
        n = p.numel()
        p.copy_(flat[offset:offset + n].view_as(p))
        offset += n


def make_sharded_train_step(ray_loss_fn, model, optimizer, scheduler, group=None):
    """step(ray_batch, generator, it, **draws) -> metrics, the counterpart of
    the JAX package's sharded step: `ray_batch` and the flat per-ray `draws`
    (seams such as NeuS's `d_all` and `u_out`, ray axis 0) are the global
    batch, the same on every rank; each rank runs `ray_loss_fn` on its block,
    and the step sums the gradients over `group` before Adam.
    `ray_loss_fn` must be the framework's ray loss made with
    `RayShard(group)` (`frameworks.get_ray_loss_fn(..., shard=...)`)."""
    from neurecon_tpu_torch.training import make_train_step

    shard = RayShard(group)

    def loss_fn(ray_batch, generator, it, **draws):
        return ray_loss_fn(shard_rays(ray_batch, shard), generator, it,
                           **take_rows(draws, shard))

    return make_train_step(loss_fn, model, optimizer, scheduler, group=group)


def make_sharded_render(render_fn, group=None):
    """A render fn (rays_o [n, 3], rays_d [n, 3], generator) -> (rgb, depth,
    extras) whose rays are split over the ranks of `group`: the rays are
    padded to a multiple of the world size (origin 0, direction (1, 1, 1),
    as the JAX package pads), each rank renders its block, and every output
    is gathered in ray order on every rank. A draw inside `render_fn` is
    made at the block's shape on each rank."""
    shard = RayShard(group)

    def render(rays_o, rays_d, generator=None):
        n = rays_o.shape[0]
        pad = (-n) % shard.world
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
            rays_d = torch.cat([rays_d, rays_d.new_ones(pad, 3)])
        rgb, depth, extras = render_fn(shard.take(rays_o), shard.take(rays_d), generator)
        out = {"rgb": rgb, "depth_volume": depth}
        out.update({k: v for k, v in extras.items() if k not in out})
        out = {k: shard.gather(v)[:n] for k, v in out.items()}
        return out["rgb"], out["depth_volume"], out

    render.world = shard.world
    return render
