"""The invariant behind micro-chunked renders (port of
`neurecon_tpu/tools/probe_lax_map.py`): the NeuS `official_solution`
upsampler over a chunk of rays gives the same depths when the chunk is
walked in micro-blocks through the port's `microchunk` path
(`training.render_full_image(microchunk=...)`) as in one whole-chunk call.

Two rows, each a chunk of 8,192 rays from (0, 0, -3) within +-0.35 rad of
+z, walked whole and in blocks of 2,048, det uniforms, 4 rounds of 16 on 64
coarse depths between the unit sphere's near and far:

  * "analytic sphere": the plain upsampler (`neus_upsample_plain`) on the
    sdf |x| - 0.7, no MLP (the JAX probe's reduction);
  * "flagship surface": the production upsampler (kernel 2 on a card, its
    plain version on the CPU) on configs/neus.yaml's surface with seeded
    noise on every weight.

Each row prints the share of depths that differ by more than 1e-3 and
whether the two walks are bit-equal. The exit code is 0 unless a walk
through the microchunk path differs from the whole-chunk call.

The JAX probe's third walk, the upsampler mapped over the blocks by
`jax.lax.map` (which a TPU compiles differently from straight-line code),
has no counterpart: the port has no `lax.map`; its micro-blocks are always
one call after another, which is what the JAX package's production
workaround (an unrolled loop) does.

  python -m neurecon_tpu_torch.tools.probe_lax_map
  python -m neurecon_tpu_torch.tools.probe_lax_map --device cpu --chunk 64 --micro 16 --width 64
"""
from __future__ import annotations

import copy
import sys

import numpy as np
import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "probe_lax_map"
N_COARSE, N_PER_IT, ITERS = 64, 16, 4


class AnalyticSphere(torch.nn.Module):
    """sdf |x| - r: what the plain upsampler queries (`forward`)."""

    def __init__(self, r=0.7):
        super().__init__()
        self.r = r

    def forward(self, x):
        return torch.linalg.norm(x, dim=-1) - self.r


def chunk_rays(n: int, dev, seed: int = 0):
    """n rays from (0, 0, -3) at angles uniform in +-0.35 rad (the JAX
    probe's chunk), unit length."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.35, 0.35, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1)
    o = np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32), d.shape)
    return (torch.tensor(np.ascontiguousarray(o), device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def upsample_fn(upsample):
    """render_fn(rays_o, rays_d, generator) -> (d_all, depth, {}) for
    render_full_image: near / far on the unit sphere, 64 coarse depths, and
    `upsample(rays_o, rays_d, d_coarse, u)` with det uniforms."""
    from neurecon_tpu_torch.ops.ray import near_far_from_sphere

    def render(rays_o, rays_d, generator=None):
        near, far = near_far_from_sphere(rays_o, rays_d, r=1.0)
        t = torch.linspace(0.0, 1.0, N_COARSE, device=rays_o.device)
        d_coarse = (near * (1 - t) + far * t).contiguous()
        u = torch.linspace(0.0, 1.0, N_PER_IT, device=rays_o.device).repeat(ITERS)
        u = u.expand(rays_o.shape[0], -1).contiguous()
        d_all = upsample(rays_o.contiguous(), rays_d.contiguous(), d_coarse, u)
        return d_all, d_all[:, 0], {}
    return render


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--micro", type=int, default=2048)
    ap.add_argument("--width", type=int, default=256, help="the flagship surface's width")
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.ops import fused_upsample
    from neurecon_tpu_torch.training import render_full_image

    dev = get_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = pc.card(dev)
    rays_o, rays_d = chunk_rays(a.chunk, dev, a.seed)
    cfg = pc.with_width(pc.NEUS_YAML, a.width)
    _, model, _ = pc.model_and_kwargs(cfg, dev, a.seed)
    model = copy.deepcopy(model)
    perturb_parameters(model, torch.Generator().manual_seed(a.seed + 1))
    sphere = AnalyticSphere()
    kw = dict(n_iters=ITERS, n_per_iter=N_PER_IT)
    cases = (("analytic sphere", lambda o, d, c, u: fused_upsample.neus_upsample_plain(
                  sphere, o, d, c, u, **kw)),
             ("flagship surface", lambda o, d, c, u: fused_upsample.fused_neus_upsample(
                  model.implicit_surface, o, d, c, u, **kw)))
    rows = []
    for name, up in cases:
        fn = upsample_fn(up)
        whole = render_full_image(fn, rays_o, rays_d, rayschunk=a.chunk)["rgb"]
        micro = render_full_image(fn, rays_o, rays_d, rayschunk=a.chunk,
                                  microchunk=a.micro)["rgb"]
        diff = np.abs(micro.astype(np.float64) - whole)
        rows.append(pc.emit(PROBE, name, micro_div_frac=float((diff > 1e-3).mean()),
                            max_abs_diff=float(diff.max()),
                            bit_equal=bool(np.array_equal(micro, whole)),
                            chunk=a.chunk, micro=a.micro, device=dev.type, card=card))
    return rows


def passed(rows) -> bool:
    return all(r["bit_equal"] for r in rows)


if __name__ == "__main__":
    sys.exit(0 if passed(main()) else 1)
