"""Where the NeuS training step's time goes (port of
`neurecon_tpu/tools/bench_ablate.py`): the pieces of the step of
configs/neus.yaml at its 512 rays, each timed alone on the card, one JSON
line a row:

  full train step; train step with the direct_use upsampler; the loss
  forward (with the upsampler, no backward); the upsampler alone;
  grad(sdf + nablas + eikonal) at [N, 128] points; the sdf forward at
  [N, 128] (plain, and through the sdf-only kernel); the radiance forward
  with its nablas at [N, 127]; sample_pdf N x 64 -> 16; argsort + gather
  [N, 128].

Every row is the median of --K CUDA-event timings after a warm-up (the JAX
probe's K-step scan and scalar fetch), with the card's name and power
limit. The batch is the JAX probe's: N rays from (0, 0, -3) around +z,
target rgb 0.5, every ray in the mask.

  python -m neurecon_tpu_torch.tools.bench_ablate [--K 10] [--rays 512]
  python -m neurecon_tpu_torch.tools.bench_ablate --device cpu --rays 16 --width 64 --K 2
"""
from __future__ import annotations

import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "bench_ablate"


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0], K=10)
    ap.add_argument("--rays", type=int, default=pc.NEUS_YAML["data"]["N_rays"])
    ap.add_argument("--width", type=int, default=256, help="surface and radiance width")
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.models.base import make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.models.frameworks.neus import neus_upsample
    from neurecon_tpu_torch.ops.sampling import sample_pdf
    from neurecon_tpu_torch.training import make_train_step

    dev = get_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    N, K = a.rays, a.K
    cfg = pc.with_width(pc.NEUS_YAML, a.width)
    cfg["data"]["N_rays"] = N
    args, model, kw = pc.model_and_kwargs(cfg, dev, a.seed)
    card = pc.card(dev)
    rays_o, rays_d = pc.front_rays(N, dev, a.seed + 1)
    rb = {"rays_o": rays_o, "rays_d": rays_d,
          "target_rgb": torch.full((N, 3), 0.5, device=dev),
          "target_mask": torch.ones(N, dtype=torch.bool, device=dev)}
    gen = torch.Generator(dev).manual_seed(a.seed + 2)
    rows = []

    def row(name, fn, **extra):
        rows.append(pc.emit(PROBE, name, ms=pc.median_ms(fn, K, dev), K=K, rays=N,
                            width=a.width, device=dev.type, card=card, **extra))

    optimizer, scheduler = make_optimizer(args, model)
    for name, algo in (("full train step", "official_solution"),
                       ("train step (direct_use upsample)", "direct_use")):
        kw_a = dict(kw, upsample_algo=algo)
        loss = get_ray_loss_fn(args, model, kw_a)
        step = make_train_step(lambda b, g, it, loss=loss: loss(b, g, it), model, optimizer,
                               scheduler)
        row(name, lambda step=step: step(rb, gen, 0))
    loss = get_ray_loss_fn(args, model, kw)

    def loss_forward():
        with torch.no_grad():
            return loss(rb, gen, 0)[0]
    row("loss forward only (with upsampler)", loss_forward)

    t = torch.linspace(0, 1, 64, device=dev)
    d_coarse = (2.0 * (1 - t) + 4.0 * t).expand(N, 64).contiguous()

    def upsampler():
        with torch.no_grad():
            return neus_upsample(model, rays_o, rays_d, d_coarse, N_importance=64,
                                 N_upsample_iters=4, perturb=True, generator=gen)
    row("upsampler only", upsampler)

    g = torch.Generator().manual_seed(a.seed + 3)
    pts = (torch.randn(N, 128, 3, generator=g) * 0.5).to(dev)
    surface = model.implicit_surface

    def grad_block():
        model.zero_grad(set_to_none=True)
        sdf, nablas, _ = surface.forward_with_nablas(pts)
        l = ((torch.linalg.norm(nablas, dim=-1) - 1) ** 2).mean() + (sdf ** 2).mean()
        l.backward()
    row("grad(sdf+nablas+eikonal) [N,128]", grad_block, points=N * 128)
    model.zero_grad(set_to_none=True)

    def sdf_plain():
        with torch.no_grad():
            return surface.forward(pts)
    row("sdf forward [N,128] (plain)", sdf_plain, points=N * 128)
    row("sdf forward [N,128] (sdf-only kernel)", lambda: surface.forward_query(pts),
        points=N * 128)
    pts_m = pts[:, :127].contiguous()
    views = rays_d[:, None, :].expand(pts_m.shape).contiguous()

    def radiance():
        with torch.no_grad():
            return model.forward(pts_m, views)[0]
    row("radiance fwd (with nablas) [N,127]", radiance, points=N * 127)
    bins = torch.sort(torch.rand(N, 64, generator=g), -1).values.to(dev)
    w = torch.rand(N, 63, generator=g).to(dev)

    def spdf():
        u = torch.sort(torch.rand(N, 16, generator=gen, device=dev), -1).values
        return sample_pdf(bins, w, u)
    row("sample_pdf Nx64->16", spdf)
    d = torch.rand(N, 128, generator=g).to(dev)

    def sort_gather():
        idx = torch.argsort(d, dim=-1)
        return torch.gather(d, -1, idx)[:, 0]
    row("argsort+gather [N,128]", sort_gather)
    return rows


if __name__ == "__main__":
    main()
