"""Where the VolSDF training step's time goes (port of
`neurecon_tpu/tools/bench_volsdf_ablate.py`), at
configs/long_volsdf_sphere.yaml (512 rays, 64 x 2 depths a round, 4
rounds), one JSON line a row:

  the full train step through the sampler's kernels and with the plain
  sampler in their place; the fine sampler alone, both ways; the loss
  forward with the sampler; the loss forward and the train step on fixed
  fine samples (`fine_override`, the sampler cut out); the 10-step beta
  bisection alone over [N, 768] depths.

Every row is the median of --K CUDA-event timings after a warm-up, with
the card's name and power limit. The batch is the JAX probe's: N rays from
(0, 0, -3) around +z, target rgb 0.5.

  python -m neurecon_tpu_torch.tools.bench_volsdf_ablate [--K 10]
  python -m neurecon_tpu_torch.tools.bench_volsdf_ablate --device cpu --rays 8 --width 64 \\
      --samples 16 --K 2
"""
from __future__ import annotations

import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "bench_volsdf_ablate"
BISECT_S = 768  # depths a ray in the bisection row (the JAX probe's)


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0], K=10)
    ap.add_argument("--rays", type=int, default=pc.LONG_VOLSDF_SPHERE["data"]["N_rays"])
    ap.add_argument("--width", type=int, default=256, help="surface and radiance width")
    ap.add_argument("--samples", type=int,
                    default=pc.LONG_VOLSDF_SPHERE["model"]["N_samples"],
                    help="N_samples and N_importance")
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.models.base import make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn, volsdf
    from neurecon_tpu_torch.ops.fused_fine_sample import error_bound
    from neurecon_tpu_torch.training import make_train_step

    dev = get_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    N, K = a.rays, a.K
    cfg = pc.with_width(pc.LONG_VOLSDF_SPHERE, a.width)
    cfg["data"]["N_rays"] = N
    cfg["model"]["N_samples"] = cfg["model"]["N_importance"] = a.samples
    args, model, kw = pc.model_and_kwargs(cfg, dev, a.seed)
    card = pc.card(dev)
    rays_o, rays_d = pc.front_rays(N, dev, a.seed + 1)
    rb = {"rays_o": rays_o, "rays_d": rays_d,
          "target_rgb": torch.full((N, 3), 0.5, device=dev)}
    gen = torch.Generator(dev).manual_seed(a.seed + 2)
    rows = []

    def row(name, fn, **extra):
        rows.append(pc.emit(PROBE, name, ms=pc.median_ms(fn, K, dev), K=K, rays=N,
                            width=a.width, device=dev.type, card=card, **extra))

    optimizer, scheduler = make_optimizer(args, model)
    loss = get_ray_loss_fn(args, model, kw)
    step = make_train_step(lambda b, g, it: loss(b, g, it), model, optimizer, scheduler)
    row("VolSDF full train step", lambda: step(rb, gen, 0))
    with pc.plain_versions("fine_sample"):
        row("VolSDF full train step (plain sampler)", lambda: step(rb, gen, 0))
    sample_kw = {k: v for k, v in kw.items() if k not in ("H", "W", "rayschunk")}

    def sampler():
        with torch.no_grad():
            return volsdf.compute_ray_samples(model, rays_o, rays_d, generator=gen, **sample_kw)
    row("fine_sample alone", sampler)
    with pc.plain_versions("fine_sample"):
        row("fine_sample alone (plain sampler)", sampler)

    def forward():
        with torch.no_grad():
            return loss(rb, gen, 0)[0]
    row("loss forward (incl sampler)", forward)
    fine0 = sampler()

    def forward_override():
        with torch.no_grad():
            return loss(rb, gen, 0, fine_override=fine0)[0]
    row("loss forward (fine_override, no sampler)", forward_override)
    step_o = make_train_step(lambda b, g, it: loss(b, g, it, fine_override=fine0), model,
                             optimizer, scheduler)
    row("train step (fine_override, no sampler)", lambda: step_o(rb, gen, 0))

    g = torch.Generator().manual_seed(a.seed + 3)
    d_vals = torch.sort(torch.rand(N, BISECT_S, generator=g) * 5.0 + 0.5, -1).values.to(dev)
    sdf = (torch.randn(N, BISECT_S, generator=g) * 0.3).to(dev)
    beta0 = torch.full((N, 1), 0.5, device=dev)

    def bisect():
        bl, br = torch.full_like(beta0, 1e-3), beta0
        for _ in range(10):
            bt = 0.5 * (bl + br)
            bm = error_bound(d_vals, sdf, 1.0 / bt, bt).max(-1, keepdim=True).values
            good = bm <= 0.1
            br = torch.where(good, bt, br)
            bl = torch.where(good, bl, bt)
        return br
    row(f"10-step beta bisection alone [N,{BISECT_S}]", bisect)
    return rows


if __name__ == "__main__":
    main()
