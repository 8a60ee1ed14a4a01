"""The NeuS upsampler kernel (kernel 2, `csrc/neus_upsample.cu`) against its
plain version on the card (port of `neurecon_tpu/tools/bench_fused_upsample.py`),
at configs/neus.yaml's widths and 512 rays from (0, 0, -3), coarse depths
2-4, 4 rounds of 16, one JSON line a row:

  1. agreement, det and perturb uniforms: kernel 2's d_all against the
     plain version's on the same rays and uniforms (max|diff|, the share
     beyond 1e-4 and 1e-3 of the span, NaNs, sorted), on the weights with
     seeded noise (`perturb_parameters`), held to chip_smoke.py phase 3's
     gate: at most 0.1% of the entries beyond 1e-3 (far - near) once, in
     det mode, the u = 1.0 ties in the last coarse section are set aside
     (up to one entry a round a ray);
  2. the upsampler alone, kernel and plain version;
  3. the kernel at each block shape (`fused_upsample.block_shape`: 8-ray
     blocks on 128-point tiles, 4-ray blocks on 64-point tiles), which stand
     in for the JAX probe's TPU tile sweep and its lax.map row;
  4. the full training step with kernel 2 and with the plain upsampler.

Times are medians of --K CUDA-event timings after a warm-up, with the card's
name and power limit. `main` returns the rows; the exit code is 0 when the
agreement rows pass.

  python -m neurecon_tpu_torch.tools.bench_fused_upsample [--K 30]
  python -m neurecon_tpu_torch.tools.bench_fused_upsample --device cpu --rays 8 --width 64 --K 2
"""
from __future__ import annotations

import copy
import sys
from unittest import mock

import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "bench_fused_upsample"
N_ITERS, N_PER_ITER = 4, 16
SHARE_GATE = 1e-3  # entries beyond 1e-3 of the span, after the det u = 1.0 ties


def agreement(got, ref, d_coarse, span, det):
    """The agreement fields of two d_all [N, S] (see the module note)."""
    diff = (got - ref).abs()
    off = diff > 1e-3 * span
    tie = off & (got >= d_coarse[:, -2:-1]) & (ref >= d_coarse[:, -2:-1])
    exempt = tie & (tie.sum(1, keepdim=True) <= N_ITERS) if det else torch.zeros_like(off)
    return {"max_abs_diff": float(diff.max()),
            "share_beyond_1e-4_span": float((diff > 1e-4 * span).float().mean()),
            "share_beyond_1e-3_span": float(off.float().mean()),
            "tie_entries_exempt": int(exempt.sum()),
            "share_beyond_1e-3_span_rest": float((off & ~exempt).float().mean()),
            "nan": int(torch.isnan(got).sum()),
            "sorted": bool((got[:, 1:] >= got[:, :-1] - 1e-6).all())}


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0], K=30)
    ap.add_argument("--rays", type=int, default=pc.NEUS_YAML["data"]["N_rays"])
    ap.add_argument("--width", type=int, default=256, help="surface and radiance width")
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.models.base import make_optimizer, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.models.frameworks.neus import _uniforms
    from neurecon_tpu_torch.ops import fused_upsample
    from neurecon_tpu_torch.training import make_train_step

    dev = get_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    N, K = a.rays, a.K
    cfg = pc.with_width(pc.NEUS_YAML, a.width)
    cfg["data"]["N_rays"] = N
    args, model, kw = pc.model_and_kwargs(cfg, dev, a.seed)
    card = pc.card(dev)
    surface = model.implicit_surface
    rays_o, rays_d = pc.front_rays(N, dev, a.seed + 1)
    near, far = 2.0, 4.0
    t = torch.linspace(0, 1, 64, device=dev)
    d_coarse = (near * (1 - t) + far * t).expand(N, 64).contiguous()
    gen = torch.Generator(dev).manual_seed(a.seed + 2)
    common = dict(K=K, rays=N, width=a.width, device=dev.type, card=card)
    rows = []

    def kernel(u):
        return fused_upsample.fused_neus_upsample(surface, rays_o, rays_d, d_coarse, u,
                                                  n_iters=N_ITERS, n_per_iter=N_PER_ITER)

    def plain(u):
        return fused_upsample.neus_upsample_plain(surface, rays_o, rays_d, d_coarse, u,
                                                  n_iters=N_ITERS, n_per_iter=N_PER_ITER)

    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(a.seed + 3))
    for det in (True, False):
        u = _uniforms(N, N_ITERS, N_PER_ITER, not det, gen, dev)
        s = checked.implicit_surface
        got = fused_upsample.fused_neus_upsample(s, rays_o, rays_d, d_coarse, u,
                                                 n_iters=N_ITERS, n_per_iter=N_PER_ITER)
        ref = fused_upsample.neus_upsample_plain(s, rays_o, rays_d, d_coarse, u,
                                                 n_iters=N_ITERS, n_per_iter=N_PER_ITER)
        fields = agreement(got, ref, d_coarse, far - near, det)
        fields["ok"] = (fields["share_beyond_1e-3_span_rest"] <= SHARE_GATE
                        and fields["nan"] == 0 and fields["sorted"])
        rows.append(pc.emit(PROBE, f"agreement {'det' if det else 'perturb'}", **fields,
                            **common))
    u = _uniforms(N, N_ITERS, N_PER_ITER, True, gen, dev)
    with torch.no_grad():
        rows.append(pc.emit(PROBE, "upsampler, kernel 2",
                            ms=pc.median_ms(lambda: kernel(u), K, dev), **common))
        rows.append(pc.emit(PROBE, "upsampler, plain version",
                            ms=pc.median_ms(lambda: plain(u), K, dev), **common))
        for P, R in ((128, 8), (64, 4)):
            with mock.patch.object(fused_upsample, "block_shape", lambda n, sms, *_, s=(P, R): s):
                ms = pc.median_ms(lambda: kernel(u), K, dev)
            rows.append(pc.emit(PROBE, f"kernel 2 at block shape {P} points x {R} rays",
                                ms=ms, tile_points=P, block_rays=R,
                                default=dev.type == "cuda" and fused_upsample.block_shape(
                                    N, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count) == (P, R), **common))
    rb = {"rays_o": rays_o, "rays_d": rays_d,
          "target_rgb": torch.full((N, 3), 0.5, device=dev),
          "target_mask": torch.ones(N, dtype=torch.bool, device=dev)}
    optimizer, scheduler = make_optimizer(args, model)
    loss = get_ray_loss_fn(args, model, kw)
    step = make_train_step(lambda b, g, it: loss(b, g, it), model, optimizer, scheduler)
    rows.append(pc.emit(PROBE, "train step, kernel 2",
                        ms=pc.median_ms(lambda: step(rb, gen, 0), max(1, K // 3), dev),
                        **dict(common, K=max(1, K // 3))))
    with pc.plain_versions("neus_upsample"):
        rows.append(pc.emit(PROBE, "train step, plain upsampler",
                            ms=pc.median_ms(lambda: step(rb, gen, 0), max(1, K // 3), dev),
                            **dict(common, K=max(1, K // 3))))
    return rows


def passed(rows) -> bool:
    return all(r["ok"] for r in rows if r["row"].startswith("agreement"))


if __name__ == "__main__":
    sys.exit(0 if passed(main()) else 1)
