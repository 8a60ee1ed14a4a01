"""Does culling the rays that miss the bounding sphere change the frame, and
what do it and the upsampler kernel save? (port of
`neurecon_tpu/tools/bench_render_cull.py`). Renders 360 x 400 frames of
configs/neus.yaml's NeuS (the port's geometric init at --seed) from
(0, 0, -3), focal 500, in chunks of 18,000 rays and micro-blocks of 2,250
(the JAX probe's workload), det, four rows:

  the baseline (kernels 2 and 1); `cull_sphere_r` 1.0 (render_view's
  --cull_miss); the plain upsampler in kernel 2's place; both.

Each row prints seconds a frame (the median of --K frames after a warm-up,
CUDA events around the whole frame, its host copies included) and its PSNR
against the baseline's rgb. The culling contract: a culled ray is black,
and a ray that misses the sphere renders nearly black anyway (its sigmoid
tail), so the PSNR stays high; the plain upsampler differs from the kernel
by fp32 sum orders only. `main` returns the rows; the exit code is 0 when
every row's PSNR is at least `PSNR_GATE`.

  python -m neurecon_tpu_torch.tools.bench_render_cull [--K 3]
  python -m neurecon_tpu_torch.tools.bench_render_cull --device cpu --H 24 --W 30 --width 64 --K 1
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "bench_render_cull"
PSNR_GATE = 30.0  # dB against the baseline, every row
RAYSCHUNK, MICROCHUNK = 18000, 2250  # the JAX probe's chunking


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0], K=3)
    ap.add_argument("--H", type=int, default=360)
    ap.add_argument("--W", type=int, default=400)
    ap.add_argument("--width", type=int, default=256, help="surface and radiance width")
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.ops.ray import get_rays
    from neurecon_tpu_torch.training import render_full_image

    dev = get_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    H, W = a.H, a.W
    cfg = pc.with_width(pc.NEUS_YAML, a.width)
    args, model, kw = pc.model_and_kwargs(cfg, dev, a.seed)
    card = pc.card(dev)
    kw = {k: v for k, v in kw.items() if k not in ("H", "W")}
    kw["perturb"] = False
    from neurecon_tpu_torch.models.frameworks.neus import make_volume_render_fn
    render = make_volume_render_fn(model, detailed_output=False, calc_normal=True, **kw)
    c2w = torch.eye(4)
    c2w[2, 3] = -3.0
    intr = torch.eye(4)
    intr[0, 0] = intr[1, 1] = 500.0 * min(H / 360.0, W / 400.0)
    intr[0, 2], intr[1, 2] = W / 2, H / 2
    rays_o, rays_d, _ = get_rays(c2w.to(dev), intr.to(dev), H, W)

    def frame(cull):
        return render_full_image(render, rays_o, rays_d, rayschunk=RAYSCHUNK,
                                 microchunk=MICROCHUNK,
                                 cull_sphere_r=1.0 if cull else None)["rgb"]

    rows, base = [], None
    for name, cull, plain in (("baseline", False, False), ("+ cull_miss", True, False),
                              ("+ plain upsampler", False, True),
                              ("+ cull_miss + plain upsampler", True, True)):
        with pc.plain_versions(*(["neus_upsample"] if plain else [])):
            out = {}

            def run():
                out["rgb"] = frame(cull)
            ms = pc.median_ms(run, a.K, dev)
        rgb = out["rgb"]
        if base is None:
            base = rgb
        mse = float(np.mean((rgb.astype(np.float64) - base) ** 2))
        psnr = float("inf") if mse == 0 else -10.0 * np.log10(mse)
        miss = None
        if cull:
            o, d = rays_o.cpu().numpy().astype(np.float64), rays_d.cpu().numpy()
            dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
            t = -np.sum(o * dn, -1)
            miss = float((np.linalg.norm(o + t[:, None] * dn, axis=-1) > 1.0).mean())
        rows.append(pc.emit(PROBE, name, s_per_frame=ms / 1e3, psnr_vs_baseline=psnr,
                            culled_share=miss, finite=bool(np.isfinite(rgb).all()), K=a.K,
                            H=H, W=W, width=a.width, device=dev.type, card=card))
    return rows


def passed(rows) -> bool:
    return all(r["finite"] and r["psnr_vs_baseline"] >= PSNR_GATE for r in rows)


if __name__ == "__main__":
    sys.exit(0 if passed(main()) else 1)
